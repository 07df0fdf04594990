"""The port's host-env data parallelism (``parallel/host_dp.py``, the bridged
host collection of ``algorithms/ppo.py`` and ``algorithms/distillation.py``)
against the contract of ``tests/test_host_dp.py``: two ranks, each stepping
its own shard of a deterministic host env, train as one process stepping
the whole env.

Two Gloo ranks on the CPU, spawned once for the module
(``tests/torch_port_dist_worker.py``), each step 8 envs of
``ShardableHostEnv`` (the port's copy of ``tests/host_env_double.py``);
PPO (feedforward and GRU, through ``OnPolicyRunner``, which builds the
bridge) and the GRU student's distillation (algorithm-level) equal the one
process over 16 envs: the losses and the noise std at rtol 1e-5 / atol 1e-6,
the parameters and normalizer moments at rtol 3e-4 / atol 3e-5 (the
one-update bar; the ranks sum in another order). The episode statistics stay
each rank's (rank 0 logs, ``host_dp.py:25-28``): the two ranks' sums make the
one process's.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from rsl_rl_tpu_torch.parallel import HostShardingBridge, converters, make_mesh
from rsl_rl_tpu_torch.parallel.mesh import Mesh
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from tests.torch_port_dist_worker import ppo_cfg, run_scenario, spawn
from tests.torch_port_host_env_double import ShardableHostEnv

HOST = ("host_ff", "host_gru", "host_distill")
#: a host env asked to fuse on the CPU mesh: its runner trains split
FUSED_HOST = "host_ff_fused"
GLOBAL_BAR = {"rtol": 1e-5, "atol": 1e-6}
STATE_BAR = {"rtol": 3e-4, "atol": 3e-5}
EPISODE_KEYS = ("ep_reward_sum", "ep_length_sum", "ep_ereward_sum", "ep_ireward_sum", "ep_count")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = spawn(str(tmp_path_factory.mktemp("host_dp")), [*HOST, FUSED_HOST], world=2, timeout=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            one = {name: run_scenario(name, 1, "") for name in HOST}
    finally:
        torch.set_num_threads(threads)
    return ranks, one


def _close(got, want, bar, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), err_msg=what, **bar)


@pytest.mark.parametrize("name", HOST)
def test_bridged_ranks_equal_one_process(runs, name):
    ranks, want = runs[0][name], runs[1][name]
    for i, w in enumerate(want["losses"]):
        for k, v in w.items():
            if k in EPISODE_KEYS or k.startswith("extras/"):
                continue
            for r in range(2):
                _close(ranks[r]["losses"][i][k], v, GLOBAL_BAR, f"{name} rank {r} iteration {i} {k}")
        for k in ("ep_count", "ep_length_sum", "ep_reward_sum"):
            _close(ranks[0]["losses"][i][k] + ranks[1]["losses"][i][k], w[k], GLOBAL_BAR,
                   f"{name} iteration {i}: the ranks' {k} sum to the one process's")
    for k, w in want["state"].items():
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), f"{name}: the ranks' {k} differ"
        _close(ranks[0]["state"][k], w, STATE_BAR, f"{name}: {k}")


def test_fused_host_runner_on_the_mesh_trains_split(runs):
    """``fuse_iteration`` with a host env on the CPU mesh: the host env steps
    on the host, so the runner trains split (on the card it raises
    ``ValueError``, ``runners/training_loop.py``), equal to the split run
    bit for bit on each rank."""
    for r in range(2):
        got, want = runs[0][FUSED_HOST][r], runs[0]["host_ff"][r]
        assert got["fuse_iteration"] is False and got["iteration_graph"] is None
        assert got["losses"] == want["losses"]
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), f"rank {r} {k}"


def test_shard_composability_of_double():
    """Two shards stepped side by side equal the whole env."""
    full = ShardableHostEnv(num_envs=8)
    s0 = ShardableHostEnv(num_envs=4, start_id=0)
    s1 = ShardableHostEnv(num_envs=4, start_id=4)
    of, o0, o1 = full.reset(), s0.reset(), s1.reset()
    np.testing.assert_array_equal(of["policy"], np.concatenate([o0["policy"], o1["policy"]]))
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = rng.uniform(-1, 1, size=(8, 2)).astype(np.float32)
        of, rf, df, _ = full.step(a)
        o0, r0, d0, _ = s0.step(a[:4])
        o1, r1, d1, _ = s1.step(a[4:])
        np.testing.assert_array_equal(of["policy"], np.concatenate([o0["policy"], o1["policy"]]))
        np.testing.assert_array_equal(rf, np.concatenate([r0, r1]))
        np.testing.assert_array_equal(df, np.concatenate([d0, d1]))


def test_bridge_converts_this_ranks_shard():
    """The bridge's "global" tensor is this rank's shard on its device: the
    conversions round-trip, the global batch counts every data rank, a
    time-major window of mixed env counts is refused."""
    bridge = HostShardingBridge(Mesh(("data",), 4, 1, 2))
    assert bridge.global_batch(8) == 32 and bridge.num_processes == 4
    tree = {"policy": np.arange(6, dtype=np.float32).reshape(3, 2), "done": np.array([True, False, True])}
    dev = bridge.to_global(tree)
    assert isinstance(dev["policy"], torch.Tensor) and dev["done"].dtype == torch.bool
    back = bridge.to_local_np(dev)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    window = {"obs": {"policy": torch.zeros(5, 3, 2)}, "dones": torch.zeros(5, 3)}
    assert bridge.constrain_time_major(window) is window
    with pytest.raises(ValueError, match="mixes env counts"):
        bridge.constrain_time_major({**window, "values": torch.zeros(5, 4)})
    to_device, to_host = converters(bridge)
    assert to_device == bridge.to_global and to_host == bridge.to_local_np
    to_device, to_host = converters(None)
    np.testing.assert_array_equal(to_host(to_device(tree))["policy"], tree["policy"])
    # one rank with no process group: replicate is the identity
    one = HostShardingBridge(make_mesh())
    np.testing.assert_array_equal(one.replicate(tree)["policy"].numpy(), tree["policy"])


def test_single_process_host_runner_has_no_bridge():
    """Without a process group a host env trains unbridged, as before."""
    with contextlib.redirect_stdout(io.StringIO()):
        runner = OnPolicyRunner(ShardableHostEnv(8), ppo_cfg(), device="cpu")
        runner.learn(1)
    assert runner._host_bridge is None and runner.alg.mesh is None and runner.num_global_envs == 8
