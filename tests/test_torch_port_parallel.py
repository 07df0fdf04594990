"""The port's data parallelism on ``torch.distributed`` (``rsl_rl_tpu_torch/parallel``,
the mesh path of ``algorithms/ppo.py`` and the runners) against the JAX
package's contract that the topology does not change the math
(``tests/test_distributed.py``).

Two Gloo ranks on the CPU, spawned once for the module
(``tests/torch_port_dist_worker.py``, a file rendezvous), run PPO on a
device env of 16 global envs, 8 a rank, and must equal the one-process run
of the same global configuration: feedforward, GRU (whose recurrent
minibatches leave a rank with no share of half of them), feedforward
with RND, the per-minibatch advantage normalization and symmetry, and the
GRU student's distillation. The
losses (global on a device env) at rtol 1e-5 / atol 1e-6; the parameters
and normalizer moments after two iterations at the one-update bar, rtol
3e-4 / atol 3e-5: the ranks sum in another order, and the NLink obs
normalizer's early std (about 3e-3 on ``cos θ``) turns the resulting 1e-7
of the moments into 1e-5 of the normalized obs, which Adam carries into the
weights (at most 1.5e-5 seen). A process group of one rank runs every
collective and equals the plain run bit for bit. With the JAX 2-device
run's weights, action noise and permutations, two data ranks, and two
model ranks, equal the JAX run at rtol 3e-4 / atol 3e-5 over two
iterations. The refusals name their cause.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.parallel import data_sharding as jax_data_sharding
from rsl_rl_tpu.parallel import make_mesh as jax_make_mesh
from rsl_rl_tpu.parallel import replicated as jax_replicated
from rsl_rl_tpu.parallel import shard_tree as jax_shard_tree
from rsl_rl_tpu_torch.algorithms.ppo import dp_minibatches, pack_minibatch_rows
from rsl_rl_tpu_torch.env import (
    CartPoleSwingUp,
    DomainRandomizedNLink,
    Hopper,
    NLinkPendulum,
    PartiallyObservableNLink,
    Pendulum,
    PointMass,
    Reacher,
    SparseGoalReach,
)
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent
from rsl_rl_tpu_torch.parallel import Mesh, data_sharding, make_mesh, make_tp_mesh, shard_tree, time_major_sharding
from rsl_rl_tpu_torch.parallel.mesh import local_slice
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout
from rsl_rl_tpu_torch.utils.weights import from_jax_state
from tests.torch_port_dist_worker import N_GLOBAL, ppo_cfg, run_scenario, save_teacher, save_window, spawn

DP = ("dp_ff", "dp_gru", "dp_options", "dp_distill", "dp_ff_odd", "dp_ff_limits")
#: split, fused and K=2 on two ranks (``torch_port_dist_worker.DISPATCH``)
FUSED = ("fused_ff", "fused_gru", "fused_distill")
#: the JAX run's per-env ``max_episode_length``: a third of the envs (on both
#: ranks) end their episodes at the last step of the second window
J_LIMITS = [2 * 8 if i % 3 == 0 else 1000 for i in range(16)]
LOSS_BAR = {"rtol": 1e-5, "atol": 1e-6}
STATE_BAR = {"rtol": 3e-4, "atol": 3e-5}
JAX_BAR = {"rtol": 3e-4, "atol": 3e-5}
# the JAX parity run (tests/test_torch_port_ff.py's window)
J_LINKS, J_T = 3, 8
J_POLICY = dict(actor_hidden_dims=[32, 32], critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                critic_obs_normalization=True, noise_std_floor=0.01)
J_PPO = dict(num_learning_epochs=2, num_mini_batches=4)
GROUPS = {"policy": ["policy"], "critic": ["policy"]}


def _t(x):
    return torch.tensor(np.asarray(x))


def _norm_np(norm):
    return {k: None if v is None else {"mean": np.asarray(v.mean), "var": np.asarray(v.var),
                                       "count": np.asarray(v.count)}
            for k, v in norm.items()}


def _port_state(obs, ps, policy_kw=J_POLICY) -> dict:
    policy = ActorCritic({k: _t(v) for k, v in obs.items()}, GROUPS, J_LINKS, device="cpu", **policy_kw)
    from_jax_state(jax.device_get(ps.params), _norm_np(ps.norm), policy)
    return {k: v.detach().clone() for k, v in policy.state_dict().items()}


def _jax_draws(ppo, env, ts, cs, inputs, limits=None):
    """Two iterations of the JAX package's split collect and update from
    ``(ts, cs)``, each iteration's action noise and permutation appended to
    ``inputs``; returns the losses and the final states. Episodes end only
    where ``limits`` ends them: at the last step of the last window."""
    collect, update = jax.jit(ppo.make_collect_fn(env, J_T)), jax.jit(ppo.make_update_fn())
    losses = []
    for it in range(2):
        ts, cs, rollout, _ = collect(ts, cs)
        dones = np.asarray(rollout.dones)
        want = np.zeros_like(dones)
        if limits is not None and it == 1:
            want[-1] = np.asarray(limits) == 2 * J_T
        np.testing.assert_array_equal(dones, want)
        r = jax.device_get(rollout)
        inputs["noise"].append(_t((np.asarray(r.actions) - np.asarray(r.mu)) / np.asarray(r.sigma)))
        inputs["perm"].append(_t(jax.random.permutation(jax.random.split(ts.rng)[1], J_T * N_GLOBAL)))
        ts, cs, um = update(ts, cs, rollout)
        losses.append({k: float(v) for k, v in jax.device_get(um).items()})
    return losses, ts, cs


def _jax_inputs(cs, ts, policy_kw, **extra) -> dict:
    """The port's inputs of a JAX run from its start ``(ts, cs)``."""
    st = jax.device_get(cs.env_state)
    return {"links": J_LINKS, "num_steps": J_T, "policy_kw": policy_kw, "ppo_kw": J_PPO,
            "state": _port_state(cs.obs, ts.policy, policy_kw),
            "obs": {k: _t(v) for k, v in jax.device_get(cs.obs).items()},
            "theta": _t(st.theta), "omega": _t(st.omega), "episode_length": _t(st.episode_length),
            "noise": [], "perm": [], **extra}


def _jax_two_device_run(out_dir, limits=None, name="jax_inputs.pt") -> dict:
    """The JAX package's PPO over a 2-device data mesh for two iterations;
    writes the port's inputs (``name``) and returns its losses and final
    state (in the port's names). With ``limits`` (a per-env
    ``max_episode_length``) obs normalization is off: a reset obs at the
    last step would enter the moments, and the two packages' reset draws
    differ."""
    policy_kw = J_POLICY if limits is None else {**J_POLICY, "actor_obs_normalization": False,
                                                 "critic_obs_normalization": False}
    env = JaxNLink(N_GLOBAL, J_LINKS, max_episode_length=1000 if limits is None else np.asarray(limits))
    _, obs = env.reset(jax.random.PRNGKey(0))
    ppo = JaxPPO(JaxAC(obs, GROUPS, env.num_actions, **policy_kw), **J_PPO)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N_GLOBAL)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    mesh = jax_make_mesh(jax.devices()[:2])
    ts, cs = jax_shard_tree(ts, jax_replicated(mesh)), jax_shard_tree(cs, jax_data_sharding(mesh))
    extra = {} if limits is None else {"max_episode_length": torch.tensor(limits, dtype=torch.int32)}
    inputs = _jax_inputs(cs, ts, policy_kw, **extra)
    losses, ts, cs = _jax_draws(ppo, env, ts, cs, inputs, limits)
    torch.save(inputs, out_dir / name)
    return {"losses": losses, "state": _port_state(cs.obs, ts.policy, policy_kw)}


def _jax_fused_runner_run(out_dir) -> dict:
    """The JAX package's ``OnPolicyRunner`` with ``fuse_iteration=True`` on
    its 2-device mesh for two iterations. The draws of its fused program are
    those of its split functions from the same start (the same keys), so
    those replayed from the runner's initial state give the port's inputs
    (``jax_fused_inputs.pt``), and the split replay must end where the
    fused runner ends. Returns the fused runner's losses and final state."""
    from rsl_rl_tpu.runners import OnPolicyRunner as JaxRunner

    env = JaxNLink(N_GLOBAL, J_LINKS, max_episode_length=1000)
    cfg = {"num_steps_per_env": J_T, "save_interval": 100, "seed": 1, "obs_groups": GROUPS, "fuse_iteration": True,
           "policy": {"class_name": "ActorCritic", **J_POLICY}, "algorithm": {"class_name": "PPO", **J_PPO}}
    runner = JaxRunner(env, cfg, log_dir=None)
    assert runner.fuse_iteration and runner.num_devices == 2
    start = jax.device_get((runner.train_state, runner.collect_state))
    metrics, step = [], runner._train_iteration

    def recorded(ts, cs):
        ts, cs, m = step(ts, cs)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        return ts, cs, m

    runner._train_iteration = recorded
    with contextlib.redirect_stdout(io.StringIO()):
        runner.learn(2)
    ts, cs = jax_shard_tree(start[0], jax_replicated(runner.mesh)), jax_shard_tree(start[1],
                                                                                   jax_data_sharding(runner.mesh))
    inputs = _jax_inputs(cs, ts, J_POLICY)
    losses, ts, _ = _jax_draws(runner.alg, env, ts, cs, inputs)
    fused = _port_state(runner.collect_state.obs, runner.train_state.policy)
    for k, v in _port_state(cs.obs, ts.policy).items():
        _close(v, fused[k], JAX_BAR, f"the JAX split replay against its fused runner: {k}")
    torch.save(inputs, out_dir / "jax_fused_inputs.pt")
    return {"losses": metrics, "state": fused}


def _quiet(fn, *args):
    """``fn(*args)`` with one CPU thread, as the ranks run, its console
    output dropped."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _one_process(name, out_dir=None):
    """The scenario in this process, with no process group."""
    return _quiet(run_scenario, name, 1, str(out_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two, one = tmp_path_factory.mktemp("two_ranks"), tmp_path_factory.mktemp("one_rank_group")
    jax_run = _jax_two_device_run(two)
    jax_limits = _jax_two_device_run(two, J_LIMITS, "jax_limits_inputs.pt")
    jax_fused = _jax_fused_runner_run(two)
    window = _quiet(save_window, two)
    _quiet(save_teacher, two)
    out = {"two": spawn(str(two), [*DP, *FUSED, "collectives", "refusals", "jax_parity", "jax_parity_tp",
                                   "jax_parity_limits", "jax_parity_fused", "window_dp", "window_tp",
                                   "fused_resume"], world=2, timeout=300),
           "group_of_one": spawn(str(one), ["dp_gru", "dp_options"], world=1, timeout=300),
           "jax": jax_run, "jax_limits": jax_limits, "jax_fused": jax_fused, "window": window}
    out["one"] = {name: _one_process(name) for name in DP}
    return out


def _close(got, want, bar, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), err_msg=what, **bar)


def _close_runs(got, want, what):
    assert len(got["losses"]) == len(want["losses"])
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        assert set(g) == set(w), what
        for k in w:
            _close(g[k], w[k], LOSS_BAR, f"{what}: iteration {i} {k}")
    assert set(got["state"]) == set(want["state"])
    for k, w in want["state"].items():
        _close(got["state"][k], w, STATE_BAR, f"{what}: {k}")


# ------------------------------------------------------------ placement


def test_make_mesh_without_a_process_group_is_one_rank():
    mesh = make_mesh()
    assert (mesh.data_size, mesh.model_size, mesh.rank, mesh.distributed) == (1, 1, 0, False)
    t = torch.arange(4.0)
    assert mesh.data_sum_(t) is t and torch.equal(t, torch.arange(4.0))
    assert make_tp_mesh(1).axis_names == ("data", )
    with pytest.raises(ValueError, match="must divide"):
        make_tp_mesh(2)


def test_placement_helpers_slice_this_ranks_share():
    """``data_sharding`` / ``time_major_sharding`` slice the data rank's
    contiguous share of axis 0 / 1 (rank 1 of 2 here, a layout with no
    collective); ``local_slice`` refuses a count the data axis does not
    divide."""
    mesh = Mesh(("data",), 2, 1, 1)
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": (torch.arange(12.0).reshape(2, 6),)}
    got = shard_tree(tree, data_sharding(mesh))
    assert torch.equal(got["a"], tree["a"][2:]) and torch.equal(got["b"][0], tree["b"][0][1:])
    got = shard_tree(tree, time_major_sharding(mesh))
    assert torch.equal(got["a"], tree["a"][:, 1:]) and torch.equal(got["b"][0], tree["b"][0][:, 3:])
    assert local_slice(mesh, 16) == (8, 8)
    with pytest.raises(ValueError, match="must divide"):
        local_slice(mesh, 15)


class _GatheringMesh(Mesh):
    """Data rank ``rank`` of two with no process group; its gather
    concatenates the ranks' packed windows (``windows[r]``), in the place of
    the collective."""

    def __init__(self, rank, windows):
        super().__init__(("data",), 2, 1, rank)
        self.windows = windows

    def data_gather(self, t, dim):
        assert torch.equal(t, self.windows[self.rank])
        return torch.cat(self.windows, dim=dim)


def test_minibatches_are_the_global_ones_cut_to_each_rank():
    """Each rank's share of every global minibatch, fixed by the layout:
    recurrent, slices of the global env axis (rank 0 of 2 owns none of the
    last two of four); feedforward, from the gathered window, rows ``[r s,
    (r + 1) s)`` of each slice of the global permutation, ``s = ceil(mb /
    2)``: 8 and 7 rows of a minibatch of 15, the same counts for every
    permutation, the two shares the minibatch in the permutation's order."""
    T, N, A = 3, 5, 1
    g = torch.Generator().manual_seed(0)

    def rollout(offset):
        env = torch.arange(N, dtype=torch.float32) + offset
        obs = {"policy": (env[None, :] + 100 * torch.arange(T)[:, None])[..., None].clone()}
        zero = torch.zeros(T, N)
        return Rollout(obs=obs, actions=torch.zeros(T, N, A), rewards=zero, dones=zero.bool(), values=zero,
                       log_probs=zero, mu=torch.zeros(T, N, A), sigma=torch.ones(T, N, A),
                       carry0={"h": env[:, None].clone()})

    class Recurrent:
        is_recurrent = True

    class Feedforward:
        is_recurrent = False

    zeros = torch.zeros(T, N)
    for rank in range(2):
        mesh = Mesh(("data",), 2, 1, rank)
        got = list(dp_minibatches(Recurrent, rollout(N * rank), zeros, zeros, 5, 1, None, mesh))
        assert [n for _, _, n, _ in got] == ([2, 2, 1, 0, 0] if rank == 0 else [0, 0, 1, 2, 2])
        assert all(nb == 2 for *_, nb in got)
    windows = [pack_minibatch_rows(rollout(N * r), zeros, zeros, None)[0].view(T, N, -1) for r in range(2)]
    for draw in range(2):
        perm = torch.randperm(T * 2 * N, generator=g)
        rows = [list(dp_minibatches(Feedforward, rollout(N * r), zeros, zeros, 2, 2, perm, _GatheringMesh(r, windows)))
                for r in range(2)]
        for r in range(2):
            assert [(n, mb) for _, _, n, mb in rows[r]] == [(8, 15) if r == 0 else (7, 15)] * 4
        for i in range(4):
            got = torch.cat([r[i][0]["obs"]["policy"][:, 0] for r in rows])
            want = perm[(i % 2) * 15:(i % 2 + 1) * 15]
            assert torch.equal(got, ((want // (2 * N)) * 100 + want % (2 * N)).float())


def test_env_shard_cuts_a_per_env_limit():
    """``VecEnv.shard``: the env itself for one limit or a per-env limit of
    the shard's count; a copy holding its slice of a per-env limit over the
    global envs, which steps as the global env's rows do; ``ValueError``
    for a limit of neither count."""
    env = NLinkPendulum(8, 2, max_episode_length=5, device="cpu")
    assert env.shard(4, 4) is env
    limits = torch.tensor([2, 3, 4, 5, 2, 3, 4, 5])
    full = NLinkPendulum(8, 2, max_episode_length=limits, device="cpu")
    part = full.shard(4, 4)
    assert part is not full and torch.equal(part.max_episode_length, limits[4:].int())
    assert torch.equal(full.max_episode_length, limits.int()) and part.num_envs == 8
    assert NLinkPendulum(4, 2, max_episode_length=limits[:4], device="cpu").shard(0, 4).max_episode_length.numel() == 4
    state, _ = full.reset(1)
    shard, _ = part.reset(1, num_envs=4, env_offset=4)
    a = torch.zeros(8, 2)
    for _ in range(6):
        state, _, _, done, _ = full.step(state, a)
        shard, _, _, sdone, _ = part.step(shard, a[4:])
        assert torch.equal(sdone, done[4:]) and torch.equal(shard.episode_length, state.episode_length[4:])
    assert torch.equal(part.randomize_episode_length(shard).episode_length < limits[4:], torch.ones(4, dtype=bool))
    with pytest.raises(ValueError, match="12 entries for 4 envs"):
        NLinkPendulum(8, 2, max_episode_length=torch.arange(3, 15), device="cpu").shard(4, 4)


ENVS = {
    "nlink": lambda n: NLinkPendulum(n, 3, max_episode_length=4, device="cpu"),
    "po_nlink": lambda n: PartiallyObservableNLink(n, 3, max_episode_length=4, device="cpu"),
    "dr_nlink": lambda n: DomainRandomizedNLink(n, 3, max_episode_length=4, device="cpu"),
    "cartpole": lambda n: CartPoleSwingUp(n, max_episode_length=4, device="cpu"),
    "hopper": lambda n: Hopper(n, max_episode_length=4, device="cpu"),
    "pendulum": lambda n: Pendulum(n, max_episode_length=4, device="cpu"),
    "reacher": lambda n: Reacher(n, max_episode_length=4, device="cpu"),
    "sparse": lambda n: SparseGoalReach(n, max_episode_length=4, device="cpu"),
    "point_mass": lambda n: PointMass(n, max_episode_length=4, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_shard_steps_as_the_global_envs_rows(name):
    """A shard reset with ``env_offset`` holds the global env's keys and
    state rows, and steps as those rows do, resets included."""
    full_env, shard_env = ENVS[name](8), ENVS[name](8)
    full, full_obs = full_env.reset(3)
    shard, shard_obs = shard_env.reset(3, num_envs=4, env_offset=4)
    g = torch.Generator().manual_seed(1)
    for step in range(10):
        for k in full_obs:
            torch.testing.assert_close(shard_obs[k], full_obs[k][4:], rtol=0, atol=0, msg=f"{name} {k} step {step}")
        torch.testing.assert_close(shard.rng, full.rng[4:], rtol=0, atol=0)
        a = torch.rand(8, full_env.num_actions, generator=g) * 2 - 1
        full, full_obs, rew, done, _ = full_env.step(full, a)
        shard, shard_obs, srew, sdone, _ = shard_env.step(shard, a[4:])
        torch.testing.assert_close(srew, rew[4:], rtol=0, atol=0)
        assert torch.equal(sdone, done[4:])


# ------------------------------------------------------- against one process


@pytest.mark.parametrize("name", DP)
def test_two_ranks_equal_one_process(runs, name):
    ranks = runs["two"][name]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), f"{name}: the ranks' states differ at {k}"
    assert ranks[0]["losses"] == ranks[1]["losses"], f"{name}: the ranks' metrics differ"
    _close_runs(ranks[0], runs["one"][name], name)


@pytest.mark.parametrize("layout", ["window_dp", "window_tp"], ids=["data", "model"])
def test_the_ranks_update_of_one_window_equals_one_process(runs, layout):
    """The one-process run's first GRU window, updated with SGD (a step
    linear in the gradient) on two data ranks (each its envs' rows) or two
    model ranks (the trunks sliced): the parameters at rtol 1e-5 / atol
    1e-6, and the update itself within 1e-4 of its largest entry. Along a
    run the ranks drift from the one process only as rounding is
    amplified."""
    before, after = runs["window"]
    for r in range(2):
        got = runs["two"][layout][r]
        scale = max(float((v - before[k]).abs().max()) for k, v in after.items())
        for k, v in after.items():
            _close(got[k], v, LOSS_BAR, f"rank {r} {k}")
            _close(got[k] - before[k], v - before[k], {"rtol": 0.0, "atol": 1e-4 * scale}, f"rank {r} update {k}")


@pytest.mark.parametrize("name", ["dp_gru", "dp_options"])
def test_a_group_of_one_equals_the_plain_run_bit_for_bit(runs, name):
    """One Gloo rank runs every collective of the mesh path; its formulas
    (each rank's moments weighted by its share) leave one rank's numbers
    as they are."""
    got, want = runs["group_of_one"][name][0], _one_process(name)
    assert got["losses"] == want["losses"]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k


@pytest.mark.parametrize("layout", ["jax_parity", "jax_parity_tp"], ids=["data", "model"])
def test_two_ranks_equal_the_jax_two_device_run(runs, layout):
    """The JAX weights (``from_jax_state``), noise and permutations on two
    data ranks, and on two model ranks (the trunks sliced, ``shard_tree_tp``
    of the same full state), against the JAX package's 2-device run."""
    got, want = runs["two"][layout], runs["jax"]
    for rank in range(2):
        for i, (g, w) in enumerate(zip(got[rank]["losses"], want["losses"])):
            assert set(g) == set(w)
            for k in w:
                _close(g[k], w[k], JAX_BAR, f"rank {rank} iteration {i} {k}")
        for k, w in want["state"].items():
            _close(got[rank]["state"][k], w, JAX_BAR, f"rank {rank} {k}")


def test_per_env_episode_limits_equal_the_jax_two_device_run(runs):
    """A per-env ``max_episode_length`` over the 16 global envs, each rank
    stepping its slice (``VecEnv.shard``), with the JAX run's weights, noise
    and permutations: a third of the episodes time out at the last step,
    bootstrapped and cut in GAE as in the JAX package's 2-device run."""
    got, want = runs["two"]["jax_parity_limits"], runs["jax_limits"]
    for rank in range(2):
        for i, (g, w) in enumerate(zip(got[rank]["losses"], want["losses"])):
            for k in w:
                _close(g[k], w[k], JAX_BAR, f"rank {rank} iteration {i} {k}")
        for k, w in want["state"].items():
            _close(got[rank]["state"][k], w, JAX_BAR, f"rank {rank} {k}")


@pytest.mark.parametrize("name", FUSED)
def test_fused_and_k2_runs_equal_the_split_run_on_two_ranks(runs, name):
    """``fuse_iteration`` and ``iterations_per_dispatch: 2`` on two ranks
    (the iteration run eagerly on the CPU, with its collectives) against
    the split run of the same ranks over 3 iterations: every state tensor
    and every metric bit for bit, on each rank."""
    for rank in range(2):
        res = runs["two"][name][rank]
        split = res["split"]
        for mode in ("fused", "k2"):
            assert len(res[mode]["tensors"]) == len(split["tensors"])
            for i, (a, b) in enumerate(zip(res[mode]["tensors"], split["tensors"])):
                assert torch.equal(a, b), f"{name} rank {rank} {mode}: state tensor {i} differs"
            assert res[mode]["losses"] == split["losses"], f"{name} rank {rank} {mode}: the metrics differ"


def test_fused_run_equals_the_jax_two_device_fused_runner(runs):
    """A fused ``OnPolicyRunner`` on two ranks from the JAX fused runner's
    start, its noise and permutations injected, against the JAX package's
    2-device ``fuse_iteration=True`` ``OnPolicyRunner``: the losses and the
    noise std of both iterations and the final policy state at the bars of
    :func:`test_two_ranks_equal_the_jax_two_device_run`."""
    got, want = runs["two"]["jax_parity_fused"], runs["jax_fused"]
    for rank in range(2):
        for i, (g, w) in enumerate(zip(got[rank]["losses"], want["losses"])):
            keys = [k for k in w if k.startswith("Loss/") or k == "Policy/mean_noise_std"]
            assert len(keys) >= 6 and set(keys) <= set(g)
            for k in keys:
                _close(g[k], w[k], JAX_BAR, f"rank {rank} iteration {i} {k}")
        for k, w in want["state"].items():
            _close(got[rank]["state"][k], w, JAX_BAR, f"rank {rank} {k}")


def test_a_save_at_a_group_boundary_resumes_bit_for_bit(runs):
    """K=2 on two ranks with a ``log_dir``: rank 0 writes ``model_1.pt`` and
    ``model_3.pt`` at the groups' ends; a fresh mesh runner loads
    ``model_1.pt`` into exactly the state of a 2-iteration run (policy,
    optimizer moments and count, learning rate) on each rank, and goes on
    from iteration 1."""
    for rank in range(2):
        res = runs["two"]["fused_resume"][rank]
        assert {"model_1.pt", "model_3.pt"} <= set(res["files"])
        assert res["start"] == 1 and res["logged"] == [1, 2]
        loaded, want = res["loaded"], res["two"]
        for part in ("policy", "mu", "nu"):
            for k, v in want[part].items():
                assert torch.equal(loaded[part][k], v), f"rank {rank} {part} {k}"
        assert torch.equal(loaded["count"], want["count"]) and torch.equal(loaded["lr"], want["lr"])


def test_global_reductions_over_two_ranks(runs):
    """``global_sum``, ``global_mean`` and ``global_mean_std`` of each rank's
    shard are the whole tensor's, for equal, uneven and empty shards;
    ``replicated`` gives every rank data rank 0's tensor, ``data_sharding``
    each rank its contiguous half."""
    full = torch.randn(16, generator=torch.Generator().manual_seed(0))
    want = torch.stack([full.mean(), full.std()])
    for r in range(2):
        got = runs["two"]["collectives"][r]
        torch.testing.assert_close(got["sum"], full.sum())
        torch.testing.assert_close(got["mean"], full.mean())
        for label in ("mean_std", "uneven", "empty"):
            torch.testing.assert_close(got[label], want, msg=label)
        assert torch.equal(got["replicated"], torch.ones(3))
        assert torch.equal(got["data_sharding"], full[8 * r:8 * (r + 1)])


def test_distributed_init_without_markers_is_a_no_op(monkeypatch):
    """No arguments and no torchrun markers (or a world of one): nothing is
    initialized, as the JAX package's ``distributed_init`` on one host."""
    import torch.distributed as dist

    from rsl_rl_tpu_torch.parallel import distributed_init

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert distributed_init() is False and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed_init() is False and not dist.is_initialized()


REFUSALS = {
    "make_tp_mesh(3)": ("ValueError", "must divide"),
    "model_parallel_size: 3": ("ValueError", "must divide"),
    "15 envs": ("ValueError", "must divide"),
    "max_episode_length of 12 envs": ("ValueError", "12 entries for 8 envs (nor for the global 16)"),
    "fused on cuda over gloo": ("ValueError", "group is gloo"),
    "host env, model_parallel_size: 2": ("ValueError", "functional"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_two_ranks_refuse_with_the_cause(runs, case):
    err, words = REFUSALS[case]
    for rank in range(2):
        msg = runs["two"]["refusals"][rank]["messages"][case]
        assert msg.startswith(err + ":") and words in msg, msg


def test_single_process_runner_has_no_mesh():
    """Without a process group the runner trains as before: no mesh, no bridge."""
    with contextlib.redirect_stdout(io.StringIO()):
        runner = OnPolicyRunner(NLinkPendulum(N_GLOBAL, 2, device="cpu"), ppo_cfg(recurrent=True), device="cpu")
        runner.learn(1)
    assert runner.mesh is None and runner.alg.mesh is None and runner.num_global_envs == N_GLOBAL
    assert isinstance(runner.alg.policy, ActorCriticRecurrent)
