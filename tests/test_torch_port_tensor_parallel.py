"""The port's tensor parallelism (``parallel/tp.py``, the Megatron layers of
``networks/mlp.py``, the clip's norm and the checkpoints under
``model_parallel_size``) against ``tests/test_tensor_parallel.py``: the
sharding is placement, never math.

- ``tp_tree_shardings`` gives each MLP leaf the role the JAX package's
  specs give it (torch's ``[out, in]`` weight against flax's ``[in, out]``
  kernel), and the optimizer moments the roles of their parameters.
- Two Gloo ranks on the CPU (one data rank, two model ranks; spawned once,
  ``tests/torch_port_dist_worker.py``) train as one replicated process: fp32
  trunks and a GRU policy at rtol 1e-5 / atol 1e-6 (losses, parameters and
  the policy's outputs), bf16 trunks at the repo's bf16 bar (rtol 5e-2 /
  atol 3e-2 on the parameters and outputs; losses rtol 1e-3 / atol 1e-4,
  inside the repo's bf16 loss bar of ``tests/test_torch_port_ff.py``, the
  atol for the surrogate, a near-zero sum of terms of the whitened
  advantages' scale): the row-parallel products are summed in fp32 and
  rounded once, as the unsharded layer rounds its accumulation.
- One backward through the headline's bf16 trunk gives the unsharded
  gradients within 1e-3 of their norm: the column-parallel input's
  gradient, like the row-parallel products, is summed in fp32 and rounded
  once.
- A one-process checkpoint loads into the two ranks and theirs, gathered,
  into one process; a model axis that does not divide the ranks raises
  ``must divide``.
- The fused and K=2 iterations of the cut-down headline on the two model
  ranks equal its split run bit for bit.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rsl_rl_tpu.networks.mlp import MLP as JaxMLP
from rsl_rl_tpu.parallel.tp import make_tp_mesh as jax_make_tp_mesh
from rsl_rl_tpu.parallel.tp import tp_tree_shardings as jax_tp_tree_shardings
from rsl_rl_tpu_torch.algorithms.ppo import clip_step
from rsl_rl_tpu_torch.env import NLinkPendulum
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.parallel import make_tp_mesh, shard_tree_tp, tp_tree_shardings
from rsl_rl_tpu_torch.parallel.mesh import Mesh
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from tests.torch_port_dist_worker import N_GLOBAL, LINKS, ppo_cfg, run_scenario, spawn

TP = ("tp_ff", "tp_ff_bf16", "tp_gru")
FP32 = {"loss": {"rtol": 1e-5, "atol": 1e-6}, "state": {"rtol": 1e-5, "atol": 1e-6}}
BF16 = {"loss": {"rtol": 1e-3, "atol": 1e-4}, "state": {"rtol": 5e-2, "atol": 3e-2}}
#: the JAX spec of a flax leaf -> the port's spec of the torch leaf
TORCH_SPEC = {("kernel", P(None, "model")): ("model", None), ("kernel", P("model", None)): (None, "model"),
              ("bias", P("model")): ("model",), ("kernel", P()): (), ("bias", P()): ()}


def _quiet(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _runner(model_parallel_size=1):
    return OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                          ppo_cfg(model_parallel_size=model_parallel_size), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")

    def one_rank_checkpoint():
        runner = _runner()
        runner.learn(1)
        runner.save(str(out / "one_rank.pt"))
        return runner

    saved = _quiet(one_rank_checkpoint)
    ranks = spawn(str(out), [*TP, "tp_grads_bf16", "tp_checkpoint", "fused_tp_headline"], world=2, timeout=300)
    one = {name: _quiet(run_scenario, name, 1, str(out)) for name in (*TP, "tp_grads_bf16")}
    return {"ranks": ranks, "one": one, "dir": out, "saved": saved}


def _close(got, want, bar, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), err_msg=what, **bar)


# ----------------------------------------------------------------- specs


@pytest.mark.parametrize("in_dim,out_dim,hidden", [(4, 3, [16, 16]), (6, 4, [16, 16, 16]), (5, 2, [16, 16]),
                                                   (4, 1, [15, 16]), (7, 6, [8])])
def test_tp_tree_shardings_match_jax_specs(in_dim, out_dim, hidden):
    """Leaf for leaf, the role of each ``dense_k`` weight and bias equals the
    JAX spec of its kernel and bias (``tests/test_tensor_parallel.py:18-61``)."""
    jparams = JaxMLP(output_dim=out_dim, hidden_dims=hidden).init(jax.random.PRNGKey(0),
                                                                  jnp.zeros((1, in_dim)))["params"]
    jspecs = jax.tree.map(lambda s: s.spec, jax_tp_tree_shardings(jparams, jax_make_tp_mesh(2, jax.devices()[:2])))
    specs = tp_tree_shardings(MLP(in_dim, out_dim, hidden).state_dict(), 2)
    assert len(specs) == 2 * len(jparams)
    for layer, leaves in jspecs.items():
        for leaf, spec in leaves.items():
            name = f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"
            assert specs[name] == TORCH_SPEC[(leaf, spec)], f"{name}: {specs[name]} against JAX {spec}"


def test_optimizer_moments_and_non_mlp_leaves():
    """The optimizer moments, keyed by parameter name, shard as their
    parameters; the normalizers, the memories and the std stay whole."""
    with contextlib.redirect_stdout(io.StringIO()):
        runner = OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, device="cpu"), ppo_cfg(recurrent=True), device="cpu")
    specs = tp_tree_shardings(runner.alg.policy.state_dict(), 2)
    moments = tp_tree_shardings(runner.alg.optimizer_state()["mu"], 2)
    assert moments == {k: specs[k] for k in moments}
    assert specs["actor.dense_0.weight"] == ("model", None) and specs["actor.dense_0.bias"] == ("model",)
    for k, spec in specs.items():
        if "dense_" not in k:
            assert spec == (), k
    assert any(k.startswith("memory_a") for k in specs) and specs["std"] == ()


def test_shard_tree_tp_slices_each_model_rank():
    full = MLP(4, 3, [16, 16]).state_dict()
    shards = [shard_tree_tp(full, Mesh(("data", "model"), 1, 2, r)) for r in range(2)]
    torch.testing.assert_close(torch.cat([s["dense_0.weight"] for s in shards], 0), full["dense_0.weight"])
    torch.testing.assert_close(torch.cat([s["dense_0.bias"] for s in shards], 0), full["dense_0.bias"])
    torch.testing.assert_close(torch.cat([s["dense_1.weight"] for s in shards], 1), full["dense_1.weight"])
    for k in ("dense_1.bias", "dense_2.weight", "dense_2.bias"):
        assert shards[0][k] is full[k] and shards[1][k] is full[k]


def test_clip_norm_counts_each_shard_once():
    """Under tensor parallelism the clip's norm is the full gradients':
    the sliced ones summed over the model group (two ranks' equal slices
    stand in here as one slice doubled), the whole ones once."""
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(5, generator=g)
    piece = torch.randn(6, generator=g)
    full_grads = [whole, torch.cat([piece, piece])]
    zeros = [torch.zeros_like(t) for t in full_grads]
    want = clip_step(zeros, full_grads, zeros, zeros, torch.zeros((), dtype=torch.int32), 0.1, 0.5)[0]
    grads = [whole, piece]
    zs = [torch.zeros_like(t) for t in grads]
    got = clip_step(zs, grads, zs, zs, torch.zeros((), dtype=torch.int32), 0.1, 0.5, sharded=[False, True],
                    model_sum=lambda t: 2 * t)[0]
    torch.testing.assert_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1][:6])


def test_bad_model_parallel_size_raises():
    with pytest.raises(ValueError, match="must divide"):
        make_tp_mesh(3)
    with pytest.raises(ValueError, match="must divide"):
        _runner(model_parallel_size=2)


# ------------------------------------------------------ against replicated


@pytest.mark.parametrize("name", TP)
def test_model_sharded_trains_as_replicated(runs, name):
    bar = BF16 if name.endswith("bf16") else FP32
    ranks, want = runs["ranks"][name], runs["one"][name]
    for r in range(2):
        for i, w in enumerate(want["losses"]):
            for k, v in w.items():
                _close(ranks[r]["losses"][i][k], v, bar["loss"], f"{name} rank {r} iteration {i} {k}")
        for k, w in want["state"].items():
            _close(ranks[r]["state"][k], w, bar["state"], f"{name} rank {r} {k}")
        _close(ranks[r]["outputs"], want["outputs"], bar["state"], f"{name} rank {r} policy outputs")


def test_bf16_gradients_sum_before_rounding(runs):
    """One backward through the headline's bf16 trunk on two model ranks
    against the unsharded one: every parameter's gradient within 1e-3 of
    its norm. The partial sums that cross ranks are fp32 and rounded to bf16
    once after the sum; summing bf16-rounded parts instead leaves dense_0's
    and dense_1's gradients about 5e-3 of their norm apart (two thirds of
    their entries a bf16 rounding off)."""
    want = runs["one"]["tp_grads_bf16"]
    for r, got in enumerate(runs["ranks"]["tp_grads_bf16"]):
        for k, w in want.items():
            share = float((got[k] - w).norm() / w.norm())
            assert share < 1e-3, f"rank {r} {k}: |grad - unsharded grad| / |unsharded grad| = {share:.3e}"


def test_checkpoints_cross_topologies(runs):
    """A one-process checkpoint loads into the two model ranks (gathered, the
    file's state; the Adam moments sliced), and the two ranks' save, gathered
    by rank 0, loads into one process as the state they trained."""
    ranks, out = runs["ranks"]["tp_checkpoint"], runs["dir"]
    saved = runs["saved"].alg
    for r in range(2):
        for k, v in saved.policy.state_dict().items():
            assert torch.equal(ranks[r]["loaded"][k], v), k
        mu = dict(zip(saved.param_names, saved.adam_mu))
        shard = shard_tree_tp(mu, Mesh(("data", "model"), 1, 2, r), tp_tree_shardings(saved.policy.state_dict(), 2))
        for k, v in ranks[r]["mu_shards"].items():
            assert torch.equal(v, shard[k]), k
    with contextlib.redirect_stdout(io.StringIO()):
        one = _runner()
        one.load(str(out / "tp.pt"))
    for k, v in one.alg.policy.state_dict().items():
        assert torch.equal(v, ranks[0]["state"][k]), k
    assert one.current_learning_iteration == ranks[0]["iteration"]


def test_fused_and_k2_headline_equal_the_split_run(runs):
    """The headline's shape cut down (bf16 trunks [16, 16, 16]) on two model
    ranks with ``fuse_iteration`` and ``iterations_per_dispatch: 2``: the
    row-parallel sums inside the fused iteration, every state tensor (the
    parameter slices, the sliced optimizer moments) and every metric of 3
    iterations equal to the split run's bit for bit, on each rank."""
    for r, res in enumerate(runs["ranks"]["fused_tp_headline"]):
        for mode in ("fused", "k2"):
            assert len(res[mode]["tensors"]) == len(res["split"]["tensors"])
            for i, (a, b) in enumerate(zip(res[mode]["tensors"], res["split"]["tensors"])):
                assert torch.equal(a, b), f"rank {r} {mode}: state tensor {i} differs"
            assert res[mode]["losses"] == res["split"]["losses"], f"rank {r} {mode}: the metrics differ"
