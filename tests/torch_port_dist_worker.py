"""Scenarios of the port's data- and tensor-parallel tests, and the worker
that runs them as one Gloo rank on the CPU.

    python tests/torch_port_dist_worker.py <rank> <world_size> <init_file> <out_dir> <scenario> ...

Each worker joins the process group through ``init_method=file://<init_file>``
(no port to race for), runs the scenarios in order, saves what a test
compares to ``<out_dir>/<scenario>.rank<r>.pt`` and prints one JSON line a
scenario, ``{"scenario": ..., "rank": ..., "ok": true}``. A scenario is a
function of the rank layout: called in the test's own process, with no
process group, it is the one-process run of the same global configuration
that the ranks' runs must equal. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.algorithms.distillation import Distillation  # noqa: E402
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, init_episode_stats  # noqa: E402
from rsl_rl_tpu_torch.env import NLinkPendulum, PointMass  # noqa: E402
from rsl_rl_tpu_torch.env.toy import point_mass_symmetry  # noqa: E402
from rsl_rl_tpu_torch.modules import ActorCritic, StudentTeacherRecurrent  # noqa: E402
from rsl_rl_tpu_torch.networks.mlp import MLP  # noqa: E402
from rsl_rl_tpu_torch.parallel import (  # noqa: E402
    HostShardingBridge,
    data_sharding,
    distributed_init,
    make_mesh,
    make_tp_mesh,
    replicated,
    shard_tree,
)
from rsl_rl_tpu_torch.parallel.mesh import global_mean, global_mean_std, global_sum, local_slice  # noqa: E402
from rsl_rl_tpu_torch.parallel.tp import gather_tree_tp, shard_module_tp  # noqa: E402
from rsl_rl_tpu_torch.runners import DistillationRunner, OnPolicyRunner  # noqa: E402
from rsl_rl_tpu_torch.runners.training_loop import check_graph_backends  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import full_state, run_state  # noqa: E402
from tests.torch_port_host_env_double import ShardableHostEnv  # noqa: E402

N_GLOBAL, T, LINKS, ITERATIONS = 16, 8, 2, 2
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
#: RND with both normalizers (the ppo tests' config)
RND_CFG = {"weight": 0.5, "num_outputs": 4, "predictor_hidden_dims": [-1], "target_hidden_dims": [-1],
           "state_normalization": True, "reward_normalization": True, "learning_rate": 1e-3}


def rank_world() -> tuple[int, int]:
    dist = torch.distributed
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def ppo_cfg(recurrent=False, hidden=(16, 16), dtype=None, **keys) -> dict:
    policy = {"class_name": "ActorCritic", "actor_hidden_dims": list(hidden), "critic_hidden_dims": list(hidden),
              "actor_obs_normalization": True, "critic_obs_normalization": True}
    if recurrent:
        policy.update(class_name="ActorCriticRecurrent", rnn_type="gru", rnn_hidden_dim=8)
    if dtype is not None:
        policy["dtype"] = dtype
    algorithm = {"class_name": "PPO", "num_learning_epochs": 2, "num_mini_batches": 4, "learning_rate": 1e-3,
                 "schedule": "adaptive", "desired_kl": 0.01, "max_grad_norm": 1.0, **keys.pop("algorithm", {})}
    return {"num_steps_per_env": T, "save_interval": 100, "seed": 5, "obs_groups": GROUPS, "policy": policy,
            "algorithm": algorithm, **keys}


@torch.no_grad()
def policy_outputs(policy, obs: dict) -> torch.Tensor:
    """The deterministic actions of a fresh carry on ``obs``."""
    return policy.act_inference(obs, policy.initial_carry(next(iter(obs.values())).shape[0]))[0]


def runner_result(runner) -> dict:
    return {"losses": [{k: v for k, v in row["metrics"].items()} for row in runner.history],
            "state": full_state(runner.alg), "outputs": policy_outputs(runner.alg.policy, runner.collect_state.obs)}


def train(env, cfg, iterations=ITERATIONS) -> dict:
    runner = OnPolicyRunner(env, cfg, device="cpu")
    runner.learn(iterations)
    return runner_result(runner)


# ----------------------------------------------------------------- scenarios
# each returns what the test compares; the distributed run and the
# one-process run call the same function


def dp_ff(world):
    """Feedforward PPO on 16 NLink envs whose episodes end inside the window."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"), ppo_cfg())


def dp_gru(world):
    """GRU PPO, 4 recurrent minibatches of 4 envs: on two ranks each owns
    none of half of them."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"), ppo_cfg(recurrent=True))


def dp_options(world):
    """Feedforward PPO with RND, the per-minibatch advantage normalization
    and symmetry (augmentation and the mirror loss) on 16 PointMass envs."""
    cfg = ppo_cfg(algorithm={
        "normalize_advantage_per_mini_batch": True, "rnd_cfg": dict(RND_CFG),
        "symmetry_cfg": {"use_data_augmentation": True, "use_mirror_loss": True,
                         "data_augmentation_func": point_mass_symmetry, "mirror_loss_coeff": 0.5}})
    cfg["obs_groups"] = {**GROUPS, "rnd_state": ["policy"]}
    return train(PointMass(N_GLOBAL, max_episode_length=6, device="cpu"), cfg)


#: a per-env ``max_episode_length`` over the 16 global envs: each rank's
#: shard holds short and long limits
LIMITS = [3, 5, 4, 7, 6, 9, 5, 3, 8, 4, 6, 5, 7, 3, 9, 4]


def dp_ff_odd(world):
    """Feedforward PPO with 5 minibatches of 25 of the window's 128 rows: on
    two ranks each replays 13 and 12 rows of each."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                 ppo_cfg(algorithm={"num_mini_batches": 5}))


def dp_ff_limits(world):
    """Feedforward PPO on 16 NLink envs with a per-env ``max_episode_length``
    (:data:`LIMITS`), the episode lengths scattered first
    (``init_at_random_ep_len``): each rank steps its shard's slice."""
    runner = OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=torch.tensor(LIMITS), device="cpu"),
                            ppo_cfg(), device="cpu")
    runner.learn(ITERATIONS, init_at_random_ep_len=True)
    return runner_result(runner)


def _host_env(world):
    rank, _ = rank_world()
    n = N_GLOBAL // world
    return ShardableHostEnv(n, start_id=rank * n, max_episode_length=6)


def host_ff(world):
    """Feedforward PPO through the bridge: each rank steps its shard."""
    return train(_host_env(world), ppo_cfg())


def host_ff_fused(world):
    """:func:`host_ff` asked to fuse: the runner trains split."""
    runner = OnPolicyRunner(_host_env(world), ppo_cfg(fuse_iteration=True), device="cpu")
    runner.learn(ITERATIONS)
    return {**runner_result(runner), "fuse_iteration": runner.fuse_iteration,
            "iteration_graph": runner.iteration_graph}


def host_gru(world):
    return train(_host_env(world), ppo_cfg(recurrent=True))


def host_distill(world):
    """The GRU student's distillation through the bridge, algorithm-level (a
    runner needs a loaded teacher, which sharding does not concern)."""
    env = _host_env(world)
    obs = {k: torch.as_tensor(v) for k, v in env.reset().items()}
    policy = StudentTeacherRecurrent(obs, {"policy": ["policy"], "teacher": ["policy"]}, env.num_actions,
                                     rnn_type="gru", rnn_hidden_dim=8, student_hidden_dims=[16],
                                     teacher_hidden_dims=[16], student_obs_normalization=True, device="cpu",
                                     seed=3)
    alg = Distillation(policy, gradient_length=3, max_grad_norm=1.0, seed=4)
    bridge = HostShardingBridge(make_mesh()) if world > 1 else None
    collect = alg.make_host_collect_fn(env, T, bridge=bridge)
    cs = alg.init_collect_state((), obs, env.num_envs)
    losses = []
    for _ in range(ITERATIONS):
        cs, rollout, cm = collect(cs)
        cs, um = alg.update(cs, rollout)
        losses.append({k: float(v) for k, v in {**cm, **um}.items()})
    return {"losses": losses, "state": full_state(alg)}


def dp_distill(world):
    """The GRU student's distillation on a device env, algorithm-level: each
    rank resets its shard of the 16 global envs."""
    env = NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu")
    mesh = make_mesh() if world > 1 else None
    offset, n = (0, N_GLOBAL) if mesh is None else local_slice(mesh, N_GLOBAL)
    state, obs = env.reset(5, num_envs=n, env_offset=offset)
    policy = StudentTeacherRecurrent(obs, {"policy": ["policy"], "teacher": ["policy"]}, env.num_actions,
                                     rnn_type="gru", rnn_hidden_dim=8, student_hidden_dims=[16],
                                     teacher_hidden_dims=[16], student_obs_normalization=True, device="cpu",
                                     seed=3)
    alg = Distillation(policy, gradient_length=3, max_grad_norm=1.0, seed=4)
    if mesh is not None:
        alg.distribute(mesh)
    cs = alg.init_collect_state(state, obs, n)
    losses = []
    for _ in range(ITERATIONS):
        cs, rollout, cm = alg.collect(env, cs, T)
        cs, um = alg.update(cs, rollout)
        losses.append({k: float(v) for k, v in {**cm, **um}.items()})
    return {"losses": losses, "state": full_state(alg)}


def tp_ff(world):
    """``model_parallel_size: 2`` (one data rank, two model ranks) against
    replicated, fp32 trunks [16, 16]; the actor head (2 actions) is
    column-parallel and gathers its output."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                 ppo_cfg(model_parallel_size=world))


def tp_ff_bf16(world):
    """The same with bf16 trunks [16, 16, 16] (fp32 heads)."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                 ppo_cfg(hidden=(16, 16, 16), dtype=torch.bfloat16, model_parallel_size=world))


def tp_grads_bf16(world):
    """The gradients of one backward through the headline's bf16 trunk
    [256, 256, 256] (8 inputs, 4 outputs, 512 rows) on ``world`` model
    ranks, gathered whole; one process runs it unsharded."""
    mlp = MLP(8, 4, [256, 256, 256], generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x, c = torch.randn(512, 8, generator=g), torch.randn(512, 4, generator=g)
    if world > 1:
        mesh = make_tp_mesh(world)
        specs = shard_module_tp(mlp, mesh)
    (mlp(x) * c).sum().backward()
    grads = {n: p.grad for n, p in mlp.named_parameters()}
    return grads if world == 1 else gather_tree_tp(grads, mesh, specs)


def tp_gru(world):
    """A GRU policy under tensor parallelism: the memories replicated, the
    trunks sharded."""
    return train(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                 ppo_cfg(recurrent=True, model_parallel_size=world))


def tp_checkpoint(world, out_dir=None):
    """A tensor-parallel runner loads the one-process checkpoint
    ``one_rank.pt`` (its gathered state equals the file's), trains an
    iteration and saves ``tp.pt`` (rank 0 writes the gathered state)."""
    runner = OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                            ppo_cfg(model_parallel_size=world), device="cpu")
    runner.load(os.path.join(out_dir, "one_rank.pt"))
    loaded = full_state(runner.alg)
    mu = {k: v.clone() for k, v in runner.alg.optimizer_state()["mu"].items()}
    runner.learn(1)
    runner.save(os.path.join(out_dir, "tp.pt"))
    return {"loaded": loaded, "mu_shards": mu, "state": full_state(runner.alg),
            "iteration": runner.current_learning_iteration}


def collectives(world):
    """The data group's sum, mean and (mean, unbiased std) of a 16-element
    tensor from each rank's shard: equal shards, uneven ones (5 and 11) and
    an empty one (0 and 16)."""
    rank, _ = rank_world()
    full = torch.randn(16, generator=torch.Generator().manual_seed(0))
    mesh = make_mesh()
    n = 16 // world
    shard = full[rank * n:(rank + 1) * n]
    out = {"sum": global_sum(shard, mesh), "mean": global_mean(shard, mesh),
           "mean_std": torch.stack(global_mean_std(shard, mesh))}
    for label, cut in (("uneven", 5), ("empty", 0)):
        part = full[:cut] if rank == 0 else full[cut:]
        out[label] = torch.stack(global_mean_std(part, mesh, 16))
    # placement: data rank 0's tensor on every rank, this rank's slice
    out["replicated"] = shard_tree(torch.full((3,), float(rank + 1)), replicated(mesh))
    out["data_sharding"] = shard_tree(full, data_sharding(mesh))
    return out


#: the same-window updates' algorithm: SGD, whose step is linear in the
#: gradient (Adam's normalized steps would amplify the summation order)
WINDOW_ALG = {"optimizer": "sgd"}


def _window_runner(model_parallel_size=1):
    return OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                          ppo_cfg(recurrent=True, algorithm=WINDOW_ALG, model_parallel_size=model_parallel_size),
                          device="cpu")


def save_window(out_dir) -> tuple[dict, dict]:
    """One process's first window of the GRU config, saved as
    ``chip_smoke.save_window`` saves it; returns the full state before and
    after the one-process update."""
    return chip_smoke.save_window("gru", _window_runner(), str(out_dir))


def _update_on_window(world, out_dir, model_parallel):
    """The saved window updated on this rank's layout (``chip_smoke.update_on_window``)."""
    runner = _window_runner(world if model_parallel else 1)
    return chip_smoke.update_on_window(runner, "gru", out_dir, "cpu")


def window_dp(world, out_dir=None):
    """The one-process run's first window updated on two data ranks."""
    return _update_on_window(world, out_dir, model_parallel=False)


def window_tp(world, out_dir=None):
    """The one-process run's first window updated on two model ranks."""
    return _update_on_window(world, out_dir, model_parallel=True)


def refusals(world):
    """What a two-rank layout refuses, each named: a model axis that does
    not divide the ranks, a global env count the data axis does not divide,
    a per-env episode limit of neither the shard's nor the global count,
    a fused iteration on CUDA over this Gloo group, tensor parallelism on a
    host env."""
    env = NLinkPendulum(N_GLOBAL, LINKS, device="cpu")
    cases = {
        "make_tp_mesh(3)": (ValueError, lambda: make_tp_mesh(3)),
        "model_parallel_size: 3": (ValueError, lambda: OnPolicyRunner(env, ppo_cfg(model_parallel_size=3),
                                                                      device="cpu")),
        "15 envs": (ValueError, lambda: OnPolicyRunner(NLinkPendulum(15, LINKS, device="cpu"), ppo_cfg(),
                                                       device="cpu")),
        "max_episode_length of 12 envs": (ValueError, lambda: OnPolicyRunner(
            NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=torch.arange(4, 16), device="cpu"), ppo_cfg(),
            device="cpu")),
        "fused on cuda over gloo": (ValueError, lambda: check_graph_backends(make_mesh(), torch.device("cuda"))),
        "host env, model_parallel_size: 2": (ValueError, lambda: OnPolicyRunner(
            _host_env(world), ppo_cfg(model_parallel_size=2), device="cpu")),
    }
    out = {}
    for name, (err, make) in cases.items():
        try:
            make()
            out[name] = "accepted"
        except err as e:
            out[name] = f"{type(e).__name__}: {e}"
    return {"messages": out}


def jax_parity(world, out_dir=None, model_parallel=False, inputs_file="jax_inputs.pt"):
    """PPO on a mesh with the JAX run's draws (``jax_inputs.pt``, made by the
    test from the JAX package's 2-device run): the weights and normalizers
    carried across, each iteration's global action noise and permutation
    injected, this rank's shard of the env state (with ``model_parallel``,
    one data rank whose trunks are sliced over the ranks). No episode ends
    inside the windows, so the env's own draws do not matter."""
    inputs = torch.load(os.path.join(out_dir, inputs_file), weights_only=False)
    env = NLinkPendulum(N_GLOBAL, inputs["links"], max_episode_length=inputs.get("max_episode_length", 1000),
                        device="cpu")
    mesh = None if world == 1 else make_tp_mesh(world) if model_parallel else make_mesh()
    offset, n = (0, N_GLOBAL) if mesh is None else local_slice(mesh, N_GLOBAL)
    env = env.shard(offset, n)
    state, _ = env.reset(0, num_envs=n, env_offset=offset)
    state.theta, state.omega = (inputs[k][offset:offset + n].clone() for k in ("theta", "omega"))
    state.episode_length = inputs["episode_length"][offset:offset + n].clone()
    obs = {k: v[offset:offset + n].clone() for k, v in inputs["obs"].items()}
    policy = ActorCritic(inputs["obs"], GROUPS, inputs["links"], device="cpu", **inputs["policy_kw"])
    policy.load_state_dict(inputs["state"])
    ppo = PPO(policy, **inputs["ppo_kw"])
    if mesh is not None:
        ppo.distribute(mesh)
    cs = CollectState(env_state=state, obs=obs, carry=(), stats=init_episode_stats(n, "cpu"))
    losses = []
    for it in range(len(inputs["noise"])):
        cs, rollout, cm = ppo.collect(env, cs, inputs["num_steps"], action_noise=inputs["noise"][it])
        cs, um = ppo.update(cs, rollout, perm=inputs["perm"][it])
        losses.append({k: float(v) for k, v in um.items()})
    return {"losses": losses, "state": full_state(ppo)}


def jax_parity_tp(world, out_dir=None):
    return jax_parity(world, out_dir, model_parallel=True)


def jax_parity_limits(world, out_dir=None):
    """:func:`jax_parity` on ``jax_limits_inputs.pt``: a per-env
    ``max_episode_length`` whose short limits end episodes at the last step
    of the last window (the timeout bootstrap and GAE's cut; no reset obs
    reaches the update), obs normalization off."""
    return jax_parity(world, out_dir, inputs_file="jax_limits_inputs.pt")


# ------------------------------------------------- fused iterations on the mesh

#: the runner keys of the dispatch modes, split first
DISPATCH = {"split": {}, "fused": {"fuse_iteration": True}, "k2": {"iterations_per_dispatch": 2}}
FUSED_ITERATIONS = 3


def distill_cfg(**keys) -> dict:
    """The GRU student on NLink's policy obs, its teacher the MLP of
    :func:`save_teacher`."""
    return {"num_steps_per_env": T, "save_interval": 100, "seed": 2,
            "obs_groups": {"policy": ["policy"], "teacher": ["policy"]},
            "policy": {"class_name": "StudentTeacherRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                       "student_hidden_dims": [16], "teacher_hidden_dims": [16],
                       "student_obs_normalization": True, "teacher_obs_normalization": True},
            "algorithm": {"class_name": "Distillation", "gradient_length": 3, "max_grad_norm": 1.0}, **keys}


def save_teacher(out_dir) -> str:
    """A feedforward PPO checkpoint (one process, one iteration) that
    :func:`distill_cfg`'s student loads as its teacher: ``teacher.pt``."""
    runner = OnPolicyRunner(NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu"),
                            ppo_cfg(hidden=(16,)), device="cpu")
    runner.learn(1)
    path = os.path.join(out_dir, "teacher.pt")
    runner.save(path)
    return path


def _dispatch_modes(make) -> dict:
    """``make(runner keys)`` trained split, fused and at K=2 for
    :data:`FUSED_ITERATIONS`: ``{mode: {"losses", "tensors"}}``."""
    out = {}
    for mode, keys in DISPATCH.items():
        runner = make(keys)
        runner.learn(FUSED_ITERATIONS)
        # this rank's state: under tensor parallelism its slices
        out[mode] = {"losses": [row["metrics"] for row in runner.history], "tensors": run_state(runner)}
    return out


def _nlink():
    return NLinkPendulum(N_GLOBAL, LINKS, max_episode_length=6, device="cpu")


def fused_ff(world):
    """Feedforward PPO split, fused and at K=2 on the mesh."""
    return _dispatch_modes(lambda keys: OnPolicyRunner(_nlink(), ppo_cfg(**keys), device="cpu"))


def fused_gru(world):
    """GRU PPO split, fused and at K=2 on the mesh."""
    return _dispatch_modes(lambda keys: OnPolicyRunner(_nlink(), ppo_cfg(recurrent=True, **keys), device="cpu"))


def fused_distill(world, out_dir=None):
    """The GRU student's distillation through the runner on the device env
    (``teacher.pt`` loaded), split, fused and at K=2."""
    def make(keys):
        runner = DistillationRunner(_nlink(), distill_cfg(**keys), device="cpu")
        runner.load(os.path.join(out_dir, "teacher.pt"))
        return runner

    return _dispatch_modes(make)


def fused_tp_headline(world):
    """The headline's shape cut down (bf16 trunks [16, 16, 16], fp32 heads)
    on ``world`` model ranks, split, fused and at K=2."""
    return _dispatch_modes(lambda keys: OnPolicyRunner(
        _nlink(), ppo_cfg(hidden=(16, 16, 16), dtype=torch.bfloat16, model_parallel_size=world, **keys),
        device="cpu"))


def train_state(runner) -> dict:
    """The checkpointed training state: the full policy state, the
    optimizer's moments and count, the learning rate."""
    opt = runner.alg.optimizer_state()
    return {"policy": full_state(runner.alg), "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "nu": {k: v.clone() for k, v in opt["nu"].items()}, "count": opt["count"].clone(),
            "lr": runner.alg.lr.clone()}


def fused_resume(world, out_dir=None):
    """K=2 on the mesh with a ``log_dir``: 4 iterations save ``model_1.pt``
    and ``model_3.pt`` at the groups' ends (rank 0 writes); a fresh K=2
    runner resumes from ``model_1.pt`` and trains 2 more. Returns the state
    it loaded, that of a 2-iteration K=2 run, and what the resume logged."""
    cfg = ppo_cfg(iterations_per_dispatch=2, save_interval=2)
    log_dir = os.path.join(out_dir, "resume")
    OnPolicyRunner(_nlink(), cfg, log_dir=log_dir, device="cpu").learn(4)
    two = OnPolicyRunner(_nlink(), cfg, device="cpu")
    two.learn(2)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()  # rank 0 has written the checkpoints
    resumed = OnPolicyRunner(_nlink(), cfg, device="cpu")
    resumed.load(os.path.join(log_dir, "model_1.pt"))
    loaded = train_state(resumed)
    start = resumed.current_learning_iteration
    resumed.learn(2)
    return {"loaded": loaded, "two": train_state(two), "start": start,
            "logged": [row["iteration"] for row in resumed.history], "files": sorted(os.listdir(log_dir))}


class InjectedRunner(OnPolicyRunner):
    """A runner whose fused iteration ``i`` takes the action noise and
    permutation ``draws["noise"][i]`` / ``draws["perm"][i]`` (another
    implementation's). The iteration counter is a Python int, so this runs
    only where the fused iteration runs eagerly: on the CPU."""

    draws: dict
    drawn = 0

    def _graph_step(self, cs):
        i, self.drawn = self.drawn, self.drawn + 1
        cs, rollout, cm = self.alg.collect(self.step_env, cs, self.num_steps_per_env,
                                           action_noise=self.draws["noise"][i])
        cs, um = self.alg.update(cs, rollout, perm=self.draws["perm"][i])
        return cs, {**cm, **um}


def jax_parity_fused(world, out_dir=None):
    """A fused ``OnPolicyRunner`` on the mesh with the JAX fused runner's
    start (``jax_fused_inputs.pt``, made by the test from the JAX package's
    2-device ``fuse_iteration`` runner): its weights and normalizers, this
    rank's shard of the env state and obs, each iteration's global action
    noise and permutation. No episode ends inside the windows."""
    inputs = torch.load(os.path.join(out_dir, "jax_fused_inputs.pt"), weights_only=False)
    cfg = {"num_steps_per_env": inputs["num_steps"], "save_interval": 100, "seed": 1, "obs_groups": GROUPS,
           "fuse_iteration": True, "policy": {"class_name": "ActorCritic", **inputs["policy_kw"]},
           "algorithm": {"class_name": "PPO", **inputs["ppo_kw"]}}
    runner = InjectedRunner(NLinkPendulum(N_GLOBAL, inputs["links"], max_episode_length=1000, device="cpu"), cfg,
                            device="cpu")
    runner.draws = inputs
    runner.alg.policy.load_state_dict(inputs["state"])
    offset, n = (0, N_GLOBAL) if runner.mesh is None else local_slice(runner.mesh, N_GLOBAL)
    cs = runner.collect_state
    for k in ("theta", "omega", "episode_length"):
        setattr(cs.env_state, k, inputs[k][offset:offset + n].clone())
    cs.obs = {k: v[offset:offset + n].clone() for k, v in inputs["obs"].items()}
    runner.learn(len(inputs["noise"]))
    return {"losses": [row["metrics"] for row in runner.history], "state": full_state(runner.alg)}


SCENARIOS = {f.__name__: f for f in (dp_ff, dp_gru, dp_options, dp_distill, dp_ff_odd, dp_ff_limits, host_ff,
                                     host_ff_fused, host_gru, host_distill, tp_ff, tp_ff_bf16, tp_grads_bf16, tp_gru,
                                     tp_checkpoint, collectives, refusals, jax_parity, jax_parity_tp,
                                     jax_parity_limits, jax_parity_fused, window_dp, window_tp, fused_ff, fused_gru,
                                     fused_distill, fused_tp_headline, fused_resume)}
#: the scenarios that read or write files in the run's directory
NEEDS_DIR = ("tp_checkpoint", "jax_parity", "jax_parity_tp", "window_dp", "window_tp", "fused_distill",
             "fused_resume", "jax_parity_fused", "jax_parity_limits")


def run_scenario(name: str, world: int, out_dir: str) -> dict:
    fn = SCENARIOS[name]
    return fn(world, out_dir) if name in NEEDS_DIR else fn(world)


def spawn(out_dir: str, names: list[str], world: int = 2, timeout: float = 240) -> dict:
    """Run the scenarios ``names`` on ``world`` Gloo ranks (one process each,
    the rendezvous a file in ``out_dir``); returns ``{name: [result of rank
    r, ...]}``. Raises with every rank's output when one fails."""
    init_file = os.path.join(out_dir, "rendezvous")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), init_file, out_dir, *names],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-4000:]}"
                                                            for r, (p, o) in enumerate(zip(procs, outs))))
    return {name: [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"), weights_only=False)
                   for r in range(world)] for name in names}


def main() -> None:
    rank, world, init_file, out_dir, *names = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert distributed_init(backend="gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    for name in names:
        result = run_scenario(name, world, out_dir)
        torch.save(result, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        print(json.dumps({"scenario": name, "rank": rank, "ok": True}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
