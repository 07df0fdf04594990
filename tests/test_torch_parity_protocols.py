"""The port's learning-quality studies stay true to their JAX protocols.

- ``parity_torch.py``'s studies ``e``, ``f`` and ``f_rec`` use the JAX
  scripts' own configs (``benchmarks/parity_pendulum.py::train_cfg(seed,
  True)``, ``benchmarks/parity_distillation.py::distill_cfg`` in both forms),
  key by key; the port adds ``fuse_iteration`` and drops the JAX scripts'
  ``logger`` (the studies write no logs).
- ``convergence_torch.py``'s policies and algorithm are those that
  ``bench.py::_build`` builds (with ``noise_std_floor=0.01``), attribute by
  attribute, on the same env, T and width.
- ``--seed-offset 40`` runs seeds 41-80 and stores the study apart;
  ``--pool`` joins two stored sets.
- Each committed JAX teacher (``parity_teachers/``), read by the port as the
  studies read it (``import_torch_checkpoint`` into the teacher's
  ``ActorCritic``, then the ``actor -> teacher`` remap) and by the JAX
  package's ``import_torch_checkpoint``, gives the same actions on the same
  observations (atol 1e-5: fp32 in another summation order).
- Two iterations of every new study at 64 envs on the CPU give finite
  curves (the envs' episodes cut to one window so that each iteration
  completes some).
- ``chip_smoke.py`` phase 3 holds the kernels at every shape a study's
  iteration replays (``STUDY_CONFIG_SHAPES``), recorded on the CPU.
- The port's initial MLP weights follow the JAX package's distributions,
  layer by layer at the parity config's widths (obs 15, [128, 128], 5
  actions), with the default init (through ``ActorCritic``, as the studies
  build it) and the orthogonal init: a two-sample Kolmogorov-Smirnov test
  over 4 seeds a side, p >= 1e-3 for every layer's weights and biases.
"""

import ast
import json
import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import convergence_torch  # noqa: E402
import parity_torch  # noqa: E402
from benchmarks import parity_distillation, parity_pendulum  # noqa: E402
from rsl_rl_tpu.env import NLinkPendulum as JaxNLink  # noqa: E402
from rsl_rl_tpu.env import PartiallyObservableNLink as JaxPONLink  # noqa: E402
from rsl_rl_tpu.modules import ActorCritic as JaxActorCritic  # noqa: E402
from rsl_rl_tpu.networks.mlp import MLP as JaxMLP  # noqa: E402
from rsl_rl_tpu.utils.torch_deploy import import_torch_checkpoint as jax_import_torch_checkpoint  # noqa: E402
from rsl_rl_tpu_torch.modules import ActorCritic  # noqa: E402
from rsl_rl_tpu_torch.networks.mlp import MLP  # noqa: E402
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn  # noqa: E402

#: the keys only one side has: the port's graphed iterations, the JAX
#: scripts' log writer
PORT_ONLY, JAX_ONLY = {"fuse_iteration"}, {"logger"}
NUM_ENVS = 64
KS_P = 1e-3


def _without(cfg: dict, keys: set) -> dict:
    return {k: v for k, v in cfg.items() if k not in keys}


@pytest.mark.parametrize("study,port,jax_", [
    ("e", lambda s: parity_torch.train_cfg(s, recurrent=True), lambda s: parity_pendulum.train_cfg(s, True)),
    ("f", lambda s: parity_torch.distill_cfg(s), lambda s: parity_distillation.distill_cfg(s)),
    ("f_rec", lambda s: parity_torch.distill_cfg(s, True), lambda s: parity_distillation.distill_cfg(s, True)),
])
def test_study_config_is_the_jax_scripts(study, port, jax_):
    for seed in (1, 41):
        got, want = port(seed), jax_(seed)
        assert set(got) - set(want) == PORT_ONLY and set(want) - set(got) == JAX_ONLY
        assert got["fuse_iteration"] is True
        assert _without(got, PORT_ONLY) == _without(want, JAX_ONLY)


def _port_policy_attrs(policy) -> dict:
    def dims(mlp):
        return [getattr(mlp, f"dense_{i}").out_features for i in range(mlp.num_linear - 1)]

    attrs = {"class": type(policy).__name__, "actor_hidden_dims": dims(policy.actor),
             "critic_hidden_dims": dims(policy.critic), "actor_obs_normalization": policy.norm_actor is not None,
             "critic_obs_normalization": policy.norm_critic is not None, "noise_std_floor": policy.noise_std_floor,
             "noise_std_type": policy.noise_std_type, "state_dependent_std": policy.state_dependent_std,
             "init_std": float(policy.std.detach()[0]), "bf16": policy.dtype == torch.bfloat16,
             "head_fp32": policy.actor.head_dtype == torch.float32 if policy.dtype is not None else None}
    if hasattr(policy, "memory_a"):
        attrs.update(rnn_type=policy.rnn_type, rnn_hidden_dim=policy.rnn_hidden_dim,
                     rnn_num_layers=policy.rnn_num_layers)
    return attrs


def _jax_policy_attrs(policy) -> dict:
    attrs = {"class": type(policy).__name__, "actor_hidden_dims": list(policy.actor.hidden_dims),
             "critic_hidden_dims": list(policy.critic.hidden_dims),
             "actor_obs_normalization": policy.actor_obs_normalization,
             "critic_obs_normalization": policy.critic_obs_normalization, "noise_std_floor": policy.noise_std_floor,
             "noise_std_type": policy.noise_std_type, "state_dependent_std": policy.state_dependent_std,
             "init_std": float(policy.init_noise_std), "bf16": policy.actor.dtype == jnp.bfloat16,
             "head_fp32": policy.actor.head_dtype == jnp.float32 if policy.actor.dtype is not None else None}
    if hasattr(policy, "memory_a"):
        attrs.update(rnn_type=policy.rnn_type, rnn_hidden_dim=policy.rnn_hidden_dim,
                     rnn_num_layers=policy.rnn_num_layers)
    return attrs


PPO_ATTRS = ("num_learning_epochs", "num_mini_batches", "clip_param", "gamma", "lam", "value_loss_coef",
             "entropy_coef", "learning_rate", "max_grad_norm", "use_clipped_value_loss", "schedule", "desired_kl",
             "normalize_advantage_per_mini_batch", "min_lr", "max_lr")


@pytest.mark.parametrize("study", list(convergence_torch.STUDIES))
def test_convergence_config_is_bench_build(study):
    """The runner ``convergence_torch.py`` builds against ``bench._build``
    (as ``benchmarks/convergence_tpu.py`` calls it, ``--std-floor 0.01``),
    at 64 envs: policy, PPO hyperparameters, env, T."""
    jax_file, env_name, memory, bf16, iterations = convergence_torch.STUDIES[study]
    with open(ROOT / "benchmarks" / "results" / jax_file) as f:
        ref = json.load(f)
    assert ref["noise_std_floor"] == convergence_torch.STD_FLOOR and ref["iterations"] == iterations
    assert ref["workload"].startswith(f"ppo_{memory}_4096envs" if memory != "ff" else "ppo_4096envs_nlink5_bf16")
    jenv = {"po_nlink": JaxPONLink, "nlink": JaxNLink}[env_name](num_envs=NUM_ENVS, num_links=5)
    ppo, _, _ = bench._build(jenv, recurrent=False if memory == "ff" else memory,
                             dtype=jnp.bfloat16 if bf16 else None, noise_std_floor=convergence_torch.STD_FLOOR)
    runner = convergence_torch.make_runner(study, 1, "cpu", NUM_ENVS)
    assert _port_policy_attrs(runner.alg.policy) == _jax_policy_attrs(ppo.policy)
    assert {k: getattr(runner.alg, k) for k in PPO_ATTRS} == {k: getattr(ppo, k) for k in PPO_ATTRS}
    assert type(runner.env).__name__ == type(jenv).__name__
    assert (runner.env.num_links, runner.env.max_episode_length) == (jenv.num_links, jenv.max_episode_length)
    assert runner.num_steps_per_env == bench.NUM_STEPS and convergence_torch.NUM_ENVS == bench.NUM_ENVS


def test_convergence_final_is_the_last_100_non_nan_points():
    curve = np.full(300, np.nan)
    curve[150] = -1000.0  # outside the window
    curve[[210, 250, 299]] = [-30.0, -60.0, -90.0]
    assert convergence_torch.final(curve) == -60.0


class _Runner:
    """A runner that records its seed and reports the seed as its reward."""

    seeds: list = []

    def __init__(self, seed):
        self.seed = seed
        _Runner.seeds.append(seed)

    def learn(self, iterations):
        self.history = [{"metrics": {"ep_count": 1.0, "ep_reward_sum": -float(self.seed)}}] * iterations


def test_seed_offset_runs_seeds_41_to_80(monkeypatch):
    _Runner.seeds = []
    monkeypatch.setattr(parity_torch, "study_runner", lambda name, seed, device: _Runner(seed))
    curves = parity_torch.run_study("b40_single", 3, "cpu", seed_offset=40)
    assert _Runner.seeds == list(range(41, 81))
    np.testing.assert_array_equal(curves[:, -1], -np.arange(41, 81))


def test_seed_offset_stores_the_second_set_apart_and_pools(monkeypatch, tmp_path, capsys):
    out = tmp_path / "results.json"
    first = {"description": "b40_single", "jax_file": ["x"], "iterations": 3, "seeds": 40, "reward_key": "r",
             "scattered_episode_clocks": False, "window_iters": 20, "card": "c", "wall_s": 1.0,
             "port": parity_torch.band(-np.arange(1.0, 41.0)), "jax": parity_torch.band(-np.arange(1.0, 41.0)),
             "welch_t_p": 1.0, "mann_whitney_u_p": 1.0, "checkpoints": {"port": [], "jax": []},
             "curves": [[-float(s)] * 3 for s in range(1, 41)]}
    out.write_text(json.dumps({"studies": {"b40_single": first}}))
    _Runner.seeds = []
    monkeypatch.setattr(parity_torch, "study_runner", lambda name, seed, device: _Runner(seed))
    monkeypatch.setattr(parity_torch, "jax_finals", lambda path, name=None: (-np.arange(1.0, 41.0), []))
    monkeypatch.setattr(sys, "argv", ["parity_torch.py", "--studies", "b40_single", "--seed-offset", "40",
                                      "--iterations", "3", "--device", "cpu", "--out", str(out)])
    parity_torch.main()
    studies = json.loads(out.read_text())["studies"]
    assert set(studies) == {"b40_single", "b40_single_s41"}
    assert studies["b40_single_s41"]["seed_list"] == list(range(41, 81))
    assert studies["b40_single_s41"]["port"]["per_seed"] == [-float(s) for s in range(41, 81)]
    studies["b40_single_s41"]["jax_file"] = ["x"]
    out.write_text(json.dumps({"studies": studies}))
    monkeypatch.setattr(sys, "argv", ["parity_torch.py", "--pool", "b40_single", "b40_single_s41",
                                      "--as", "b80_single", "--out", str(out)])
    parity_torch.main()
    pooled = json.loads(out.read_text())["studies"]["b80_single"]
    assert pooled["seeds"] == 80 and pooled["seed_list"] == list(range(1, 81))
    assert pooled["port"]["per_seed"] == [-float(s) for s in range(1, 81)]
    assert "study b80_single" in capsys.readouterr().out


def _teacher_obs(recurrent: bool, n: int = 256) -> dict:
    rng = np.random.default_rng(11 + recurrent)
    theta = rng.uniform(-math.pi, math.pi, n)
    full = np.stack([np.cos(theta), np.sin(theta), rng.uniform(-8.0, 8.0, n)], -1).astype(np.float32)
    return {"policy": full[:, :2], "privileged": full} if recurrent else {"policy": full}


@pytest.mark.parametrize("study", list(parity_torch.DISTILL_STUDIES))
def test_committed_teacher_acts_as_the_jax_import(study):
    recurrent = parity_torch.DISTILL_STUDIES[study][0]
    path = os.path.join(parity_torch.TEACHERS, parity_torch.TEACHER_FILES[recurrent])
    obs = _teacher_obs(recurrent)
    runner = parity_torch.study_runner(study, 1, "cpu")
    student = runner.alg.policy
    assert student.loaded_teacher
    with torch.no_grad():
        got, _ = student.evaluate({k: torch.from_numpy(v) for k, v in obs.items()},
                                  student.initial_carry(len(obs["policy"])))
    group = "privileged" if recurrent else "policy"
    cfg = {k: v for k, v in parity_pendulum.train_cfg(0)["policy"].items() if k != "class_name"}
    jpolicy = JaxActorCritic({"policy": jnp.asarray(obs[group])}, {"policy": ["policy"], "critic": ["policy"]},
                             1, **cfg)
    ps, _ = jax_import_torch_checkpoint(jpolicy, jpolicy.init(jax.random.PRNGKey(0)), path)
    want, _ = jpolicy.act_inference(ps, {"policy": jnp.asarray(obs[group])}, ())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the teacher is trained: its normalizer holds the teacher run's moments
    assert float(student.norm_teacher.count) > 1.0


def _short_episodes(runner, length: int = 24):
    """Cut the envs' episodes to one window, so every iteration completes some."""
    runner.env.max_episode_length = length
    return runner


REHEARSALS = {
    **{name: (lambda name=name: parity_torch.study_runner(name, 1, "cpu")) for name in ("e", "f", "f_rec")},
    **{name: (lambda name=name: convergence_torch.make_runner(name, 1, "cpu", NUM_ENVS))
       for name in convergence_torch.STUDIES},
}


@pytest.mark.parametrize("study", list(REHEARSALS))
def test_two_iteration_rehearsal_gives_finite_curves(study):
    torch.set_num_threads(2)
    runner = _short_episodes(REHEARSALS[study]())
    parity_torch.quiet_learn(runner, 2)
    curve = [float(parity_torch.curve_point(h["metrics"], "ep_reward_sum")) for h in runner.history]
    assert len(curve) == 2 and all(math.isfinite(v) for v in curve), curve
    assert all(math.isfinite(v) for h in runner.history for v in h["metrics"].values())


@pytest.mark.parametrize("label", list(chip_smoke.STUDY_CONFIG_SHAPES))
def test_smoke_holds_each_studys_kernel_shapes(label, monkeypatch):
    """Every x-kernel shape a study's iteration replays is the one
    ``chip_smoke.py`` phase 3 holds against the plain version: the plain
    forwards record (family, S, T, B, D, H, bf16) over one CPU iteration, the
    flagships' B scaled from 4096 envs to the rehearsal's."""
    torch.set_num_threads(2)
    seen = set()
    # each plain forward's name and the places of its wh [S, H, G H] and xs
    for family, module, name, wh in (("gru", gru_rnn, "gru_x_plain_fwd", 2), ("lstm", lstm_rnn, "lstm_x_plain_fwd", 1)):
        def record(*args, family=family, fwd=getattr(module, name), wh=wh):
            S, T, B, D = args[5].shape
            seen.add((family, S, T, B, D, args[wh].shape[-2], bool(args[-1])))
            return fwd(*args)
        monkeypatch.setattr(module, name, record)
    runner = _short_episodes(REHEARSALS[label.split("_", 1)[1]]())
    parity_torch.quiet_learn(runner, 1)
    family, S, T, B, D, H, bf16 = chip_smoke.STUDY_CONFIG_SHAPES[label]
    if label.startswith("convergence_"):
        B = B * NUM_ENVS // convergence_torch.NUM_ENVS
    assert seen == {(family, S, T, B, D, H, bf16)}


def _ks(port: dict, jax_: dict) -> dict:
    """Per layer and part, the KS p-value of the pooled port draws against
    the pooled JAX draws."""
    return {k: float(stats.ks_2samp(np.concatenate(port[k]), np.concatenate(jax_[k])).pvalue) for k in port}


def _collect(into: dict, key: str, value) -> None:
    into.setdefault(key, []).append(np.asarray(value, np.float64).ravel())


def test_default_init_matches_jax_in_distribution():
    """``ActorCritic`` at the feedforward parity config (obs 15, [128, 128],
    5 actions): the port's actor and critic layers, drawn from one generator
    seeded as the runner seeds it, against the JAX package's per-layer draws."""
    obs_np = np.zeros((4, 15), np.float32)
    groups = {"policy": ["policy"], "critic": ["policy"]}
    port, jax_ = {}, {}
    for seed in range(1, 5):
        policy = ActorCritic({"policy": torch.from_numpy(obs_np)}, groups, 5, device="cpu", seed=seed,
                             actor_hidden_dims=[128, 128], critic_hidden_dims=[128, 128])
        params = JaxActorCritic({"policy": jnp.asarray(obs_np)}, groups, 5, actor_hidden_dims=[128, 128],
                                critic_hidden_dims=[128, 128]).init(jax.random.PRNGKey(seed)).params
        for net in ("actor", "critic"):
            mlp = getattr(policy, net)
            for i in range(mlp.num_linear):
                layer = getattr(mlp, f"dense_{i}")
                _collect(port, f"{net}.dense_{i}.weight", layer.weight.detach())
                _collect(port, f"{net}.dense_{i}.bias", layer.bias.detach())
                _collect(jax_, f"{net}.dense_{i}.weight", params[net][f"dense_{i}"]["kernel"])
                _collect(jax_, f"{net}.dense_{i}.bias", params[net][f"dense_{i}"]["bias"])
    pvalues = _ks(port, jax_)
    assert len(pvalues) == 12 and min(pvalues.values()) >= KS_P, pvalues


def test_orthogonal_init_matches_jax_in_distribution():
    """``init_scales`` (orthogonal weights with a gain a layer, zero biases)
    at the same widths."""
    gains = [math.sqrt(2.0), math.sqrt(2.0), 0.01]
    port, jax_ = {}, {}
    for seed in range(1, 5):
        mlp = MLP(15, 5, [128, 128], "elu", torch.Generator().manual_seed(seed), init_scales=gains)
        params = JaxMLP(output_dim=5, hidden_dims=[128, 128], init_scales=gains).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 15)))["params"]
        for i in range(3):
            layer = getattr(mlp, f"dense_{i}")
            _collect(port, f"dense_{i}.weight", layer.weight.detach())
            _collect(jax_, f"dense_{i}.weight", params[f"dense_{i}"]["kernel"])
            assert not layer.bias.detach().any() and not np.asarray(params[f"dense_{i}"]["bias"]).any()
    pvalues = _ks(port, jax_)
    assert len(pvalues) == 3 and min(pvalues.values()) >= KS_P, pvalues


def test_study_scripts_import_no_jax():
    """The card's scripts stand alone (``parity_torch.py`` is held by
    ``tests/test_torch_port_isolation.py``)."""
    tree = ast.parse((ROOT / "convergence_torch.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "rsl_rl_tpu")}
