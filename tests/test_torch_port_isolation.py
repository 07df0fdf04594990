"""The port stands alone: no module of ``rsl_rl_tpu_torch`` (nor
``chip_smoke.py``, ``parity_torch.py``, ``parallel_drift.py`` or the port's
examples ``examples/*_torch.py``) imports JAX, flax, optax or the JAX package, nothing
of it needs ``yaml`` until a config file is loaded nor ``mujoco`` or
``gymnasium`` until a host env is built, and its entry points run on CUDA
unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rsl_rl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rsl_rl_tpu")
EXAMPLES = ["train_pendulum_torch", "train_mujoco_host_torch", "play_torch", "train_multihost_torch", "train_mjx_torch"]
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "parity_torch.py", ROOT / "parallel_drift.py"] + [
    ROOT / "examples" / f"{e}.py" for e in EXAMPLES]
SOURCES = sorted(PORT.rglob("*.py")) + SCRIPTS


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("blocked", [FORBIDDEN, FORBIDDEN + ("yaml",), FORBIDDEN + ("mujoco", "gymnasium")],
                         ids=["jax", "jax_and_yaml", "jax_mujoco_gymnasium"])
def test_package_imports_with_jax_blocked(blocked):
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke', 'parity_torch', 'parallel_drift'] + {['examples.' + e for e in EXAMPLES]!r}:\n"
        "    importlib.import_module(m)\n"
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {blocked!r} and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_require_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from rsl_rl_tpu_torch.env import NLinkPendulum
    from rsl_rl_tpu_torch.runners import OnPolicyRunner

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NLinkPendulum(8)
    env = NLinkPendulum(8, device="cpu")
    cfg = {
        "num_steps_per_env": 2,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                   "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
        "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2},
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnPolicyRunner(env, cfg)
    runner = OnPolicyRunner(env, cfg, device="cpu")
    runner.learn(1, init_at_random_ep_len=True)
    assert runner.history and all(
        torch.isfinite(torch.tensor(v)) for v in runner.history[0]["metrics"].values()
    )


def test_study_entry_points_require_cuda_unless_cpu_is_asked():
    """``make_pbt_train`` and the study's evaluation follow the rule too: a
    CPU tensor only where the caller asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from rsl_rl_tpu_torch.env import Pendulum
    from rsl_rl_tpu_torch.runners import MultiSeedRunner, make_pbt_train

    cfg = {"num_steps_per_env": 2, "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
           "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2}}
    env = Pendulum(4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiSeedRunner(env, cfg, 2, pbt={"exploit_fraction": 0.5})
    runner = MultiSeedRunner(env, cfg, 2, device="cpu", pbt={"exploit_fraction": 0.5})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_pbt_train(runner.alg, env, 2, 2)
    runner.learn(1)
    assert runner.pbt_state.fitness.device.type == "cpu"


@pytest.mark.parametrize("env", ["CartPoleSwingUp", "Reacher", "Hopper", "SparseGoalReach"])
def test_new_envs_require_cuda_unless_cpu_is_asked(env):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from rsl_rl_tpu_torch.utils.registry import resolve

    cls = resolve("env", env)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(8)
    state, obs = cls(8, device="cpu").reset(0)
    assert all(v.device.type == "cpu" for v in obs.values())


def test_host_env_runner_requires_cuda_unless_cpu_is_asked():
    """A host env has no device: the runner's own device rule decides."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    import numpy as np

    from rsl_rl_tpu_torch.env import HostVecEnv
    from rsl_rl_tpu_torch.runners import OnPolicyRunner

    class Env(HostVecEnv):
        num_envs, num_actions, max_episode_length = 4, 1, 10

        def reset(self, seed=None):
            return {"policy": np.zeros((4, 2), np.float32)}

        def step(self, actions):
            return self.reset(), np.zeros(4, np.float32), np.zeros(4, bool), {}

    cfg = {"num_steps_per_env": 2, "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
           "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnPolicyRunner(Env(), cfg)
    runner = OnPolicyRunner(Env(), cfg, device="cpu")
    runner.learn(1)
    assert runner.collect_state.obs["policy"].device.type == "cpu"
