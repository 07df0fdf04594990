"""The port stands alone: no module of ``rsl_rl_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rsl_rl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rsl_rl_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r} and sys.modules[m] is not None]\n"
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
