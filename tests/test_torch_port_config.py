"""The port's config loading (``utils/config.py``) against the JAX
package's ``load_train_cfg``, and a CPU run of the port's Pendulum example
(``examples/train_pendulum_torch.py``)."""

import importlib.util
from pathlib import Path

import pytest
import yaml

from rsl_rl_tpu.utils.config import load_train_cfg as jax_load_train_cfg
from rsl_rl_tpu_torch.utils.config import load_train_cfg

ROOT = Path(__file__).resolve().parents[1]
RUNNER = {"num_steps_per_env": 24, "max_iterations": 3, "seed": 2,
          "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [8]},
          "algorithm": {"class_name": "PPO", "learning_rate": 1.0e-3}}


@pytest.mark.parametrize("layout", ["runner_block", "root_keys"])
def test_load_train_cfg_matches_jax(tmp_path, layout):
    """Both layouts give the runner dict the JAX loader gives: the keys of a
    top-level ``runner:`` block, or the root keys."""
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"runner": RUNNER, "env": {"num_envs": 8}} if layout == "runner_block"
                                   else RUNNER))
    got = load_train_cfg(str(path))
    assert got == jax_load_train_cfg(str(path)) == RUNNER


def test_repo_example_config_loads():
    path = str(ROOT / "config" / "example_config.yaml")
    assert load_train_cfg(path) == jax_load_train_cfg(path)


@pytest.mark.parametrize("text", ["- a\n- b\n", "just a string\n", ""], ids=["list", "scalar", "empty"])
def test_load_train_cfg_refuses_a_non_mapping(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match="did not parse to a mapping"):
        load_train_cfg(str(path))


def _example():
    spec = importlib.util.spec_from_file_location("train_pendulum_torch", ROOT / "examples" / "train_pendulum_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pendulum_example_on_the_cpu(tmp_path):
    """The example trains on the CPU when asked (2 iterations of 8 envs),
    writes its checkpoint to ``--log-dir`` and resumes from it."""
    example = _example()
    runner = example.main(["--device", "cpu", "--num-envs", "8", "--iterations", "2", "--log-dir", str(tmp_path)])
    assert len(runner.history) == 2 and runner.current_learning_iteration == 1
    assert (tmp_path / "model_1.pt").exists()
    resumed = example.main(["--device", "cpu", "--num-envs", "8", "--iterations", "1", "--log-dir", str(tmp_path),
                            "--resume"])
    # the checkpoint holds the last iteration's index, where the resumed run continues (as in JAX)
    assert [h["iteration"] for h in resumed.history] == [1]
    assert example.train_cfg(1)["policy"]["actor_hidden_dims"] == [256, 256, 256]
