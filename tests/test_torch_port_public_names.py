"""The port's public names are the JAX package's: each subpackage's
``__all__`` equals the JAX one's, less the functional state types that the
port's stateful modules replace and plus the port's own additions, and every
name imports. ``denormalize`` and ``registered`` against the JAX functions."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsl_rl_tpu
import rsl_rl_tpu_torch
from rsl_rl_tpu.ops.running_norm import denormalize as jax_denormalize
from rsl_rl_tpu.ops.running_norm import init_running_norm, update_running_norm as jax_update
from rsl_rl_tpu_torch.ops import RunningNormState, denormalize, normalize, update_running_norm
from rsl_rl_tpu_torch.utils import registered

#: subpackage -> (JAX names the port leaves out, the port's own names)
DIFFERENCES = {
    "": (set(), {"resolve_device"}),
    "algorithms": ({"TrainState"}, set()),
    "env": (set(), set()),
    "modules": ({"PolicyState", "RNDState"}, set()),
    "networks": (set(), set()),
    "ops": ({"init_running_norm", "init_discounted_variation_norm"}, set()),
    "parallel": (set(), {"Mesh", "HostShardingBridge", "converters", "global_sum", "global_mean",
                         "gather_tree_tp"}),
    "runners": (set(), {"PBTState", "make_multiseed_train"}),
    "storage": (set(), set()),
    "utils": (set(), set()),
}


@pytest.mark.parametrize("sub", sorted(DIFFERENCES), ids=lambda s: s or "top")
def test_port_exports_the_jax_names(sub):
    jax_mod = importlib.import_module("rsl_rl_tpu" + (f".{sub}" if sub else ""))
    port_mod = importlib.import_module("rsl_rl_tpu_torch" + (f".{sub}" if sub else ""))
    left_out, added = DIFFERENCES[sub]
    assert left_out <= set(jax_mod.__all__)
    assert set(port_mod.__all__) == set(jax_mod.__all__) - left_out | added
    assert len(port_mod.__all__) == len(set(port_mod.__all__))
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None, name


def test_version_and_subpackages():
    assert rsl_rl_tpu_torch.__version__ == rsl_rl_tpu.__version__
    from rsl_rl_tpu_torch.networks import MLP, Memory, mask_carry, memory_sequence  # noqa: F401


def test_denormalize_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(1.5, 3.0, size=(64, 5)).astype(np.float32)
    y = rng.normal(size=(7, 5)).astype(np.float32)
    jax_state = jax_update(init_running_norm(5), jnp.asarray(x))
    state = update_running_norm(RunningNormState(5), torch.from_numpy(x))
    np.testing.assert_allclose(denormalize(state, torch.from_numpy(y)).numpy(),
                               np.asarray(jax_denormalize(jax_state, jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(denormalize(state, normalize(state, torch.from_numpy(x))).numpy(), x, atol=1e-5)


def test_registered_is_a_copy_holding_the_adapters():
    envs = registered("env")
    assert {"MJXEnv", "BraxVecEnv", "NLinkPendulum"} <= set(envs)
    envs.pop("MJXEnv")
    assert "MJXEnv" in registered("env")
    assert registered("no such kind") == {}
