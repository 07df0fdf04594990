"""The port's ``split_and_pad_trajectories`` / ``unpad_trajectories``
against the JAX package's on the same inputs, exactly: the four cases of
``tests/test_trajectories.py`` (the reference docstring's example, a round
trip, a dict of tensors, and the static shapes of the padded output)."""

import jax.numpy as jnp
import numpy as np
import torch

from rsl_rl_tpu.utils.trajectories import split_and_pad_trajectories as jax_split
from rsl_rl_tpu.utils.trajectories import unpad_trajectories as jax_unpad
from rsl_rl_tpu_torch.utils.trajectories import split_and_pad_trajectories, unpad_trajectories


def _both(x, dones):
    """The port's and the JAX package's split of the same numpy inputs."""
    port = split_and_pad_trajectories({k: torch.tensor(v) for k, v in x.items()} if isinstance(x, dict)
                                      else torch.tensor(x), torch.tensor(dones))
    jax_ = jax_split({k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x),
                     jnp.asarray(dones))
    return port, jax_


def _equal(got, want):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _equal(got[k], want[k])
        return
    assert tuple(got.shape) == tuple(np.shape(want)) and got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_docstring_example():
    """Two envs, T=6: env a done after step 4, env b after steps 2 and 5."""
    vals = np.arange(1, 13, dtype=np.float32).reshape(2, 6).T[..., None]  # [T, N, 1]
    dones = np.zeros((6, 2), bool)
    dones[3, 0] = dones[1, 1] = dones[4, 1] = True
    (padded, mask), (jpadded, jmask) = _both(vals, dones)
    _equal(padded, jpadded)
    _equal(mask, jmask)
    want_cols = [[1, 2, 3, 4, 0, 0], [5, 6, 0, 0, 0, 0], [7, 8, 0, 0, 0, 0], [9, 10, 11, 0, 0, 0],
                 [12, 0, 0, 0, 0, 0]]
    for j, col in enumerate(want_cols):
        np.testing.assert_array_equal(padded[:, j, 0].numpy(), col)
        np.testing.assert_array_equal(mask[:, j].numpy(), np.asarray(col) != 0)
    assert not mask[:, len(want_cols):].any()


def test_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 5, 3)).astype(np.float32)
    dones = rng.random((12, 5)) < 0.2
    (padded, mask), (jpadded, jmask) = _both(x, dones)
    _equal(padded, jpadded)
    _equal(mask, jmask)
    back = unpad_trajectories(padded, mask)
    _equal(back, jax_unpad(jpadded, jmask))
    np.testing.assert_array_equal(back.numpy(), x)


def test_dict_input():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(8, 3, 2)).astype(np.float32), "b": rng.normal(size=(8, 3, 4)).astype(np.float32)}
    dones = rng.random((8, 3)) < 0.25
    (padded, mask), (jpadded, jmask) = _both(tree, dones)
    _equal(padded, jpadded)
    _equal(mask, jmask)
    back = unpad_trajectories(padded, mask)
    _equal(back, jax_unpad(jpadded, jmask))
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_static_shapes():
    T, N = 6, 4
    dones = np.zeros((T, N), bool)
    dones[2, 1] = True
    (padded, mask), (jpadded, jmask) = _both(np.ones((T, N, 2), np.float32), dones)
    assert padded.shape == (T, N * T, 2)
    assert int(mask.sum()) == T * N
    _equal(padded, jpadded)
    _equal(mask, jmask)
