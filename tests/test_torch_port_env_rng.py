"""The port's ``NLinkPendulum`` carries its random draws in the state (per-env
keys, as the JAX env's ``NLinkState.rng``): ``step(state, a)`` is a function
of its arguments, the rows of a stacked state step as the state made of them,
and the reset draws are uniform in their ranges. No JAX: the draws differ
from the JAX env's threefry by construction."""

import numpy as np
import pytest
import torch

from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, NLinkPendulum, NLinkState, env_keys, hash_draws

N, L = 32, 5


def _state_rows(state: NLinkState, rows: slice) -> NLinkState:
    return NLinkState(**{k: v[rows] for k, v in vars(state).items()})


def _step_all_reset(env, state, actions):
    """Step with every env one step before its limit, so every env resets."""
    state = NLinkState(**{**vars(state), "episode_length": torch.full_like(state.episode_length,
                                                                           env.max_episode_length - 1)})
    return env.step(state, actions)


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            _assert_same(list(x.values()), list(y.values()))
        elif isinstance(x, NLinkState):
            _assert_same(list(vars(x).values()), list(vars(y).values()))
        else:
            assert torch.equal(x, y)


def test_step_twice_from_one_state_is_identical():
    env = NLinkPendulum(N, L, max_episode_length=3, device="cpu")
    state, _ = env.reset(5)
    actions = torch.randn(N, L, generator=torch.Generator().manual_seed(0))
    first = _step_all_reset(env, state, actions)
    second = _step_all_reset(env, state, actions)
    _assert_same(first, second)
    assert not torch.equal(first[0].rng, state.rng), "the keys advance"


def test_step_reads_no_generator_of_the_env(monkeypatch):
    """The env object holds no random state, and a fresh env object that was
    never reset steps a state exactly as the one that made it; no torch
    sampler is called during a step."""
    env = NLinkPendulum(N, L, max_episode_length=3, device="cpu")
    assert not any(isinstance(v, torch.Generator) for v in vars(env).values())
    state, _ = env.reset(5)
    actions = torch.randn(N, L, generator=torch.Generator().manual_seed(1))
    want = _step_all_reset(env, state, actions)

    def refuse(*args, **kwargs):
        raise AssertionError("step drew from a torch sampler")

    for name in ("rand", "randn", "randint", "rand_like", "randn_like", "randint_like", "multinomial",
                 "normal", "bernoulli"):
        monkeypatch.setattr(torch, name, refuse)
    got = _step_all_reset(NLinkPendulum(N, L, max_episode_length=3, device="cpu"), state, actions)
    _assert_same(got, want)


def test_stacked_rows_step_as_their_own_state():
    """Rows ``i*N:(i+1)*N`` of a stacked state (G seeds' envs) step exactly
    as the state made of those rows: values, resets and keys."""
    G = 3
    env = NLinkPendulum(N, L, max_episode_length=2, device="cpu")
    state, _ = env.reset(7, num_envs=G * N)
    actions = torch.randn(G * N, L, generator=torch.Generator().manual_seed(2))
    state.episode_length[::2] = 1  # half the envs reset this step
    full = env.step(state, actions)
    for i in range(G):
        rows = slice(i * N, (i + 1) * N)
        part = env.step(_state_rows(state, rows), actions[rows])
        want = (_state_rows(full[0], rows), {k: v[rows] for k, v in full[1].items()}, full[2][rows], full[3][rows])
        _assert_same(part[:4], want)


def test_two_seeds_reset_differently():
    env = NLinkPendulum(N, L, device="cpu")
    a, _ = env.reset(0)
    b, _ = env.reset(1)
    assert not torch.equal(a.theta, b.theta) and not torch.equal(a.omega, b.omega)
    assert not torch.equal(a.rng, b.rng)
    c, _ = env.reset(0)
    assert torch.equal(a.theta, c.theta) and torch.equal(a.rng, c.rng)


@pytest.mark.parametrize("name,low,high", [("theta", -0.1, 0.1), ("omega", -0.05, 0.05)])
def test_reset_draws_are_uniform(name, low, high):
    """10^5 draws lie in ``[low, high)``, their mean and variance within 3
    sigma of the uniform distribution's."""
    env = NLinkPendulum(20_000, L, device="cpu")
    state, _ = env.reset(11)
    x = getattr(state, name).double().flatten().numpy()
    n = x.size
    assert n == 100_000
    assert x.min() >= low and x.max() < high
    width = high - low
    var = width**2 / 12
    assert abs(x.mean() - (low + high) / 2) < 3 * np.sqrt(var / n)
    var_sd = np.sqrt(width**4 * (1 / 80 - 1 / 144) / n)  # sd of the sample variance
    assert abs(x.var() - var) < 3 * var_sd


def test_hash_draws_match_splitmix64():
    """The int64 arithmetic wraps as 64-bit unsigned arithmetic does: the
    draws equal a plain-Python splitmix64 over the same keys and counters."""
    golden, m1, m2, mask = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 2**64 - 1

    def mix(z):
        z = ((z ^ (z >> 30)) * m1) & mask
        z = ((z ^ (z >> 27)) * m2) & mask
        return z ^ (z >> 31)

    keys = env_keys(3, 4)
    nxt, bits = hash_draws(keys, 3)
    for k, n_, row in zip(keys.tolist(), nxt.tolist(), bits.tolist()):
        want = [mix((k + c * golden) & mask) for c in range(1, 5)]
        assert [v % 2**64 for v in row] == want[:3]
        assert n_ % 2**64 == want[3]


def test_randomize_episode_length_uses_the_state_keys():
    env = NLinkPendulum(1000, L, max_episode_length=50, device="cpu")
    state, _ = env.reset(2)
    out = env.randomize_episode_length(state)
    lengths = out.episode_length
    assert lengths.dtype == torch.int32 and int(lengths.min()) >= 0 and int(lengths.max()) < 50
    assert len(torch.unique(lengths)) > 40
    assert not torch.equal(out.rng, state.rng)
    assert torch.equal(env.randomize_episode_length(state).episode_length, lengths)


def test_domain_randomized_draws_come_from_the_state_keys():
    """The mass scales are drawn from each env's key with its reset state:
    a step is a function of its arguments, the theta and omega draws are the
    base env's for the same keys, the scales resample only where an env is
    done, and the env holds no generator."""
    lo, hi = 0.5, 2.0
    env = DomainRandomizedNLink(N, L, max_episode_length=3, mass_scale_range=(lo, hi), device="cpu")
    assert not any(isinstance(v, torch.Generator) for v in vars(env).values())
    state, obs = env.reset(5)
    base, _ = NLinkPendulum(N, L, device="cpu").reset(5)
    assert torch.equal(state.theta, base.theta) and torch.equal(state.omega, base.omega)
    assert not torch.equal(state.rng, base.rng), "the scales take draws of their own"
    assert obs["privileged"].shape == (N, 4 * L)
    actions = torch.randn(N, L, generator=torch.Generator().manual_seed(3))
    state.episode_length[::2] = 2  # these envs reset in the step
    first, second = env.step(state, actions), env.step(state, actions)
    for a, b in zip(vars(first[0]).values(), vars(second[0]).values()):
        assert torch.equal(a, b)
    done = first[3]
    assert done[::2].all() and not done[1::2].any()
    assert torch.equal(first[0].mass_scale[1::2], state.mass_scale[1::2])
    assert not torch.equal(first[0].mass_scale[::2], state.mass_scale[::2])


def test_domain_randomized_scales_are_log_uniform():
    """10^5 scales lie in the range and their logs have the mean and
    variance of the uniform distribution on ``[log lo, log hi)`` within 3 sigma."""
    lo, hi = 0.5, 2.0
    state, _ = DomainRandomizedNLink(20_000, L, mass_scale_range=(lo, hi), device="cpu").reset(13)
    x = state.mass_scale.double().flatten()
    assert float(x.min()) >= lo and float(x.max()) <= hi
    y = torch.log(x).numpy()
    n, a, b = y.size, np.log(lo), np.log(hi)
    var = (b - a) ** 2 / 12
    assert abs(y.mean() - (a + b) / 2) < 3 * np.sqrt(var / n)
    assert abs(y.var() - var) < 3 * np.sqrt((b - a) ** 4 * (1 / 80 - 1 / 144) / n)
