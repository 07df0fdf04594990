"""The N-link pendulum's step kernel (``csrc/nlink.cu``, ``ops/nlink_step.py``)
and the plain step it stands beside, without JAX, so the file also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_nlink_kernel.py

On the CPU: the wrapper's argument checks; ``step`` on CPU tensors takes the
plain step, whose results equal a frozen copy of the step as it was before the
kernel (resets included, the three NLink classes, per-env limits); the launch
counter stays at 0; the tracer books a kernel's counts with the iteration's
marks; the domain-randomized env's extra draws give the frozen mass scales.
The tests marked ``cuda`` hold the kernel against the plain step on the card
bit for bit over 800 steps, a graphed collection against the eager one, and
the launches a graphed iteration counts; they skip without a card.
"""

import pytest
import torch

from rsl_rl_tpu_torch.env.nlink import (
    DomainRandomizedNLink,
    DomainRandomizedNLinkState,
    NLinkPendulum,
    NLinkState,
    PartiallyObservableNLink,
    _EFFORT_COST,
    _OMEGA_DRAW,
    _PIVOT_FLOOR,
    _SPEED_COST,
    _THETA_DRAW,
    _shr,
    hash_draws,
    uniform_draws,
)
from rsl_rl_tpu_torch.ops import nlink_step
from rsl_rl_tpu_torch.utils import cuda_graph, trace

CLASSES = {"nlink": NLinkPendulum, "po": PartiallyObservableNLink, "dr": DomainRandomizedNLink}


# ---------------------------------------------------------------------------
# the step as it was before the kernel, frozen (env/nlink.py, plain PyTorch)
# ---------------------------------------------------------------------------


def _frozen_solve_spd(n, M, rhs):
    a = [[M[:, i, j] for j in range(n)] for i in range(n)]
    low = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                low[i][j] = torch.sqrt(torch.clamp(s, min=1e-9))
            else:
                low[i][j] = s / low[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[:, i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return torch.stack(x, dim=-1)


def _frozen_coupling(env, state):
    if not isinstance(env, DomainRandomizedNLink):
        return env._coup, env._gdiag
    m = env.masses * state.mass_scale
    cummass = torch.flip(torch.cumsum(torch.flip(m, [-1]), -1), [-1])
    K = cummass[:, env._maxidx]
    return K * env._ll, env.g * env.lengths * torch.diagonal(K, dim1=-2, dim2=-1)


def _frozen_sample_init(env, rng):
    L = env.num_links
    if not isinstance(env, DomainRandomizedNLink):
        rng, bits = hash_draws(rng, 2 * L)
        draws = uniform_draws(bits, env._draw_low, env._draw_width)
        return rng, {"theta": draws[:, :L], "omega": draws[:, L:]}
    rng, bits = hash_draws(rng, 3 * L)
    draws = uniform_draws(bits[:, : 2 * L], env._draw_low, env._draw_width)
    u = _shr(bits[:, 2 * L :], 40).to(torch.float32) / 2**24
    mass_scale = torch.exp((env._log_lo + u * (env._log_hi - env._log_lo)).double()).float()
    return rng, {"theta": draws[:, :L], "omega": draws[:, L:], "mass_scale": mass_scale}


def _frozen_obs(env, state):
    cos, sin = torch.cos(state.theta), torch.sin(state.theta)
    if isinstance(env, PartiallyObservableNLink):
        return {"policy": torch.cat([cos, sin], dim=-1)}
    obs = {"policy": torch.cat([cos, sin, 0.1 * state.omega], dim=-1)}
    if isinstance(env, DomainRandomizedNLink):
        obs["privileged"] = torch.cat([obs["policy"], torch.log(state.mass_scale)], dim=-1)
    return obs


def frozen_step(env, state, actions):
    u = torch.clamp(actions, -env.max_torque, env.max_torque)
    tau = u - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)
    theta, omega = state.theta, state.omega
    coup, gdiag = _frozen_coupling(env, state)
    h = env.dt / env.n_substeps
    for _ in range(env.n_substeps):
        dth = theta[:, :, None] - theta[:, None, :]
        M = coup * torch.cos(dth)
        C = torch.sum(coup * torch.sin(dth) * (omega**2)[:, None, :], dim=-1)
        G = gdiag * torch.sin(theta)
        rhs = tau - C - G - env.damping * omega
        omega = omega + h * _frozen_solve_spd(env.num_links, M, rhs)
        omega = torch.clamp(omega, -env.max_speed, env.max_speed)
        theta = theta + h * omega
    height = -torch.sum(env.lengths * torch.cos(theta), dim=-1) / env._total_len
    reward = height - 0.05 * torch.mean(omega**2, dim=-1) - 0.01 * torch.mean(u**2, dim=-1)
    episode_length = state.episode_length + 1
    done = episode_length >= env.max_episode_length
    rng, fresh = _frozen_sample_init(env, state.rng)
    done_col = done[:, None]
    fields = dict(episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
                  theta=torch.where(done_col, fresh["theta"], theta),
                  omega=torch.where(done_col, fresh["omega"], omega), rng=rng)
    if isinstance(env, DomainRandomizedNLink):
        state = DomainRandomizedNLinkState(**fields, mass_scale=torch.where(done_col, fresh["mass_scale"],
                                                                             state.mass_scale))
    else:
        state = NLinkState(**fields)
    extras = {"time_outs": done, "log": {"nlink/tip_height": height}}
    return state, _frozen_obs(env, state), reward, done, extras


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _env(kind, num_envs, links, limit, device):
    return CLASSES[kind](num_envs, links, max_episode_length=limit, device=device)


def _start(env, seed):
    """A reset state with scattered clocks, spread angles and speeds (so the
    clamps and both kinds of env, resetting and not, occur)."""
    state, _ = env.reset(seed)
    state = env.randomize_episode_length(state)
    g = torch.Generator().manual_seed(seed)
    n, L = state.theta.shape
    state.theta = (torch.rand(n, L, generator=g) * 6 - 3).to(env.device)
    state.omega = (torch.randn(n, L, generator=g) * 8).to(env.device)
    return state


def _actions(g, n, L, device):
    return (torch.randn(n, L, generator=g) * 8).to(device)  # beyond max_torque now and then


def _assert_equal(got, want, where):
    (sa, oa, ra, da, ea), (sb, ob, rb, db, eb) = got, want
    assert type(sa) is type(sb), where
    for k in vars(sb):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), f"{where}: state.{k}"
    assert oa.keys() == ob.keys(), where
    for k in ob:
        assert torch.equal(oa[k], ob[k]), f"{where}: obs[{k}]"
    assert torch.equal(ra, rb), f"{where}: reward"
    assert torch.equal(da, db), f"{where}: done"
    assert torch.equal(ea["time_outs"], eb["time_outs"]), f"{where}: time_outs"
    assert torch.equal(ea["log"]["nlink/tip_height"], eb["log"]["nlink/tip_height"]), f"{where}: tip height"


def _kernel_args(env, state, a, **over):
    """The keyword arguments ``env.step`` gives the wrapper, with ``over``'s in their place."""
    coup, gdiag = env._coupling(state)
    args = dict(theta=state.theta, omega=state.omega, actions=a, episode_length=state.episode_length,
                keys=state.rng, max_episode_length=env.max_episode_length, coup=coup, gdiag=gdiag,
                lengths=env.lengths, reset_draws=env.reset_draws, n_substeps=env.n_substeps,
                h=env.dt / env.n_substeps, max_torque=env.max_torque, max_speed=env.max_speed,
                damping=env.damping, total_len=env._total_len, theta_range=_THETA_DRAW,
                omega_range=_OMEGA_DRAW, pivot_floor=_PIVOT_FLOOR, speed_cost=_SPEED_COST,
                effort_cost=_EFFORT_COST)
    return {**args, **over}


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

N, L = 6, 3
BAD_ARGS = {
    "theta_dtype": (lambda s, a: {"theta": s.theta.double()}, TypeError, "theta: expected torch.float32"),
    "omega_shape": (lambda s, a: {"omega": s.omega[:, :2]}, ValueError, "omega: expected shape"),
    "actions_dtype": (lambda s, a: {"actions": a.to(torch.bfloat16)}, TypeError, "actions: expected torch.float32"),
    "actions_rows": (lambda s, a: {"actions": a[:4]}, ValueError, "actions: expected shape"),
    "lengths_int64": (lambda s, a: {"episode_length": s.episode_length.long()}, TypeError, "episode_length"),
    "keys_int32": (lambda s, a: {"keys": s.rng.int()}, TypeError, "keys: expected torch.int64"),
    "theta_1d": (lambda s, a: {"theta": s.theta[:, 0]}, ValueError, r"theta: expected an \[N, L\] tensor"),
    "coup_wide": (lambda s, a: {"coup": torch.ones(L, L + 1)}, ValueError, "coup: expected shape"),
    "coup_envs": (lambda s, a: {"coup": torch.ones(N + 1, L, L)}, ValueError, "coup: expected shape"),
    "gdiag_envs": (lambda s, a: {"gdiag": torch.ones(N, L + 1)}, ValueError, "gdiag: expected shape"),
    "coup_fp64": (lambda s, a: {"coup": torch.ones(L, L, dtype=torch.float64)}, TypeError, "coup"),
    "limit_float": (lambda s, a: {"max_episode_length": 40.0}, ValueError, "max_episode_length"),
    "limit_big": (lambda s, a: {"max_episode_length": 2**31}, ValueError, "max_episode_length"),
    "limit_int64": (lambda s, a: {"max_episode_length": torch.full((N,), 5)}, TypeError, "max_episode_length"),
    "limit_rows": (lambda s, a: {"max_episode_length": torch.full((N - 1,), 5, dtype=torch.int32)}, ValueError,
                   "max_episode_length"),
    "draws": (lambda s, a: {"reset_draws": 2 * L - 1}, ValueError, "reset_draws"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    env = NLinkPendulum(N, L, max_episode_length=40, device="cpu")
    state, _ = env.reset(0)
    actions = torch.zeros(N, L)
    make, error, match = BAD_ARGS[case]
    args = _kernel_args(env, state, actions, **make(state, actions))
    before = nlink_step.launches
    with pytest.raises(error, match=match):
        nlink_step.step(**args)
    assert nlink_step.launches == before


@pytest.mark.parametrize("links", [0, 9])
def test_wrapper_takes_one_to_eight_links(links):
    theta = torch.zeros(N, links)
    with pytest.raises(ValueError, match="1 <= L <= 8"):
        nlink_step.step(theta, theta, theta, torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int64), 5,
                        torch.ones(links, links), torch.ones(links), torch.ones(links), reset_draws=2 * links,
                        n_substeps=4, h=0.005, max_torque=10.0, max_speed=20.0, damping=0.05, total_len=1.0,
                        theta_range=(-0.1, 0.2), omega_range=(-0.05, 0.1), pivot_floor=1e-9,
                        speed_cost=0.05, effort_cost=0.01)


@pytest.mark.parametrize("form", ["one_plant", "per_env", "per_env_limits", "strided_state"])
def test_wrapper_takes_every_form_and_asks_for_a_card(form):
    """Well-formed arguments in each form the kernel takes pass every check
    and are refused only for lying on the CPU (the kernel has no CPU mode)."""
    env = (DomainRandomizedNLink if form == "per_env" else NLinkPendulum)(N, L, max_episode_length=40, device="cpu")
    state, _ = env.reset(0)  # theta and omega are column slices of the draws, keys a column too
    over = {}
    if form == "per_env_limits":
        over["max_episode_length"] = torch.arange(5, 5 + N, dtype=torch.int32)
    if form == "strided_state":
        assert not state.theta.is_contiguous() and not state.rng.is_contiguous()
    args = _kernel_args(env, state, torch.zeros(N, L), **over)
    if form == "per_env":
        assert args["coup"].shape == (N, L, L) and args["reset_draws"] == 3 * L
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        nlink_step.step(**args)


@pytest.mark.parametrize("limits", ["scalar", "per_env"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_cpu_step_is_the_frozen_plain_step(kind, limits):
    """On CPU tensors ``step`` runs the plain step, whose every output equals
    the frozen copy's bit for bit, over 30 steps with resets."""
    links = 4
    limit = [3 + i % 7 for i in range(16)] if limits == "per_env" else 7
    env = _env(kind, 16, links, limit, "cpu")
    state = _start(env, 5)
    want_state = state
    g = torch.Generator().manual_seed(11)
    before = nlink_step.launches
    resets = 0
    for t in range(30):
        a = _actions(g, 16, links, "cpu")
        got = env.step(state, a)
        want = frozen_step(env, want_state, a)
        _assert_equal(got, want, f"{kind} step {t}")
        state, want_state = got[0], want[0]
        resets += int(got[3].sum())
    assert resets > 16
    assert nlink_step.launches == before


@pytest.mark.parametrize("links", [1, 2, 8])
def test_cpu_step_is_the_frozen_plain_step_at_other_widths(links):
    env = DomainRandomizedNLink(8, links, max_episode_length=4, device="cpu")
    state = want_state = _start(env, links)
    g = torch.Generator().manual_seed(links)
    for t in range(10):
        a = _actions(g, 8, links, "cpu")
        got, want = env.step(state, a), frozen_step(env, want_state, a)
        _assert_equal(got, want, f"L={links} step {t}")
        state, want_state = got[0], want[0]


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_reset_draws_are_the_frozen_ones(kind):
    env = _env(kind, 32, 5, 40, "cpu")
    keys = torch.arange(32, dtype=torch.int64) * 7919 - 3
    rng, fresh = env._sample_init(keys)
    want_rng, want = _frozen_sample_init(env, keys)
    assert torch.equal(rng, want_rng) and fresh.keys() == want.keys()
    for k in want:
        assert torch.equal(fresh[k], want[k]), k


def test_domain_randomized_extra_draws_give_the_frozen_mass_scale():
    """The ``L`` draws past theta's and omega's, the kernel's ``extra_bits``,
    map to the mass scales the frozen reset draws."""
    env = DomainRandomizedNLink(64, 5, max_episode_length=40, mass_scale_range=(0.3, 3.0), device="cpu")
    assert env.reset_draws == 15 and NLinkPendulum(4, 5, device="cpu").reset_draws == 10
    keys = torch.arange(64, dtype=torch.int64) * -104729
    _, bits = hash_draws(keys, env.reset_draws)
    _, want = _frozen_sample_init(env, keys)
    got = env._extra_fields(bits[:, 10:])
    assert list(got) == ["mass_scale"] and torch.equal(got["mass_scale"], want["mass_scale"])
    assert NLinkPendulum(4, 5, device="cpu")._extra_fields(bits[:4, 10:10]) == {}


def test_cpu_training_counts_no_kernel_launch():
    """A split iteration on the CPU books its ``env`` marks and no
    ``env.kernel`` count, and the launch counter stays at 0."""
    from rsl_rl_tpu_torch.runners import OnPolicyRunner

    cfg = {"num_steps_per_env": 4, "save_interval": 5, "seed": 3,
           "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
           "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2}}
    runner = OnPolicyRunner(NLinkPendulum(8, 3, max_episode_length=5, device="cpu"), cfg, device="cpu")
    runner.learn(1)
    record = trace.records[-1]
    assert record.spans["env"].count == 4 and record.counts == {}
    if not torch.cuda.is_available():
        assert nlink_step.launches == 0


def test_counts_ride_the_iteration_marks_to_its_record():
    trace.count("env.kernel")  # outside an iteration's marks: nothing
    trace.begin_iteration("cpu")
    for _ in range(3):
        with trace.interval("env"):
            trace.count("env.kernel")
    trace.end_iteration()
    stamps = trace.take_stamps()
    assert stamps.counts == {"env.kernel": 3}
    record = trace.Record(iteration=0, index=-1)
    trace.book(record, stamps.labels, stamps.read(), stamps.clock, stamps.counts)
    assert record.counts == {"env.kernel": 3} and record.spans["env"].count == 3


def test_graph_adds_the_env_launches_back_apart_from_the_replay_counters():
    """``IterationGraph`` adds the env kernel's captured launches back on
    each replay, and they stay out of the replay kernels' counters, which
    ``rnn_launches_per_it`` sums."""
    assert all(c is not nlink_step for c in cuda_graph.launch_counters())
    before = nlink_step.launches
    rows = cuda_graph._read_counts()
    counts = [0] * len(rows)
    counts[-1] = 24
    cuda_graph._add_counts(counts, 2)
    try:
        assert nlink_step.launches == before + 48
        assert cuda_graph._read_counts()[:-1] == rows[:-1]
    finally:
        cuda_graph._add_counts(counts, -2)
    assert nlink_step.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step kernel has no CPU mode")
    return "cuda"


def _run_both(env, state, steps, seed, rows=None):
    """``steps`` steps of the kernel (``env.step``) and of the plain step on
    the card from ``state``, each on its own trajectory, compared at every
    step; the number of resets."""
    g = torch.Generator().manual_seed(seed)
    n, links = state.theta.shape
    plain_state, resets = state, 0
    launches = nlink_step.launches
    for t in range(steps):
        a = _actions(g, n, links, state.theta.device)
        got = env.step(state, a)
        want = env._step_plain(plain_state, a)
        _assert_equal(got, want, f"{type(env).__name__} L={links} step {t}")
        state, plain_state = got[0], want[0]
        resets += int(got[3].sum())
    assert nlink_step.launches - launches == steps
    return resets


@pytest.mark.cuda
@pytest.mark.parametrize("links", [1, 3, 5, 8])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_kernel_is_the_plain_step_on_card(kind, links):
    """800 steps of 4096 envs (two episode ends of a 400-step limit), the
    kernel against the plain step on the card, bit for bit."""
    device = _card()
    env = _env(kind, 4096, links, 400, device)
    resets = _run_both(env, _start(env, 100 + links), 800, links)
    assert resets >= 2 * 4096


@pytest.mark.cuda
def test_kernel_takes_per_env_limits_on_card():
    device = _card()
    limits = [1 + (i * 37) % 300 for i in range(2048)]
    env = NLinkPendulum(2048, 5, max_episode_length=limits, device=device)
    assert _run_both(env, _start(env, 7), 800, 7) > 2 * 2048


@pytest.mark.cuda
def test_kernel_steps_a_stacked_multiseed_batch_on_card():
    """G x E envs of several seeds in one batch, as ``collect_stacked``
    steps them: each seed's rows equal its own run."""
    device = _card()
    G, E = 4, 512
    env = NLinkPendulum(E, 5, max_episode_length=60, device=device)
    starts = [_start(env, 20 + s) for s in range(G)]
    stacked = NLinkState(**{k: torch.cat([getattr(s, k) for s in starts]) for k in vars(starts[0])})
    _run_both(env, stacked, 200, 3)
    g = torch.Generator().manual_seed(9)
    actions = [_actions(g, G * E, 5, device) for _ in range(50)]
    state = stacked
    for a in actions:
        state, *_ = env.step(state, a)
    for s in range(G):
        own = starts[s]
        for a in actions:
            own, *_ = env.step(own, a[s * E:(s + 1) * E])
        for k in vars(own):
            assert torch.equal(getattr(own, k), getattr(state, k)[s * E:(s + 1) * E]), (s, k)


def _ff_cfg(**keys):
    return {"num_steps_per_env": 24, "save_interval": 5, "seed": 3,
            "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
            "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [64, 64], "critic_hidden_dims": [64, 64],
                       "actor_obs_normalization": True, "critic_obs_normalization": True},
            "algorithm": {"class_name": "PPO", "num_learning_epochs": 2, "num_mini_batches": 4}, **keys}


@pytest.mark.cuda
def test_graphed_collection_is_the_eager_one_and_counts_24_launches():
    """A fused run (each iteration one graph replay) equals the split run bit
    for bit, and each graphed iteration counts the step kernel's 24 launches
    on the counter and on its tracer record (``env.kernel``)."""
    from rsl_rl_tpu_torch.runners import OnPolicyRunner
    from rsl_rl_tpu_torch.utils.cuda_graph import flatten

    device = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for keys in ({}, {"fuse_iteration": True}):
        runner = OnPolicyRunner(NLinkPendulum(1024, 5, max_episode_length=30, device=device), _ff_cfg(**keys),
                                device=device)
        runner.learn(1, init_at_random_ep_len=True)  # eager, or the warm-up and capture
        torch.cuda.synchronize()
        before = nlink_step.launches
        runner.learn(3)
        torch.cuda.synchronize()
        assert nlink_step.launches - before == 3 * 24
        for record in list(trace.records)[-3:]:
            assert record.counts == {"env.kernel": 24} and record.spans["env"].count == 24
        runs.append(runner)
    a, b = (flatten((r.alg.policy.state_dict(), r.alg.adam_mu, r.alg.adam_nu, r.collect_state))[0] for r in runs)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"state tensor {i} differs"
    assert runs[1].iteration_graph.capture_s is not None
