"""Population-based training over the seed axis (counterpart of
``rsl_rl_tpu/runners/pbt.py``).

Extends :mod:`rsl_rl_tpu_torch.runners.multiseed` (G independent runs
stacked on a leading seed axis) with PBT's exploit/explore step [Jaderberg
et al. 2017, arXiv:1711.09846]: every ``exploit_interval`` iterations the
bottom ``exploit_fraction`` of the population (ranked by smoothed mean
episode reward) copies the training state of a random member of the top
fraction and perturbs its learning rate. The copy is one gather along the
seed axis of every stacked tensor, written back into the same storage.

The exchange runs inside the iteration with no host read: whether it is due
is a 0-d device bool, and when it is not the gather takes each seed from
itself (``src = where(due, src, arange(G))``), so a CUDA graph of the
iteration holds it. The iteration counter it reads is a device tensor
advanced in place, and its draws come from a generator of its own, which
the graph registers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train


@dataclass
class PBTState:
    """Population bookkeeping carried across train steps."""

    fitness: torch.Tensor  #: [G] smoothed mean completed-episode reward
    fitness_valid: torch.Tensor  #: [G] bool, True once a seed finished an episode
    it: torch.Tensor  #: [] int64, train steps taken (the JAX package's ``ts.it``)
    exploits: torch.Tensor  #: [] int32, total number of seeds replaced so far
    generator: torch.Generator  #: the exchange's choices and learning-rate factors

    def checkpoint(self) -> dict:
        """The state as plain tensors (the generator's state included)."""
        return {"fitness": self.fitness, "fitness_valid": self.fitness_valid, "it": self.it,
                "exploits": self.exploits, "generator": self.generator.get_state()}

    @torch.no_grad()
    def restore(self, saved: dict) -> None:
        """Copy a :meth:`checkpoint` back in place."""
        for key in ("fitness", "fitness_valid", "it", "exploits"):
            getattr(self, key).copy_(saved[key])
        self.generator.set_state(saved["generator"].cpu())


def init_pbt_state(num_seeds: int, seed: int, device) -> PBTState:
    return PBTState(
        fitness=torch.zeros(num_seeds, dtype=torch.float32, device=device),
        fitness_valid=torch.zeros(num_seeds, dtype=torch.bool, device=device),
        it=torch.zeros((), dtype=torch.int64, device=device),
        exploits=torch.zeros((), dtype=torch.int32, device=device),
        # a stream apart from the training's (the algorithm draws from seed + 1)
        generator=torch.Generator(device=device).manual_seed(int(seed) + 0x504254),
    )


@torch.no_grad()
def exploit(ts, pbt: PBTState, due: torch.Tensor, k_exchange: int, lr_perturb: tuple[float, float],
            choices=None) -> None:
    """Truncation selection, in place: when ``due`` (a 0-d device bool) the
    bottom ``k_exchange`` seeds by fitness copy a random top-``k_exchange``
    member's training state (the policy's parameters and normalizer
    moments, the optimizer's moments and count, the learning rate and the
    RND state; each seed keeps its own carries and random streams), inherit
    its fitness, and multiply the copied learning rate by a log-uniform
    factor in ``lr_perturb``. ``choices = (pick [k], factors [G])`` replaces
    the draws: the position in the top pool each bottom seed copies, and
    each seed's factor (applied at the bottom seeds only)."""
    G = pbt.fitness.shape[0]
    dev = pbt.fitness.device
    order = torch.argsort(pbt.fitness, stable=True)  # ascending, ties by index as jnp.argsort
    bottom, top = order[:k_exchange], order[G - k_exchange:]
    if choices is None:
        pick = torch.randint(0, k_exchange, (k_exchange,), generator=pbt.generator, device=dev)
        u = torch.rand(G, generator=pbt.generator, device=dev)
        log_lo, log_hi = math.log(lr_perturb[0]), math.log(lr_perturb[1])
        factors = torch.exp(log_lo + (log_hi - log_lo) * u)
    else:
        pick, factors = (torch.as_tensor(c, device=dev) for c in choices)
    ar = torch.arange(G, device=dev)
    src = ar.clone()
    src[bottom] = top[pick]
    src = torch.where(due, src, ar)
    # index_fill_ with a Python value: no host tensor to copy under a graph capture
    is_bottom = torch.zeros(G, dtype=torch.bool, device=dev).index_fill_(0, bottom, True) & due
    for t in ts.seed_tensors():
        t.copy_(t[src])
    ts.lr.copy_(torch.where(is_bottom, ts.lr * factors.to(ts.lr.dtype), ts.lr))
    pbt.fitness.copy_(pbt.fitness[src])
    pbt.exploits.add_(due.to(torch.int32) * k_exchange)


def make_pbt_step(num_seeds: int, *, exploit_interval: int = 20, exploit_fraction: float = 0.25,
                  lr_perturb: tuple[float, float] = (0.8, 1.25), fitness_smoothing: float = 0.3) -> Callable:
    """The PBT half of a train step, ``pbt_step(ts, pbt, metrics, choices=None)
    -> metrics``: folds the iteration's episodes into each seed's fitness,
    advances the counter, runs the exchange when it is due (in place on
    ``ts`` and ``pbt``) and adds ``PBT/fitness [G]``, ``PBT/lr [G]`` and
    ``PBT/exploits`` (a scalar) to the metrics. ``choices`` is passed to
    :func:`exploit`. Validates the arguments as :func:`make_pbt_train`."""
    if not 0.0 <= exploit_fraction <= 0.5:
        # above 0.5 the bottom and top pools overlap: replaced losers would
        # serve as clone sources, silently degenerating truncation selection
        raise ValueError(f"exploit_fraction must be in [0, 0.5], got {exploit_fraction}")
    k_exchange = int(math.floor(num_seeds * exploit_fraction))

    def pbt_step(ts, pbt: PBTState, metrics: dict, choices=None) -> dict:
        with torch.no_grad():
            # per-seed mean completed-episode reward this iteration; EMA-smoothed,
            # holding the previous value on iterations with no finished episode
            count = metrics["ep_count"]
            has_ep = count > 0
            it_fit = metrics["ep_reward_sum"] / torch.clamp(count, min=1.0)
            blended = torch.where(pbt.fitness_valid,
                                  (1.0 - fitness_smoothing) * pbt.fitness + fitness_smoothing * it_fit, it_fit)
            pbt.fitness.copy_(torch.where(has_ep, blended, pbt.fitness))
            pbt.fitness_valid.copy_(pbt.fitness_valid | has_ep)
            pbt.it.add_(1)
            if k_exchange > 0:
                due = (pbt.it % exploit_interval == 0) & pbt.fitness_valid.all()
                exploit(ts, pbt, due, k_exchange, lr_perturb, choices)
            return {**metrics, "PBT/fitness": pbt.fitness.clone(), "PBT/lr": ts.lr.clone(),
                    "PBT/exploits": pbt.exploits.clone()}

    return pbt_step


def make_pbt_train(alg, env, num_steps_per_env: int, num_seeds: int, *, exploit_interval: int = 20,
                   exploit_fraction: float = 0.25, lr_perturb: tuple[float, float] = (0.8, 1.25),
                   fitness_smoothing: float = 0.3, device="cuda") -> tuple[Callable, Callable]:
    """Build ``(init, train_step)`` for population-based training.

    ``init(policies, seed) -> (ts, cs, pbt)``: the stacked train and collect
    states of :func:`~rsl_rl_tpu_torch.runners.multiseed.make_multiseed_train`
    plus the PBT bookkeeping state.

    ``train_step(ts, cs, pbt, action_noise=None, choices=None) -> (ts, cs,
    pbt, metrics)``: one training iteration for the whole population; on
    iterations where ``it % exploit_interval == 0`` (and every seed has a
    fitness reading) the truncation-selection exchange runs in the same
    iteration. Metrics gain a leading ``[num_seeds]`` axis and PBT adds
    ``PBT/fitness`` ([G]), ``PBT/lr`` ([G]) and ``PBT/exploits`` (scalar).

    Args:
        exploit_interval: iterations between exploit/explore steps.
        exploit_fraction: fraction of the population replaced (and the size
            of the top pool copied from), truncation selection; must be in
            ``[0, 0.5]`` so the bottom and top pools cannot overlap. A
            fraction that rounds to zero seeds disables the exchange.
        lr_perturb: ``(lo, hi)`` log-uniform factor applied to the copied
            learning rate.
        fitness_smoothing: EMA coefficient for the per-iteration mean
            completed-episode reward (iterations with no finished episode
            leave a seed's fitness unchanged).

    Runs on CUDA unless ``device="cpu"``; raises without CUDA otherwise.
    """
    pbt_step = make_pbt_step(num_seeds, exploit_interval=exploit_interval, exploit_fraction=exploit_fraction,
                             lr_perturb=lr_perturb, fitness_smoothing=fitness_smoothing)
    base_init, base_step = make_multiseed_train(alg, env, num_steps_per_env, num_seeds, device)

    def init(policies, seed: int):
        ts, cs = base_init(policies, seed)
        return ts, cs, init_pbt_state(num_seeds, seed, alg.device)

    def train_step(ts, cs, pbt: PBTState, action_noise=None, choices=None):
        ts, cs, metrics = base_step(ts, cs, action_noise)
        return ts, cs, pbt, pbt_step(ts, pbt, metrics, choices)

    return init, train_step
