"""Proximal Policy Optimization for feedforward and recurrent policies
(counterpart of ``rsl_rl_tpu/algorithms/ppo.py``).

- :meth:`PPO.collect` runs the rollout window step by step: act, sample,
  log-prob, value, env step, normalizer update on the post-step obs, timeout
  bootstrap, carry reset of done envs and episode bookkeeping, all on the
  policy's device with no host sync.
- :meth:`PPO.update` computes GAE, then runs epochs x minibatches: for a
  recurrent policy contiguous env slices, replaying each window from its
  start carry; for a feedforward one contiguous slices of the window's rows
  shuffled once by one permutation (:func:`pack_minibatch_rows`). Each
  step applies the clipped surrogate + clipped value loss - entropy, the
  adaptive-KL learning rate, the global-norm clip and the optimizer with the
  formulas of the optax chain the JAX package uses (``clip_by_global_norm``
  then, for Adam, ``scale_by_adam``, applied as ``p - lr * u``).
- :meth:`PPO.collect_stacked` / :meth:`PPO.update_stacked` do the same for
  G independent seeds at once (multi-seed training, the counterpart of
  ``jax.vmap`` over the JAX package's collect and update): the policies'
  states, the Adam moments and count and the learning rate are stacked on a
  leading ``[G]`` axis (:class:`StackedTrainState`), the policy runs through
  ``torch.func.vmap`` (``modules.policy.seed_call``), the per-seed arithmetic
  (GAE and its advantage normalization, the loss means, the KL, the
  learning-rate rule, the clip and Adam) is the single-seed code vmapped over
  the seed axis, and one ``torch.autograd.grad`` of the summed per-seed
  losses gives each seed its own gradient. The env steps all G*E envs in
  one call.

With ``rnd_cfg`` the collection adds RND's intrinsic reward and the update
trains its predictor; with ``symmetry_cfg`` the update augments each
minibatch with its symmetric copies, adds the mirror loss, or logs it
(:class:`PPO`), on one seed and on G at once: a study stacks each seed's
RND state (the predictor and its optimizer, the frozen target, both
normalizers, the counter) beside its policy. The optimizer is ``adam``,
``adamw``, ``sgd`` or ``rmsprop`` (:class:`Trainer`).

Data and tensor parallelism (:meth:`PPO.distribute`, ``parallel/``): each
data rank holds a contiguous shard of the envs and the math stays that of
one process over all of them, as the JAX package's global programs keep it.
The action noise is drawn for every env from the shared generator and each
rank keeps its rows; the normalizers and the advantage whitening take the
global moments; a minibatch is the global one (a slice of the global
permutation, or of the global env axis) and each rank replays a share of
it fixed by the layout (:func:`dp_minibatches`: the rows of its envs of a
recurrent minibatch; its fixed rows of each slice of the permutation, over
the window rows the data group gathers once an update), every loss mean
its local sum over the global count, so the gradients and the loss metrics
summed over the data group (one collective a minibatch) are the global
ones. A rank with no share of a minibatch joins the sum with zeros and
launches no replay. No count depends on a draw, so an iteration on a mesh
is captured as one CUDA graph as it is in one process.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial
from typing import Any

import numpy as np
import torch
from torch.func import functional_call, stack_module_state, vmap

from rsl_rl_tpu_torch.modules import symmetry
from rsl_rl_tpu_torch.modules.policy import check_state_compatible, seed_call
from rsl_rl_tpu_torch.modules.rnd import RandomNetworkDistillation
from rsl_rl_tpu_torch.ops import distributions
from rsl_rl_tpu_torch.ops.gae import compute_gae
from rsl_rl_tpu_torch.ops.running_norm import RunningNormState
from rsl_rl_tpu_torch.parallel.mesh import global_mean_std
from rsl_rl_tpu_torch.parallel.tp import shard_module_tp, sharded_mask
from rsl_rl_tpu_torch.storage.rollout import Rollout, recurrent_minibatch_starts, slice_envs, tree_map
from rsl_rl_tpu_torch.utils.registry import register
from rsl_rl_tpu_torch.utils.resolvers import resolve_optimizer, string_to_callable


@dataclass
class EpisodeStats:
    """Per-env running sums of the current episode."""

    cur_reward_sum: torch.Tensor
    cur_episode_length: torch.Tensor
    cur_ereward_sum: torch.Tensor
    cur_ireward_sum: torch.Tensor


@dataclass
class CollectState:
    """Env state, current obs, policy carry and episode sums between windows
    (for G seeds: obs, carry and sums ``[G, E, ...]``, the env state flat over
    the ``G*E`` envs)."""

    env_state: Any
    obs: dict[str, torch.Tensor]
    carry: Any
    stats: EpisodeStats


@dataclass
class StackedTrainState:
    """What G independent seeds train, every tensor with a leading ``[G]`` axis.

    ``params`` and ``buffers`` are the policies' parameters and normalizer
    moments by module name (``torch.func.stack_module_state``); ``adam_mu``
    and ``adam_nu`` the optimizer moments of the trained parameters (those
    that require gradients) by the same names; ``adam_count [G]`` and ``lr
    [G]`` each seed's step count and learning rate. With RND, ``rnd_params``
    and ``rnd_buffers`` hold each seed's RND module (the trained predictor,
    the frozen target; both normalizers and the counter), ``rnd_mu``,
    ``rnd_nu`` and ``rnd_count`` its predictor's optimizer state.
    """

    params: dict[str, torch.Tensor]
    buffers: dict[str, torch.Tensor]
    adam_mu: dict[str, torch.Tensor]
    adam_nu: dict[str, torch.Tensor]
    adam_count: torch.Tensor
    lr: torch.Tensor
    rnd_params: dict[str, torch.Tensor] | None = None
    rnd_buffers: dict[str, torch.Tensor] | None = None
    rnd_mu: dict[str, torch.Tensor] | None = None
    rnd_nu: dict[str, torch.Tensor] | None = None
    rnd_count: torch.Tensor | None = None

    def trained_names(self) -> list[str]:
        """The names of the parameters the optimizer steps."""
        return list(self.adam_mu)

    def seed_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state, each ``[G, ...]``."""
        out = [self.adam_count, self.lr]
        for tree in (self.params, self.buffers, self.adam_mu, self.adam_nu, self.rnd_params, self.rnd_buffers,
                     self.rnd_mu, self.rnd_nu):
            out += [] if tree is None else list(tree.values())
        return out + ([] if self.rnd_count is None else [self.rnd_count])


def stack_trained(modules, G: int, learning_rate: float, device) -> StackedTrainState:
    """G modules' states stacked into a fresh training state: zero optimizer
    moments for the parameters that require gradients, zero counts, every
    seed at ``learning_rate``."""
    params, buffers = stack_module_state(list(modules))
    trained = [k for k, v in params.items() if v.requires_grad]
    return StackedTrainState(
        params=params,
        buffers=buffers,
        adam_mu={k: torch.zeros_like(params[k]) for k in trained},
        adam_nu={k: torch.zeros_like(params[k]) for k in trained},
        adam_count=torch.zeros(G, dtype=torch.int32, device=device),
        lr=torch.full((G,), learning_rate, dtype=torch.float32, device=device),
    )


def module_call(module, state, method: str, *args):
    """``module.<method>(*args)`` with ``state = (params, buffers)``
    substituted (``torch.func.functional_call``), or on the module's own
    tensors when ``state`` is None."""
    if state is None:
        return getattr(module, method)(*args)
    return functional_call(module, state, (method, *args))


@torch.no_grad()
def stacked_step(step, ts_params: dict, grads, mu: dict, nu: dict, count: torch.Tensor, lr) -> None:
    """``step`` (a vmapped :func:`clip_step`) over the named parameters of
    ``mu``, in place: every tensor keeps its storage."""
    names = list(mu)
    params, new_mu, new_nu, new_count = step([ts_params[k] for k in names], list(grads),
                                             [mu[k] for k in names], [nu[k] for k in names], count, lr)
    count.copy_(new_count)
    for k, p, m, v in zip(names, params, new_mu, new_nu):
        ts_params[k].copy_(p)
        mu[k].copy_(m)
        nu[k].copy_(v)


ACC_KEYS = ("ep_reward_sum", "ep_length_sum", "ep_ereward_sum", "ep_ireward_sum", "ep_count")

#: rows (env-steps) a minibatch at most, the target of ``num_mini_batches="auto"``
#: (the JAX package's ``ROWS_PER_MINIBATCH_TARGET``)
ROWS_PER_MINIBATCH_TARGET = 24576


def resolve_num_mini_batches(setting, num_steps: int, num_envs: int, recurrent: bool) -> int:
    """``num_mini_batches`` for a window of ``num_steps x num_envs``: an integer
    passes through; ``"auto"`` is the smallest power of two >= 4 that keeps
    every minibatch at or under :data:`ROWS_PER_MINIBATCH_TARGET` rows, as far
    as the count divides the envs (recurrent: minibatches slice the env axis)
    or the rows (feedforward)."""
    if setting != "auto":
        return int(setting)

    def divides(n: int) -> bool:
        return (num_envs % n == 0) if recurrent else ((num_steps * num_envs) % n == 0)

    nb = 4
    while num_steps * num_envs // nb > ROWS_PER_MINIBATCH_TARGET and divides(nb * 2):
        nb *= 2
    return nb


def init_episode_stats(num_envs: int, device) -> EpisodeStats:
    return EpisodeStats(*(torch.zeros(num_envs, device=device) for _ in range(4)))


def step_episode_stats(stats: EpisodeStats, acc: dict, rew, irew, done_f):
    """Advance the per-env episode sums one step and fold the episodes that
    ended this step into the window totals ``acc`` (sums over the last, env
    axis: per seed with a leading seed axis)."""
    stats = EpisodeStats(
        cur_reward_sum=stats.cur_reward_sum + rew + irew,
        cur_episode_length=stats.cur_episode_length + 1.0,
        cur_ereward_sum=stats.cur_ereward_sum + rew,
        cur_ireward_sum=stats.cur_ireward_sum + irew,
    )
    acc = {
        "ep_reward_sum": acc["ep_reward_sum"] + torch.sum(stats.cur_reward_sum * done_f, dim=-1),
        "ep_length_sum": acc["ep_length_sum"] + torch.sum(stats.cur_episode_length * done_f, dim=-1),
        "ep_ereward_sum": acc["ep_ereward_sum"] + torch.sum(stats.cur_ereward_sum * done_f, dim=-1),
        "ep_ireward_sum": acc["ep_ireward_sum"] + torch.sum(stats.cur_ireward_sum * done_f, dim=-1),
        "ep_count": acc["ep_count"] + torch.sum(done_f, dim=-1),
    }
    keep = 1.0 - done_f
    stats = EpisodeStats(*(getattr(stats, f.name) * keep for f in fields(EpisodeStats)))
    return stats, acc


def collect_extras_logs(extras: dict) -> dict[str, torch.Tensor]:
    """Per-step means of the env's ``episode`` (preferred) or ``log`` extras."""
    group = extras.get("episode", extras.get("log", {}))
    return {k: torch.as_tensor(v, dtype=torch.float32).mean() for k, v in group.items()}


def update_data(rollout: Rollout, returns, advantages) -> dict:
    """What the update's minibatches slice: the rollout, its GAE returns and
    advantages, and the replay resets."""
    return {
        "obs": rollout.obs,
        "actions": rollout.actions,
        "values": rollout.values,
        "returns": returns,
        "advantages": advantages,
        "log_probs": rollout.log_probs,
        "mu": rollout.mu,
        "sigma": rollout.sigma,
        "resets": rollout.replay_resets(),
    }


_PACK_SCALAR_FIELDS = ("values", "returns", "advantages", "log_probs")


def pack_minibatch_rows(rollout: Rollout, returns, advantages, perm):
    """Pack every per-row field of a feedforward update into one fp32 array
    of the window's rows in ``perm``'s order; returns ``(packed, unpack)``.

    The reference draws one permutation of the ``T*N`` rows and reuses it in
    every epoch, so the update gathers the rows once and hands out
    contiguous slices (``perm`` None: the rows in the window's order).
    Columns, in order: the obs groups by sorted name,
    ``actions``, ``values``, ``returns``, ``advantages``, ``log_probs``,
    ``mu``, ``sigma``. With a leading seed axis (``perm [G, n]``, every
    field ``[G, T, N, ...]``) each seed gathers its own rows: ``packed [G,
    n, F]``. ``unpack(rows)`` splits a block of packed rows ``[..., B, F]``
    back into the batch dict, each field in its own dtype (scalar fields
    ``[..., B]``), with no ``resets``.
    """
    lead = () if perm is None else tuple(perm.shape[:-1])
    T, N = rollout.num_steps, rollout.num_envs
    obs_keys = sorted(rollout.obs)
    columns = [("obs." + k, rollout.obs[k]) for k in obs_keys] + [
        ("actions", rollout.actions), ("values", rollout.values), ("returns", returns),
        ("advantages", advantages), ("log_probs", rollout.log_probs), ("mu", rollout.mu),
        ("sigma", rollout.sigma),
    ]
    layout, flats = [], []
    for name, v in columns:
        flat = v.reshape(*lead, T * N, -1)
        layout.append((name, flat.shape[-1], tuple(v.shape[len(lead) + 2:]), v.dtype))
        flats.append(flat.to(torch.float32))
    packed = torch.cat(flats, dim=-1)
    if perm is not None:
        packed = torch.take_along_dim(packed, perm.to(torch.int64)[..., None], dim=-2)

    def unpack(rows):
        out, off = {}, 0
        for name, w, trail, dt in layout:
            col = rows[..., off:off + w].to(dt)
            if name in _PACK_SCALAR_FIELDS:
                out[name] = col[..., 0]
            elif len(trail) > 1:
                out[name] = col.reshape(*col.shape[:-1], *trail)
            else:
                out[name] = col
            off += w
        return {"obs": {k: out["obs." + k] for k in obs_keys},
                **{k: out[k] for k in ("actions", "values", "returns", "advantages", "log_probs", "mu", "sigma")}}

    return packed, unpack


def minibatches(policy, rollout: Rollout, returns, advantages, num_mini_batches: int, num_epochs: int,
                perm, seed_axis: bool = False):
    """Every minibatch of every epoch in order, as ``(batch, carry0)``: for
    a recurrent policy contiguous env slices of the window and their start
    carries; for a feedforward one contiguous slices of the rows packed in
    ``perm``'s order (:func:`pack_minibatch_rows`), carry ``()``. With
    ``seed_axis`` every tensor carries a leading ``[G]`` axis."""
    lead = int(seed_axis)
    if policy.is_recurrent:
        data = update_data(rollout, returns, advantages)
        nb = rollout.num_envs // num_mini_batches
        for start in recurrent_minibatch_starts(rollout.num_envs, num_mini_batches, num_epochs):
            yield (slice_envs(data, start, nb, axis=lead + 1),
                   slice_envs(rollout.carry0, start, nb, axis=lead))
        return
    packed, unpack = pack_minibatch_rows(rollout, returns, advantages, perm)
    mb = perm.shape[-1] // num_mini_batches
    for start in [i * mb for i in range(num_mini_batches)] * num_epochs:
        yield unpack(packed.narrow(lead, start, mb)), ()


def dp_minibatches(policy, rollout: Rollout, returns, advantages, num_mini_batches: int, num_epochs: int,
                   perm, mesh):
    """:func:`minibatches` of the data group's window on this data rank:
    every global minibatch of every epoch in order, as ``(batch, carry0,
    n_local, n_global)``, ``batch`` this rank's rows of it (None when it
    has none) and ``n_local`` / ``n_global`` their count and the
    minibatch's along the batch axis. Every count is fixed by the layout,
    none by the draw, so a captured iteration replays it.

    Recurrent: the global env slice cut to this rank's envs. Feedforward:
    the data group's window rows gathered once (``mesh.data_gather``, in
    the global ``[T, N_global]`` order that ``perm`` indexes), then the
    fixed rows ``[r s, (r + 1) s)`` of every global minibatch of ``mb``
    rows, ``s = ceil(mb / W)`` for data rank ``r`` of ``W``: the last
    ranks' shares end at ``mb``."""
    N = rollout.num_envs
    N_global, offset = N * mesh.data_size, mesh.data_rank * N
    if policy.is_recurrent:
        data = update_data(rollout, returns, advantages)
        nb = N_global // num_mini_batches
        for start in recurrent_minibatch_starts(N_global, num_mini_batches, num_epochs):
            lo, hi = max(start, offset), min(start + nb, offset + N)
            if hi <= lo:
                yield None, None, 0, nb
            else:
                yield (slice_envs(data, lo - offset, hi - lo, axis=1),
                       slice_envs(rollout.carry0, lo - offset, hi - lo, axis=0), hi - lo, nb)
        return
    mb = perm.shape[-1] // num_mini_batches
    share = -(-mb // mesh.data_size)
    lo, hi = min(mesh.data_rank * share, mb), min((mesh.data_rank + 1) * share, mb)
    n = hi - lo
    packed, unpack = pack_minibatch_rows(rollout, returns, advantages, None)
    window = mesh.data_gather(packed.view(rollout.num_steps, N, -1), dim=1).view(rollout.num_steps * N_global, -1)
    rows = window.index_select(0, perm.to(torch.int64).view(num_mini_batches, mb)[:, lo:hi].reshape(-1))
    for i in list(range(num_mini_batches)) * num_epochs:
        yield (unpack(rows.narrow(0, i * n, n)) if n else None), (), n, mb


def adapt_lr(lr, kl_mean, desired_kl: float, min_lr: float, max_lr: float):
    """The adaptive-KL learning-rate rule, elementwise (one rate per seed)."""
    up = torch.clamp(lr * 1.5, max=max_lr)
    down = torch.clamp(lr / 1.5, min=min_lr)
    return torch.where(
        kl_mean > desired_kl * 2.0,
        down,
        torch.where((kl_mean < desired_kl / 2.0) & (kl_mean > 0.0), up, lr),
    )


def clip_step(params, grads, mu, nu, count, lr, max_grad_norm: float | None, clip_mask=None,
              direction=resolve_optimizer("adam"), sharded=None, model_sum=None):
    """``clip_by_global_norm`` -> the optimizer's ``direction`` (default
    Adam; ``utils/resolvers.py`` ``resolve_optimizer``) -> ``p - lr * u``
    with optax's formulas (the clip scales by ``max_norm / norm`` only when
    ``norm >= max_norm``) for one seed. ``clip_mask`` (one bool a parameter)
    limits the clip, its norm and its scaling to the marked parameters
    (``optax.masked``). Under tensor parallelism ``sharded`` (one bool a
    parameter) marks the parameters sliced over the model group and
    ``model_sum`` sums over it, so the norm counts each sliced parameter's
    slices once and each replicated one once. Pure, so ``torch.func.vmap``
    runs it for G seeds, each with its own norm. Returns the new ``(params,
    mu, nu, count)``."""
    grads = list(grads)
    if max_grad_norm is not None:
        mask = [True] * len(grads) if clip_mask is None else list(clip_mask)
        if sharded is None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g, m in zip(grads, mask) if m))
        else:
            zero = torch.zeros((), device=grads[0].device)
            sliced = sum((torch.sum(g * g) for g, m, s in zip(grads, mask, sharded) if m and s), zero)
            whole = sum((torch.sum(g * g) for g, m, s in zip(grads, mask, sharded) if m and not s), zero)
            g_norm = torch.sqrt(whole + model_sum(sliced.clone()))
        keep = g_norm < max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * max_grad_norm) if m else g for g, m in zip(grads, mask)]
    updates, mu, nu, count = direction(grads, params, mu, nu, count)
    params = [p - lr * u for p, u in zip(params, updates)]
    return params, mu, nu, count


class Trainer:
    """Named parameters ``param_names`` / ``params`` trained by an optimizer
    (``adam``, ``adamw``, ``sgd`` or ``rmsprop``): its moments ``adam_mu`` /
    ``adam_nu`` (named for Adam; rmsprop keeps its second moment in
    ``adam_nu``, sgd keeps none, so they stay zero), its step count
    ``adam_count`` and the learning rate ``lr``, with the clipped step in
    place and the checkpoint form of the optimizer state. The algorithms
    train their policy through it; PPO's RND predictor has one of its own."""

    def __init__(self, named_params, learning_rate: float, device, optimizer: str = "adam"):
        named = list(named_params)
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.direction = resolve_optimizer(optimizer)
        self.lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)
        self.adam_count = torch.zeros((), dtype=torch.int32, device=device)
        self.adam_mu = [torch.zeros_like(p) for p in self.params]
        self.adam_nu = [torch.zeros_like(p) for p in self.params]
        #: the mesh (``parallel/mesh.py``) and, under tensor parallelism, the
        #: specs of the full state (``parallel/tp.py``) and which parameters
        #: are sliced
        self.mesh = None
        self.tp_specs = None
        self.sharded = None

    def _place(self, mesh, tp_specs=None) -> None:
        """Train on ``mesh``; with ``tp_specs`` the parameters were sliced in
        place (``shard_module_tp``), so the moments start again at their
        shapes."""
        self.mesh = mesh
        if tp_specs is not None:
            self.tp_specs = tp_specs
            self.sharded = sharded_mask(self.param_names, tp_specs)
            self.adam_mu = [torch.zeros_like(p) for p in self.params]
            self.adam_nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def optimizer_step(self, grads, max_grad_norm: float | None, clip_mask=None) -> None:
        """The clipped step (:func:`clip_step`), in place: every tensor of the
        optimizer keeps its storage (a CUDA graph replays addresses)."""
        model_sum = None if self.sharded is None else self.mesh.model_sum_
        params, mu, nu, count = clip_step(self.params, grads, self.adam_mu, self.adam_nu, self.adam_count,
                                          self.lr, max_grad_norm, clip_mask, self.direction, self.sharded,
                                          model_sum)
        for dst, src in zip(self.params + self.adam_mu + self.adam_nu + [self.adam_count],
                            params + mu + nu + [count]):
            dst.copy_(src)

    def optimizer_state(self) -> dict:
        """The optimizer state as plain tensors: ``{"mu": {name: t}, "nu":
        {name: t}, "count": t}``."""
        return {"mu": dict(zip(self.param_names, self.adam_mu)),
                "nu": dict(zip(self.param_names, self.adam_nu)),
                "count": self.adam_count}

    @torch.no_grad()
    def load_optimizer_state(self, state: dict, lr) -> None:
        """Restore :meth:`optimizer_state` and the learning rate, strictly:
        a state of other parameters raises ``ValueError`` before anything is
        copied."""
        for key in ("mu", "nu"):
            check_state_compatible(dict(zip(self.param_names, self.params)), state[key], f"optimizer {key}")
        for key, dst in (("mu", self.adam_mu), ("nu", self.adam_nu)):
            for name, t in zip(self.param_names, dst):
                t.copy_(state[key][name])
        self.adam_count.copy_(torch.as_tensor(state["count"]))
        self.lr.copy_(torch.as_tensor(lr))


def set_norm_mesh(module: torch.nn.Module, mesh) -> None:
    """Give every normalizer of ``module`` the mesh whose data group its
    batch moments are summed over."""
    for m in module.modules():
        if isinstance(m, RunningNormState):
            m.mesh = mesh


def step_noise(mean: torch.Tensor, action_noise, t: int, mesh, generator):
    """The action noise of step ``t`` for this rank's envs: without a mesh
    ``action_noise[t]`` (None: ``distributions.sample`` draws); with one, the
    rows of this data rank's envs of the global step noise, ``action_noise[t]``
    ``[N_global, A]`` or drawn from ``generator`` for all the envs (the same
    draws on every rank)."""
    if mesh is None:
        return None if action_noise is None else action_noise[t]
    n = mean.shape[0]
    if action_noise is None:
        full = torch.randn((n * mesh.data_size, *mean.shape[1:]), dtype=mean.dtype, device=mean.device,
                           generator=generator)
    else:
        full = action_noise[t]
    return full.narrow(0, mesh.data_rank * n, n)


def global_metrics(metrics: dict, mesh, local=()) -> dict:
    """A window's metrics over the data group, in one sum: the episode
    totals (:data:`ACC_KEYS`) summed, the rest (per-step means over equal
    shards) averaged; the keys of ``local`` stay this rank's."""
    keys = [k for k in metrics if k not in local]
    if mesh is None or not keys:
        return metrics
    packed = mesh.data_sum_(torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32) for k in keys]))
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = packed[i] if k in ACC_KEYS else packed[i] / mesh.data_size
    return out


def distribute(alg, mesh) -> None:
    """Train ``alg`` (PPO or Distillation) on ``mesh``: with a model axis,
    shard the policy's MLP trunks and the optimizer moments
    (``parallel/tp.py``); give the policy's (and RND's) normalizers the
    mesh. A second call with the same mesh does nothing."""
    if alg.mesh is mesh:
        return
    if alg.mesh is not None:
        raise ValueError("the algorithm already trains on another mesh")
    specs = shard_module_tp(alg.policy, mesh) if mesh.model_size > 1 else None
    alg._place(mesh, specs)
    set_norm_mesh(alg.policy, mesh)
    if alg.rnd is not None:
        set_norm_mesh(alg.rnd, mesh)


def sum_with_grads(mesh, grads: list, aux: dict) -> tuple[list, dict]:
    """Sum the gradients and the loss metrics over the data group in one
    collective; returns them in their shapes."""
    keys = list(aux)
    flat = mesh.data_sum_(torch.cat([g.reshape(-1) for g in grads] + [aux[k].reshape(1) for k in keys]))
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out, {k: flat[off + i] for i, k in enumerate(keys)}


@register("algorithm")
class PPO(Trainer):
    """Clipped-surrogate PPO with the adaptive-KL learning rate, RND and
    symmetry augmentation.

    ``rnd_cfg`` (resolved by ``modules/rnd.py`` ``resolve_rnd_config``)
    adds RND's intrinsic reward to the collected rewards and trains its
    predictor beside the policy, with Adam at the config's
    ``learning_rate``. ``symmetry_cfg`` (``use_data_augmentation``,
    ``use_mirror_loss``, ``data_augmentation_func``, ``mirror_loss_coeff``;
    the env under ``"_env"``, ``modules/symmetry.py``) augments each
    minibatch with its symmetric copies, adds the mirror loss, or, with
    neither, logs the mirror loss only. The stacked (multi-seed) path takes
    neither yet.
    """

    def __init__(
        self,
        policy,
        num_learning_epochs: int = 5,
        num_mini_batches: int | str = 4,  # or "auto", resolved at update time
        clip_param: float = 0.2,
        gamma: float = 0.99,
        lam: float = 0.95,
        value_loss_coef: float = 1.0,
        entropy_coef: float = 0.01,
        learning_rate: float = 1e-3,
        max_grad_norm: float | None = 1.0,
        use_clipped_value_loss: bool = True,
        schedule: str = "adaptive",
        desired_kl: float | None = 0.01,
        normalize_advantage_per_mini_batch: bool = False,
        rnd_cfg: dict | None = None,
        symmetry_cfg: dict | None = None,
        optimizer: str = "adam",
        min_lr: float = 1e-5,
        max_lr: float = 1e-2,
        seed: int = 0,
        **kwargs,
    ):
        if kwargs:
            print(
                "PPO.__init__ got unexpected arguments, which will be ignored: "
                + str(list(kwargs.keys()))
            )
        self.policy = policy
        self.device = policy.device
        self.num_learning_epochs = num_learning_epochs
        self.num_mini_batches = num_mini_batches if num_mini_batches == "auto" else int(num_mini_batches)
        self.clip_param = clip_param
        self.gamma = gamma
        self.lam = lam
        self.value_loss_coef = value_loss_coef
        self.entropy_coef = entropy_coef
        self.max_grad_norm = max_grad_norm
        self.use_clipped_value_loss = use_clipped_value_loss
        self.schedule = schedule
        self.desired_kl = desired_kl
        self.normalize_advantage_per_mini_batch = normalize_advantage_per_mini_batch
        self.min_lr = min_lr
        self.max_lr = max_lr

        self.learning_rate = learning_rate
        super().__init__(policy.named_parameters(), learning_rate, self.device, optimizer)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        # on a mesh, the minibatch being replayed: its global count over this
        # rank's share, and its advantages' global count (update on a mesh)
        self._batch_ratio, self._adv_count = 1.0, None

        self.rnd = None
        self.rnd_optimizer = None
        if rnd_cfg is not None:
            rnd_cfg = dict(rnd_cfg)
            rnd_lr = rnd_cfg.pop("learning_rate", 1e-3)
            # a stream of its own: the policy draws from seed - 1 and seed
            self._rnd_seed = int(seed) + 0x524E44
            self._rnd_cfg = rnd_cfg
            self.rnd = RandomNetworkDistillation(**rnd_cfg, device=self.device, seed=self._rnd_seed)
            self.rnd_optimizer = Trainer(self.rnd.predictor.named_parameters(), rnd_lr, self.device)

        self.symmetry = None
        if symmetry_cfg is not None:
            symmetry_cfg = dict(symmetry_cfg)
            if not (symmetry_cfg["use_data_augmentation"] or symmetry_cfg["use_mirror_loss"]):
                print("Symmetry not used for learning. We will use it for logging instead.")
            if isinstance(symmetry_cfg["data_augmentation_func"], str):
                symmetry_cfg["data_augmentation_func"] = string_to_callable(symmetry_cfg["data_augmentation_func"])
            if not callable(symmetry_cfg["data_augmentation_func"]):
                raise ValueError(
                    "Symmetry enabled but the data augmentation function is not callable:"
                    f" {symmetry_cfg['data_augmentation_func']}"
                )
            symmetry_cfg.setdefault("_env", None)
            self.symmetry = symmetry_cfg

    def distribute(self, mesh) -> None:
        """Train on ``mesh`` (``parallel/mesh.py``): this process is one rank,
        its envs one data shard (see the module docstring)."""
        distribute(self, mesh)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """A loss mean over the minibatch: on a mesh this rank's share of the
        global mean, its sum over the minibatch's global count."""
        if self.mesh is None:
            return x.mean()
        return x.mean() / self._batch_ratio

    # --------------------------------------------------------------- collect

    def init_collect_state(self, env_state, obs, num_envs: int) -> CollectState:
        if self.rnd is not None:
            self.rnd.init_reward_norm(num_envs)
            if self.mesh is not None:
                set_norm_mesh(self.rnd, self.mesh)
        return CollectState(
            env_state=env_state,
            obs=obs,
            carry=self.policy.initial_carry(num_envs),
            stats=init_episode_stats(num_envs, self.device),
        )

    @torch.no_grad()
    def collect(self, env, cs: CollectState, num_steps: int, action_noise: torch.Tensor | None = None):
        """Run one window; returns ``(cs, rollout, metrics)``.

        ``action_noise [T, N, A]`` replaces the standard normal draws of the
        action sampling (to replay another implementation's noise); on a mesh
        it is the global noise ``[T, N_global, A]`` and the metrics are the
        data group's.
        """
        policy = self.policy
        env_state, obs, carry, stats = cs.env_state, cs.obs, cs.carry, cs.stats
        carry0 = carry
        acc = {k: torch.zeros((), device=self.device) for k in ACC_KEYS}
        steps = {k: [] for k in ("obs", "actions", "rewards", "dones", "values",
                                 "log_probs", "mu", "sigma")}
        logs: dict[str, list] = {}
        for t in range(num_steps):
            mean, std, carry = policy.act(obs, carry)
            noise = step_noise(mean, action_noise, t, self.mesh, self.generator)
            action = distributions.sample(mean, std, noise, self.generator)
            log_p = distributions.log_prob(mean, std, action)
            value, carry = policy.value(obs, carry)

            env_state, next_obs, rew, done, extras = env.step(env_state, action)
            done_f = done.to(torch.float32)
            policy.update_normalization(next_obs)
            total_rew, irew = rew, torch.zeros_like(rew)
            if self.rnd is not None:
                # the intrinsic reward of the post-step obs
                self.rnd.update_normalization(next_obs)
                irew, _ = self.rnd.get_intrinsic_reward(next_obs)
                total_rew = rew + irew
            if "time_outs" in extras:
                total_rew = total_rew + self.gamma * value * extras["time_outs"].to(torch.float32)
            carry = policy.reset_carry(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, irew, done_f)
            for k, v in collect_extras_logs(extras).items():
                logs.setdefault(k, []).append(v)

            for k, v in (("obs", obs), ("actions", action), ("rewards", total_rew),
                         ("dones", done), ("values", value), ("log_probs", log_p),
                         ("mu", mean), ("sigma", std)):
                steps[k].append(v)
            obs = next_obs

        rollout = Rollout(
            obs={k: torch.stack([o[k] for o in steps["obs"]]) for k in steps["obs"][0]},
            **{k: torch.stack(v) for k, v in steps.items() if k != "obs"},
            carry0=carry0,
        )
        metrics = dict(acc)
        metrics["Policy/mean_noise_std"] = rollout.sigma.mean()
        if self.rnd is not None:
            metrics["Rnd/weight"] = self.rnd.current_weight(self.rnd.counter)
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean()
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, global_metrics(metrics, self.mesh)

    def make_host_collect_fn(self, env, num_steps_per_env: int, bridge=None):
        """The collection window for a host env (``env/host_env.py``):
        ``collect(cs, action_noise=None) -> (cs, rollout, metrics)``.

        Each step acts on the policy's device, copies the action to the
        host, steps the env there and copies obs, rewards, dones and
        time-outs back; then the normalizers fold in the new obs, RND adds
        its intrinsic reward, the time-outs add the ``gamma * value``
        bootstrap and the done envs' carries reset, all on the device. The
        episode bookkeeping runs on the host, on the env's own numpy
        rewards and dones. The window stacks into the time-major
        ``Rollout`` (with ``carry0`` for a recurrent policy) that
        :meth:`update` takes. ``action_noise [T, N, A]`` replaces the
        normal draws, as in :meth:`collect`. ``collect.timings``: set it to a
        dict to add each phase's seconds there (``host_collect.PHASES``).

        With a ``HostShardingBridge`` (``parallel/host_dp.py``) ``env`` is
        this rank's shard and the algorithm trains on the bridge's mesh
        (:meth:`distribute`): the noise is the global draw's rows, the
        normalizers take the global moments and ``Policy/mean_noise_std`` is
        global, while the episode statistics stay this rank's (rank 0 logs),
        as in ``host_dp.py:25-28``.
        """
        from rsl_rl_tpu_torch.algorithms.host_collect import (
            HostEpisodeTracker,
            PhaseTimer,
            host_step,
            stack_trajectory,
        )

        if bridge is not None:
            self.distribute(bridge.mesh)
        policy, rnd, device = self.policy, self.rnd, self.device

        @torch.no_grad()
        def collect(cs: CollectState, action_noise: torch.Tensor | None = None):
            timer = PhaseTimer(collect.timings, device)
            obs, carry = cs.obs, cs.carry
            carry0 = carry
            tracker = HostEpisodeTracker(cs.stats, device)
            # without RND the intrinsic reward is zero: a host buffer saves
            # a blocking copy from the device a step
            zero_irew = np.zeros(env.num_envs, np.float32)
            traj = {k: [] for k in ("obs", "actions", "rewards", "dones", "values", "log_probs", "mu", "sigma")}
            for t in range(num_steps_per_env):
                mean, std, carry = policy.act(obs, carry)
                noise = step_noise(mean, action_noise, t, self.mesh, self.generator)
                action = distributions.sample(mean, std, noise, self.generator)
                log_p = distributions.log_prob(mean, std, action)
                value, carry = policy.value(obs, carry)
                timer.mark("act")
                (next_obs, rew, done, time_outs), (rew_np, done_np, extras) = host_step(env, action, device, timer)

                policy.update_normalization(next_obs)
                irew = torch.zeros_like(rew)
                if rnd is not None:
                    rnd.update_normalization(next_obs)
                    irew, _ = rnd.get_intrinsic_reward(next_obs)
                total_rew = rew + irew + self.gamma * value * time_outs
                carry = policy.reset_carry(carry, done)
                for k, v in (("obs", obs), ("actions", action), ("rewards", total_rew), ("dones", done),
                             ("values", value), ("log_probs", log_p), ("mu", mean), ("sigma", std)):
                    traj[k].append(v)
                obs = next_obs
                tracker.step(rew_np, irew.cpu().numpy() if rnd is not None else zero_irew, done_np, extras)
                timer.mark("process")

            stacked = stack_trajectory(traj)
            if bridge is not None:
                stacked = bridge.constrain_time_major(stacked)
            rollout = Rollout(**stacked, carry0=carry0)
            metrics = tracker.metrics()
            local = list(metrics)
            metrics["Policy/mean_noise_std"] = rollout.sigma.mean()
            if rnd is not None:
                metrics["Rnd/weight"] = rnd.current_weight(rnd.counter)
            metrics = global_metrics(metrics, self.mesh, local)
            return CollectState(env_state=(), obs=obs, carry=carry, stats=tracker.stats()), rollout, metrics

        collect.timings = None
        return collect

    # ---------------------------------------------------------------- update

    def _row_count(self, rollout: Rollout) -> tuple[int, int]:
        """``(num_mini_batches, rows the permutation covers)`` of an update:
        a feedforward update shuffles ``num_mini_batches * mb`` of the
        window's ``T*N`` rows."""
        T, N = rollout.num_steps, rollout.num_envs * (1 if self.mesh is None else self.mesh.data_size)
        num_mini_batches = resolve_num_mini_batches(self.num_mini_batches, T, N, self.policy.is_recurrent)
        return num_mini_batches, num_mini_batches * ((T * N) // num_mini_batches)

    def update(self, cs: CollectState, rollout: Rollout, perm: torch.Tensor | None = None):
        """GAE + epochs x minibatches; returns ``(cs, metrics)`` (tensors).

        ``perm`` (feedforward only) is the permutation of the window's rows,
        drawn from the algorithm's generator when not given (to replay
        another implementation's); on a mesh, of the global window's rows
        ``[T, N_global]``, and the update is the data group's: this rank's
        fixed share of each global minibatch (:func:`dp_minibatches`), its
        loss with every mean over the global count."""
        policy = self.policy
        with torch.no_grad():
            # advances the critic memory, like the reference's stateful evaluate
            last_values, carry = policy.value(cs.obs, cs.carry)
            returns, advantages = compute_gae(
                rollout.rewards, rollout.values, rollout.dones, last_values,
                self.gamma, self.lam,
                normalize_advantage=not self.normalize_advantage_per_mini_batch,
                mesh=self.mesh,
            )
        cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        num_mini_batches, rows = self._row_count(rollout)
        if perm is None and not policy.is_recurrent:
            perm = torch.randperm(rows, generator=self.generator, device=self.device)
        mesh = self.mesh
        if mesh is None:
            batches = ((batch, carry0, 1, 1) for batch, carry0 in minibatches(
                policy, rollout, returns, advantages, num_mini_batches, self.num_learning_epochs, perm))
        else:
            batches = dp_minibatches(policy, rollout, returns, advantages, num_mini_batches,
                                     self.num_learning_epochs, perm, mesh)
        params = self.params + ([] if self.rnd is None else self.rnd_optimizer.params)
        outs: dict[str, list] = {}
        for batch, carry0, n_local, n_global in batches:
            if mesh is not None:
                # the global count of the minibatch's advantages, and this
                # rank's share of it (the loss means' divisor), both fixed
                # by the layout
                self._adv_count = (rollout.num_steps if policy.is_recurrent else 1) * n_global
                self._batch_ratio = n_global / max(n_local, 1)
            if n_local:
                loss, aux = self._loss(batch, carry0)
                grads = list(torch.autograd.grad(loss, params))
            else:
                # a rank with no share of the minibatch adds zeros (and
                # sums zeros into the per-minibatch advantage statistics)
                if self.normalize_advantage_per_mini_batch:
                    global_mean_std(torch.zeros(0, device=self.device), mesh, self._adv_count)
                grads = [torch.zeros_like(p) for p in params]
                aux = {k: torch.zeros((), device=self.device) for k in self._aux_keys()}
            if mesh is not None:
                # the gradients and the loss metrics summed over the data
                # group before the learning-rate rule, the clip and the step
                grads, aux = sum_with_grads(mesh, grads, {k: v.detach() for k, v in aux.items()})
            if self.desired_kl is not None and self.schedule == "adaptive":
                self._adapt_lr(aux["kl"])
            self.optimizer_step(grads[:len(self.params)], self.max_grad_norm)
            if self.rnd is not None:
                # the predictor's own Adam at the RND learning rate, unclipped
                self.rnd_optimizer.optimizer_step(grads[len(self.params):], None)
            for k, v in aux.items():
                outs.setdefault(k, []).append(v)
            outs.setdefault("learning_rate", []).append(self.lr.clone())
        metrics = {f"Loss/{k}": torch.stack(v).mean() for k, v in outs.items() if k != "learning_rate"}
        metrics["Loss/learning_rate"] = outs["learning_rate"][-1]
        return cs, metrics

    def _aux_keys(self) -> list[str]:
        """The loss metrics of a minibatch, in :meth:`_loss`'s order."""
        return (["value_function", "surrogate", "entropy", "kl"] + ["symmetry"] * (self.symmetry is not None)
                + ["rnd"] * (self.rnd is not None))

    # ------------------------------------------------------- G seeds at once

    def init_stacked_state(self, policies, num_envs: int | None = None) -> StackedTrainState:
        """Stack G policies (each its own init, the architecture of
        ``self.policy``) into a fresh training state: zero optimizer moments
        and count, every seed at the initial learning rate. With RND each
        seed also gets its own RND module (drawn from its own seed, its
        reward normalizer sized for ``num_envs`` envs) and a zero predictor
        optimizer state."""
        G = len(policies)
        ts = stack_trained(policies, G, self.learning_rate, self.device)
        if self.rnd is not None:
            rnds = [self.rnd] + [RandomNetworkDistillation(**self._rnd_cfg, device=self.device,
                                                           seed=self._rnd_seed + g) for g in range(1, G)]
            for rnd in rnds:
                rnd.init_reward_norm(num_envs)
            r = stack_trained(rnds, G, 0.0, self.device)
            ts.rnd_params, ts.rnd_buffers = r.params, r.buffers
            ts.rnd_mu, ts.rnd_nu, ts.rnd_count = r.adam_mu, r.adam_nu, r.adam_count
        return ts

    def init_stacked_collect_state(self, env_state, obs, num_seeds: int) -> CollectState:
        """``env_state`` flat over the ``G*E`` envs, ``obs`` ``[G, E, ...]``."""
        num_envs = next(iter(obs.values())).shape[1]
        return CollectState(
            env_state=env_state,
            obs=obs,
            carry=tree_map(lambda t: t.expand(num_seeds, *t.shape).clone(), self.policy.initial_carry(num_envs)),
            stats=EpisodeStats(*(torch.zeros(num_seeds, num_envs, device=self.device) for _ in range(4))),
        )

    @torch.no_grad()
    def collect_stacked(self, env, ts: StackedTrainState, cs: CollectState, num_steps: int,
                        action_noise: torch.Tensor | None = None):
        """:meth:`collect` for G seeds: returns ``(cs, rollout, metrics)`` with
        a leading ``[G]`` axis on the rollout (``[G, T, E, ...]``) and on every
        metric. The normalizer moments in ``ts.buffers`` (and the RND state in
        ``ts.rnd_buffers``) update in place, per seed. ``action_noise [G, T,
        E, A]`` replaces the normal draws, which are otherwise taken for all
        seeds at once, outside the batched policy."""
        call = partial(seed_call, self.policy, ts.params, ts.buffers)
        rnd_call = None if self.rnd is None else partial(seed_call, self.rnd, ts.rnd_params, ts.rnd_buffers)
        env_state, obs, carry, stats = cs.env_state, cs.obs, cs.carry, cs.stats
        G, E = stats.cur_reward_sum.shape
        carry0 = carry
        acc = {k: torch.zeros(G, device=self.device) for k in ACC_KEYS}
        steps = {k: [] for k in ("obs", "actions", "rewards", "dones", "values",
                                 "log_probs", "mu", "sigma")}
        logs: dict[str, list] = {}
        for t in range(num_steps):
            mean, std, carry = call("act", obs, carry)
            noise = None if action_noise is None else action_noise[:, t]
            action = distributions.sample(mean, std, noise, self.generator)
            log_p = distributions.log_prob(mean, std, action)
            value, carry = call("value", obs, carry)

            env_state, *out = env.step(env_state, action.reshape(G * E, -1))
            next_obs, rew, done, extras = tree_map(lambda x: x.reshape(G, E, *x.shape[1:]), out)
            done_f = done.to(torch.float32)
            call("update_normalization", next_obs, out_dims=None)
            total_rew, irew = rew, torch.zeros_like(rew)
            if rnd_call is not None:
                rnd_call("update_normalization", next_obs, out_dims=None)
                irew, _ = rnd_call("get_intrinsic_reward", next_obs)
                total_rew = rew + irew
            if "time_outs" in extras:
                total_rew = total_rew + self.gamma * value * extras["time_outs"].to(torch.float32)
            carry = vmap(self.policy.reset_carry)(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, irew, done_f)
            for k, v in vmap(collect_extras_logs)(extras).items():
                logs.setdefault(k, []).append(v)

            for k, v in (("obs", obs), ("actions", action), ("rewards", total_rew),
                         ("dones", done), ("values", value), ("log_probs", log_p),
                         ("mu", mean), ("sigma", std)):
                steps[k].append(v)
            obs = next_obs

        rollout = Rollout(
            obs={k: torch.stack([o[k] for o in steps["obs"]], dim=1) for k in steps["obs"][0]},
            **{k: torch.stack(v, dim=1) for k, v in steps.items() if k != "obs"},
            carry0=carry0,
        )
        metrics = dict(acc)
        metrics["Policy/mean_noise_std"] = rollout.sigma.flatten(1).mean(dim=1)
        if self.rnd is not None:
            metrics["Rnd/weight"] = vmap(self.rnd.current_weight)(ts.rnd_buffers["counter"])
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean(dim=0)
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, metrics

    def update_stacked(self, ts: StackedTrainState, cs: CollectState, rollout: Rollout,
                       perm: torch.Tensor | None = None):
        """:meth:`update` for G seeds, in place on ``ts`` (every tensor keeps
        its storage); returns ``(ts, cs, metrics)`` with ``[G]`` metrics. Every
        minibatch replays all seeds' memories in one batched call (the xproj
        kernels, through the replays' vmap rules: with symmetry augmentation
        the augmented batch, and the mirror loss's actor replay in another),
        takes one gradient of the summed per-seed losses, and steps each
        seed's learning rate, clip and optimizer on its own (and with RND
        each seed's predictor with its own optimizer). A feedforward policy
        shuffles each seed's rows by its own permutation, ``perm [G, rows]``
        (drawn when not given)."""
        call = partial(seed_call, self.policy, ts.params, ts.buffers)
        with torch.no_grad():
            last_values, carry = call("value", cs.obs, cs.carry)
            gae = partial(compute_gae, gamma=self.gamma, lam=self.lam,
                          normalize_advantage=not self.normalize_advantage_per_mini_batch)
            returns, advantages = vmap(gae)(rollout.rewards, rollout.values, rollout.dones, last_values)
        cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        names = ts.trained_names()
        rnd_names = [] if self.rnd is None else list(ts.rnd_mu)
        step = vmap(partial(clip_step, max_grad_norm=self.max_grad_norm, direction=self.direction))
        # the predictor's own Adam at the RND learning rate, unclipped
        rnd_step = vmap(partial(clip_step, max_grad_norm=None), in_dims=(0, 0, 0, 0, 0, None))
        rnd_dim = None if self.rnd is None else 0
        seed_loss = vmap(self._seed_loss, in_dims=(0, 0, rnd_dim, rnd_dim, 0, 0))
        num_mini_batches, rows = self._row_count(rollout)
        if perm is None and not self.policy.is_recurrent:
            G = ts.lr.shape[0]
            perm = torch.argsort(torch.rand(G, rows, generator=self.generator, device=self.device), dim=1)
        outs: dict[str, list] = {}
        for batch, carry0 in minibatches(self.policy, rollout, returns, advantages, num_mini_batches,
                                         self.num_learning_epochs, perm, seed_axis=True):
            loss, aux = seed_loss(ts.params, ts.buffers, ts.rnd_params, ts.rnd_buffers, batch, carry0)
            grads = torch.autograd.grad(loss.sum(), [ts.params[k] for k in names]
                                        + [ts.rnd_params[k] for k in rnd_names])
            with torch.no_grad():
                if self.desired_kl is not None and self.schedule == "adaptive":
                    ts.lr.copy_(adapt_lr(ts.lr, aux["kl"], self.desired_kl, self.min_lr, self.max_lr))
            stacked_step(step, ts.params, grads[:len(names)], ts.adam_mu, ts.adam_nu, ts.adam_count, ts.lr)
            if self.rnd is not None:
                stacked_step(rnd_step, ts.rnd_params, grads[len(names):], ts.rnd_mu, ts.rnd_nu, ts.rnd_count,
                             self.rnd_optimizer.lr)
            for k, v in aux.items():
                outs.setdefault(k, []).append(v.detach())
            outs.setdefault("learning_rate", []).append(ts.lr.clone())
        metrics = {f"Loss/{k}": torch.stack(v).mean(dim=0) for k, v in outs.items() if k != "learning_rate"}
        metrics["Loss/learning_rate"] = outs["learning_rate"][-1]
        return ts, cs, metrics

    @torch.no_grad()
    def _adapt_lr(self, kl_mean: torch.Tensor) -> None:
        self.lr.copy_(adapt_lr(self.lr, kl_mean, self.desired_kl, self.min_lr, self.max_lr))

    # ------------------------------------------------------------------ loss

    def _loss(self, batch: dict, carry0, state=None, rnd_state=None):
        """Per-minibatch loss over a ``[T, nb]`` window (feedforward: ``[B]``
        rows); returns ``(loss, aux)``. With symmetry augmentation the batch
        is extended by its symmetric copies first; the KL and the entropy
        then see the original part only. ``state`` and ``rnd_state`` (each
        ``(params, buffers)``) substitute one seed's policy and RND state
        (:func:`module_call`)."""
        policy, sym = self.policy, self.symmetry
        call = partial(module_call, policy, state)
        time_major = policy.is_recurrent
        obs, resets = batch["obs"], batch.get("resets")
        first = None
        if sym is not None and sym["use_data_augmentation"]:
            n = batch["actions"].shape[1 if time_major else 0]
            first = partial(_part, n=n, time_major=time_major, rest=False)
            obs, actions, num_aug = symmetry.apply_augmentation(
                sym["data_augmentation_func"], sym["_env"], obs, batch["actions"], time_major)
            batch = {**batch, "actions": actions, **{
                k: symmetry.tile_batch(batch[k], num_aug, time_major)
                for k in ("log_probs", "values", "advantages", "returns")}}
            if time_major:
                resets = symmetry.tile_batch(resets, num_aug, True)
                carry0 = symmetry.tile_carry(carry0, num_aug)
        mean, std, value = call("act_value_seq", obs, carry0, resets)
        loss, aux = self._loss_terms(mean, std, value, batch, first)
        if sym is not None:
            symmetry_loss = self._mirror_loss(call, batch["obs"], carry0, resets,
                                              mean if first is not None else None)
            if sym["use_mirror_loss"]:
                loss = loss + sym["mirror_loss_coeff"] * symmetry_loss
            aux["symmetry"] = symmetry_loss.detach()
        if self.rnd is not None:
            rnd_loss = module_call(self.rnd, rnd_state, "predictor_loss", batch["obs"], self._mean)
            loss = loss + rnd_loss
            aux["rnd"] = rnd_loss.detach()
        return loss, aux

    def _mirror_loss(self, call, obs, carry0, resets, mean_aug):
        """The mean squared difference between the actor's mean on each
        symmetric copy of the obs and the mirror of its mean on the original
        (the mirrored target is a constant). ``mean_aug`` is the augmented
        batch's mean when data augmentation already computed it (``carry0``
        and ``resets`` are then tiled); otherwise the actor replays the
        augmented obs (a constant) here through ``call``, with gradients in
        mirror-loss mode and without them when the loss is only logged."""
        sym, policy = self.symmetry, self.policy
        time_major = policy.is_recurrent
        fn, env = sym["data_augmentation_func"], sym["_env"]
        n = next(iter(obs.values())).shape[1 if time_major else 0]
        if mean_aug is None:
            obs_aug, _, num_aug = symmetry.apply_augmentation(fn, env, obs, None, time_major)
            obs_aug = {k: v.detach() for k, v in obs_aug.items()}
            if time_major:
                carry0 = symmetry.tile_carry(carry0, num_aug)
                resets = symmetry.tile_batch(resets, num_aug, True)
            with torch.set_grad_enabled(torch.is_grad_enabled() and sym["use_mirror_loss"]):
                mean_aug = call("act_seq", obs_aug, carry0, resets)[0]
        _, mirrored, _ = symmetry.apply_augmentation(fn, env, None, _part(mean_aug, n, time_major, False),
                                                      time_major)
        return self._mean(torch.square(_part(mean_aug, n, time_major, True)
                                       - _part(mirrored, n, time_major, True).detach()))

    def _seed_loss(self, params: dict, buffers: dict, rnd_params, rnd_buffers, batch: dict, carry0):
        """:meth:`_loss` of one seed with its policy and RND state substituted
        (vmapped over the seeds by :meth:`update_stacked`)."""
        rnd_state = None if rnd_params is None else (rnd_params, rnd_buffers)
        return self._loss(batch, carry0, (params, buffers), rnd_state)

    def _loss_terms(self, mean, std, value, batch: dict, first=None):
        """The loss of a minibatch from the replayed policy outputs. With
        ``first`` (symmetry augmentation) the per-sample targets are tiled
        over the copies, and ``first`` takes the original part: the KL and the
        entropy see it alone, and the per-minibatch advantage normalization
        uses its statistics (on a mesh the global minibatch's)."""
        first = first or (lambda x: x)
        mean_of = self._mean
        advantages = batch["advantages"]
        if self.normalize_advantage_per_mini_batch:
            orig = first(advantages)
            adv_mean, adv_std = global_mean_std(orig, self.mesh, self._adv_count)
            advantages = (advantages - adv_mean) / (adv_std + 1e-8)
        logp = distributions.log_prob(mean, std, batch["actions"])
        entropy_mean = mean_of(distributions.entropy(first(std)))
        kl_mean = mean_of(distributions.kl_divergence(
            batch["mu"], batch["sigma"], first(mean).detach(), first(std).detach()
        ))

        ratio = torch.exp(logp - batch["log_probs"])
        surrogate = -advantages * ratio
        surrogate_clipped = -advantages * torch.clamp(
            ratio, 1.0 - self.clip_param, 1.0 + self.clip_param
        )
        surrogate_loss = mean_of(torch.maximum(surrogate, surrogate_clipped))

        returns, target_values = batch["returns"], batch["values"]
        if self.use_clipped_value_loss:
            value_clipped = target_values + torch.clamp(
                value - target_values, -self.clip_param, self.clip_param
            )
            value_loss = mean_of(torch.maximum(
                torch.square(value - returns), torch.square(value_clipped - returns)
            ))
        else:
            value_loss = mean_of(torch.square(returns - value))

        loss = surrogate_loss + self.value_loss_coef * value_loss - self.entropy_coef * entropy_mean
        aux = {
            "value_function": value_loss.detach(),
            "surrogate": surrogate_loss.detach(),
            "entropy": entropy_mean.detach(),
            "kl": kl_mean,
        }
        return loss, aux


def _part(x: torch.Tensor, n: int, time_major: bool, rest: bool) -> torch.Tensor:
    """The original part (the first ``n`` along the batch axis, axis 1 when
    time-major) of an augmented batch array, or with ``rest`` the copies."""
    axis = 1 if time_major else 0
    return x.narrow(axis, n, x.shape[axis] - n) if rest else x.narrow(axis, 0, n)
