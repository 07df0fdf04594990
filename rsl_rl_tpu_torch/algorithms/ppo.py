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
  adaptive-KL learning rate, the global-norm clip and Adam with the formulas
  of the optax chain the JAX package uses (``clip_by_global_norm`` then
  ``scale_by_adam``, applied as ``p - lr * u``).
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

RND, symmetry and other optimizers are not ported yet and raise when
configured.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial
from typing import Any

import torch
from torch.func import functional_call, stack_module_state, vmap

from rsl_rl_tpu_torch.modules.policy import check_state_compatible, seed_call
from rsl_rl_tpu_torch.ops import distributions
from rsl_rl_tpu_torch.ops.gae import compute_gae
from rsl_rl_tpu_torch.storage.rollout import Rollout, recurrent_minibatch_starts, slice_envs, tree_map
from rsl_rl_tpu_torch.utils.registry import register


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
    and ``adam_nu`` the Adam moments by the same names; ``adam_count [G]``
    and ``lr [G]`` each seed's Adam step count and adaptive learning rate.
    """

    params: dict[str, torch.Tensor]
    buffers: dict[str, torch.Tensor]
    adam_mu: dict[str, torch.Tensor]
    adam_nu: dict[str, torch.Tensor]
    adam_count: torch.Tensor
    lr: torch.Tensor


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
    contiguous slices. Columns, in order: the obs groups by sorted name,
    ``actions``, ``values``, ``returns``, ``advantages``, ``log_probs``,
    ``mu``, ``sigma``. With a leading seed axis (``perm [G, n]``, every
    field ``[G, T, N, ...]``) each seed gathers its own rows: ``packed [G,
    n, F]``. ``unpack(rows)`` splits a block of packed rows ``[..., B, F]``
    back into the batch dict, each field in its own dtype (scalar fields
    ``[..., B]``), with no ``resets``.
    """
    lead = tuple(perm.shape[:-1])
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
    packed = torch.take_along_dim(torch.cat(flats, dim=-1), perm.to(torch.int64)[..., None], dim=-2)

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


def adapt_lr(lr, kl_mean, desired_kl: float, min_lr: float, max_lr: float):
    """The adaptive-KL learning-rate rule, elementwise (one rate per seed)."""
    up = torch.clamp(lr * 1.5, max=max_lr)
    down = torch.clamp(lr / 1.5, min=min_lr)
    return torch.where(
        kl_mean > desired_kl * 2.0,
        down,
        torch.where((kl_mean < desired_kl / 2.0) & (kl_mean > 0.0), up, lr),
    )


def clip_adam(params, grads, mu, nu, count, lr, max_grad_norm: float | None, clip_mask=None):
    """``clip_by_global_norm`` -> ``scale_by_adam`` -> ``p - lr * u`` with
    optax's formulas (the clip scales by ``max_norm / norm`` only when
    ``norm >= max_norm``; b1=0.9, b2=0.999, eps=1e-8, eps_root=0) for one
    seed. ``clip_mask`` (one bool a parameter) limits the clip, its norm
    and its scaling to the marked parameters (``optax.masked``). Pure, so
    ``torch.func.vmap`` runs it for G seeds, each with its own norm. Returns
    the new ``(params, mu, nu, count)``."""
    grads = list(grads)
    if max_grad_norm is not None:
        mask = [True] * len(grads) if clip_mask is None else list(clip_mask)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g, m in zip(grads, mask) if m))
        keep = g_norm < max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * max_grad_norm) if m else g for g, m in zip(grads, mask)]
    b1, b2, eps = 0.9, 0.999, 1e-8
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, mu)]
    nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
    params = [p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for p, m, v in zip(params, mu, nu)]
    return params, mu, nu, count


class AdamTrainer:
    """What an algorithm trains with Adam: the named parameters
    ``param_names`` / ``params``, their optax ``scale_by_adam`` moments and
    step count, and the learning rate ``lr``, with the clipped step in place
    and the checkpoint form of the optimizer state."""

    def _init_adam(self, named_params, learning_rate: float, device) -> None:
        named = list(named_params)
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)
        # optax.scale_by_adam state (b1=0.9, b2=0.999, eps=1e-8, eps_root=0)
        self.adam_count = torch.zeros((), dtype=torch.int32, device=device)
        self.adam_mu = [torch.zeros_like(p) for p in self.params]
        self.adam_nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def _apply(self, grads, max_grad_norm: float | None, clip_mask=None) -> None:
        """The clipped Adam step (:func:`clip_adam`), in place: every tensor
        of the optimizer keeps its storage (a CUDA graph replays addresses)."""
        params, mu, nu, count = clip_adam(self.params, grads, self.adam_mu, self.adam_nu,
                                          self.adam_count, self.lr, max_grad_norm, clip_mask)
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


@register("algorithm")
class PPO(AdamTrainer):
    """Clipped-surrogate PPO with the adaptive-KL learning rate."""

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
        if rnd_cfg is not None:
            raise NotImplementedError("RND is not ported yet (ROADMAP.md Queue 1, 'PPO options')")
        if symmetry_cfg is not None:
            raise NotImplementedError(
                "symmetry is not ported yet (ROADMAP.md Queue 1, 'PPO options')"
            )
        if optimizer.lower() != "adam":
            raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet; use 'adam'")
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
        self._init_adam(policy.named_parameters(), learning_rate, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    # --------------------------------------------------------------- collect

    def init_collect_state(self, env_state, obs, num_envs: int) -> CollectState:
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
        action sampling (to replay another implementation's noise).
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
            noise = None if action_noise is None else action_noise[t]
            action = distributions.sample(mean, std, noise, self.generator)
            log_p = distributions.log_prob(mean, std, action)
            value, carry = policy.value(obs, carry)

            env_state, next_obs, rew, done, extras = env.step(env_state, action)
            done_f = done.to(torch.float32)
            policy.update_normalization(next_obs)
            total_rew = rew
            if "time_outs" in extras:
                total_rew = rew + self.gamma * value * extras["time_outs"].to(torch.float32)
            carry = policy.reset_carry(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, torch.zeros_like(rew), done_f)
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
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean()
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, metrics

    # ---------------------------------------------------------------- update

    def _row_count(self, rollout: Rollout) -> tuple[int, int]:
        """``(num_mini_batches, rows the permutation covers)`` of an update:
        a feedforward update shuffles ``num_mini_batches * mb`` of the
        window's ``T*N`` rows."""
        T, N = rollout.num_steps, rollout.num_envs
        num_mini_batches = resolve_num_mini_batches(self.num_mini_batches, T, N, self.policy.is_recurrent)
        return num_mini_batches, num_mini_batches * ((T * N) // num_mini_batches)

    def update(self, cs: CollectState, rollout: Rollout, perm: torch.Tensor | None = None):
        """GAE + epochs x minibatches; returns ``(cs, metrics)`` (tensors).

        ``perm`` (feedforward only) is the permutation of the window's rows,
        drawn from the algorithm's generator when not given (to replay
        another implementation's)."""
        policy = self.policy
        with torch.no_grad():
            # advances the critic memory, like the reference's stateful evaluate
            last_values, carry = policy.value(cs.obs, cs.carry)
            returns, advantages = compute_gae(
                rollout.rewards, rollout.values, rollout.dones, last_values,
                self.gamma, self.lam,
                normalize_advantage=not self.normalize_advantage_per_mini_batch,
            )
        cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        num_mini_batches, rows = self._row_count(rollout)
        if perm is None and not policy.is_recurrent:
            perm = torch.randperm(rows, generator=self.generator, device=self.device)
        outs: dict[str, list] = {}
        for batch, carry0 in minibatches(policy, rollout, returns, advantages, num_mini_batches,
                                         self.num_learning_epochs, perm):
            loss, aux = self._loss(batch, carry0)
            grads = torch.autograd.grad(loss, self.params)
            if self.desired_kl is not None and self.schedule == "adaptive":
                self._adapt_lr(aux["kl"])
            self._apply(grads, self.max_grad_norm)
            for k, v in aux.items():
                outs.setdefault(k, []).append(v)
            outs.setdefault("learning_rate", []).append(self.lr.clone())
        metrics = {f"Loss/{k}": torch.stack(v).mean() for k, v in outs.items() if k != "learning_rate"}
        metrics["Loss/learning_rate"] = outs["learning_rate"][-1]
        return cs, metrics

    # ------------------------------------------------------- G seeds at once

    def init_stacked_state(self, policies) -> StackedTrainState:
        """Stack G policies (each its own init, the architecture of
        ``self.policy``) into a fresh training state: zero Adam moments and
        count, every seed at the initial learning rate."""
        params, buffers = stack_module_state(list(policies))
        G = len(policies)
        return StackedTrainState(
            params=params,
            buffers=buffers,
            adam_mu={k: torch.zeros_like(v) for k, v in params.items()},
            adam_nu={k: torch.zeros_like(v) for k, v in params.items()},
            adam_count=torch.zeros(G, dtype=torch.int32, device=self.device),
            lr=torch.full((G,), self.learning_rate, dtype=torch.float32, device=self.device),
        )

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
        metric. The normalizer moments in ``ts.buffers`` update in place, per
        seed. ``action_noise [G, T, E, A]`` replaces the normal draws, which
        are otherwise taken for all seeds at once, outside the batched policy."""
        call = partial(seed_call, self.policy, ts.params, ts.buffers)
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
            total_rew = rew
            if "time_outs" in extras:
                total_rew = rew + self.gamma * value * extras["time_outs"].to(torch.float32)
            carry = vmap(self.policy.reset_carry)(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, torch.zeros_like(rew), done_f)
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
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean(dim=0)
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, metrics

    def update_stacked(self, ts: StackedTrainState, cs: CollectState, rollout: Rollout,
                       perm: torch.Tensor | None = None):
        """:meth:`update` for G seeds, in place on ``ts`` (every tensor keeps
        its storage); returns ``(ts, cs, metrics)`` with ``[G]`` metrics. Every minibatch replays all seeds'
        memories in one batched call (the xproj kernels, through the replays'
        vmap rules), takes one gradient of the summed per-seed losses, and
        steps each seed's learning rate, clip and Adam on its own. A
        feedforward policy shuffles each seed's rows by its own permutation,
        ``perm [G, rows]`` (drawn when not given)."""
        call = partial(seed_call, self.policy, ts.params, ts.buffers)
        with torch.no_grad():
            last_values, carry = call("value", cs.obs, cs.carry)
            gae = partial(compute_gae, gamma=self.gamma, lam=self.lam,
                          normalize_advantage=not self.normalize_advantage_per_mini_batch)
            returns, advantages = vmap(gae)(rollout.rewards, rollout.values, rollout.dones, last_values)
        cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        names = list(ts.params)
        step = vmap(partial(clip_adam, max_grad_norm=self.max_grad_norm))
        num_mini_batches, rows = self._row_count(rollout)
        if perm is None and not self.policy.is_recurrent:
            G = ts.lr.shape[0]
            perm = torch.argsort(torch.rand(G, rows, generator=self.generator, device=self.device), dim=1)
        outs: dict[str, list] = {}
        for batch, carry0 in minibatches(self.policy, rollout, returns, advantages, num_mini_batches,
                                         self.num_learning_epochs, perm, seed_axis=True):
            loss, aux = vmap(self._seed_loss)(ts.params, ts.buffers, batch, carry0)
            grads = torch.autograd.grad(loss.sum(), [ts.params[k] for k in names])
            with torch.no_grad():
                if self.desired_kl is not None and self.schedule == "adaptive":
                    ts.lr.copy_(adapt_lr(ts.lr, aux["kl"], self.desired_kl, self.min_lr, self.max_lr))
                params, mu, nu, count = step(
                    [ts.params[k] for k in names], grads, [ts.adam_mu[k] for k in names],
                    [ts.adam_nu[k] for k in names], ts.adam_count, ts.lr)
                ts.adam_count.copy_(count)
                for k, p, m, v in zip(names, params, mu, nu):
                    ts.params[k].copy_(p)
                    ts.adam_mu[k].copy_(m)
                    ts.adam_nu[k].copy_(v)
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

    def _loss(self, batch: dict, carry0):
        """Per-minibatch loss over a ``[T, nb]`` window; returns ``(loss, aux)``."""
        mean, std, value = self.policy.act_value_seq(batch["obs"], carry0, batch.get("resets"))
        return self._loss_terms(mean, std, value, batch)

    def _seed_loss(self, params: dict, buffers: dict, batch: dict, carry0):
        """:meth:`_loss` of one seed with its policy state substituted (vmapped
        over the seeds by :meth:`update_stacked`)."""
        mean, std, value = functional_call(
            self.policy, (params, buffers), ("act_value_seq", batch["obs"], carry0, batch.get("resets")))
        return self._loss_terms(mean, std, value, batch)

    def _loss_terms(self, mean, std, value, batch: dict):
        """The loss of a minibatch from the replayed policy outputs."""
        advantages = batch["advantages"]
        if self.normalize_advantage_per_mini_batch:
            advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        logp = distributions.log_prob(mean, std, batch["actions"])
        entropy_mean = distributions.entropy(std).mean()
        kl_mean = distributions.kl_divergence(
            batch["mu"], batch["sigma"], mean.detach(), std.detach()
        ).mean()

        ratio = torch.exp(logp - batch["log_probs"])
        surrogate = -advantages * ratio
        surrogate_clipped = -advantages * torch.clamp(
            ratio, 1.0 - self.clip_param, 1.0 + self.clip_param
        )
        surrogate_loss = torch.maximum(surrogate, surrogate_clipped).mean()

        returns, target_values = batch["returns"], batch["values"]
        if self.use_clipped_value_loss:
            value_clipped = target_values + torch.clamp(
                value - target_values, -self.clip_param, self.clip_param
            )
            value_loss = torch.maximum(
                torch.square(value - returns), torch.square(value_clipped - returns)
            ).mean()
        else:
            value_loss = torch.square(returns - value).mean()

        loss = surrogate_loss + self.value_loss_coef * value_loss - self.entropy_coef * entropy_mean
        aux = {
            "value_function": value_loss.detach(),
            "surrogate": surrogate_loss.detach(),
            "entropy": entropy_mean.detach(),
            "kl": kl_mean,
        }
        return loss, aux
