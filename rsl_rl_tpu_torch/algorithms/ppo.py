"""Proximal Policy Optimization for recurrent policies (counterpart of
``rsl_rl_tpu/algorithms/ppo.py``).

- :meth:`PPO.collect` runs the rollout window step by step: act, sample,
  log-prob, value, env step, normalizer update on the post-step obs, timeout
  bootstrap, carry reset of done envs and episode bookkeeping, all on the
  policy's device with no host sync.
- :meth:`PPO.update` computes GAE, then runs epochs x minibatches of
  contiguous env slices, replaying each window from its start carry. Each
  step applies the clipped surrogate + clipped value loss - entropy, the
  adaptive-KL learning rate, the global-norm clip and Adam with the formulas
  of the optax chain the JAX package uses (``clip_by_global_norm`` then
  ``scale_by_adam``, applied as ``p - lr * u``).

RND, symmetry, the feedforward update and other optimizers are not ported yet
and raise when configured.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import torch

from rsl_rl_tpu_torch.ops import distributions
from rsl_rl_tpu_torch.ops.gae import compute_gae
from rsl_rl_tpu_torch.storage.rollout import Rollout, recurrent_minibatch_starts, slice_envs
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
    """Env state, current obs, policy carry and episode sums between windows."""

    env_state: Any
    obs: dict[str, torch.Tensor]
    carry: Any
    stats: EpisodeStats


ACC_KEYS = ("ep_reward_sum", "ep_length_sum", "ep_ereward_sum", "ep_ireward_sum", "ep_count")


def init_episode_stats(num_envs: int, device) -> EpisodeStats:
    return EpisodeStats(*(torch.zeros(num_envs, device=device) for _ in range(4)))


def step_episode_stats(stats: EpisodeStats, acc: dict, rew, irew, done_f):
    """Advance the per-env episode sums one step and fold the episodes that
    ended this step into the window totals ``acc``."""
    stats = EpisodeStats(
        cur_reward_sum=stats.cur_reward_sum + rew + irew,
        cur_episode_length=stats.cur_episode_length + 1.0,
        cur_ereward_sum=stats.cur_ereward_sum + rew,
        cur_ireward_sum=stats.cur_ireward_sum + irew,
    )
    acc = {
        "ep_reward_sum": acc["ep_reward_sum"] + torch.sum(stats.cur_reward_sum * done_f),
        "ep_length_sum": acc["ep_length_sum"] + torch.sum(stats.cur_episode_length * done_f),
        "ep_ereward_sum": acc["ep_ereward_sum"] + torch.sum(stats.cur_ereward_sum * done_f),
        "ep_ireward_sum": acc["ep_ireward_sum"] + torch.sum(stats.cur_ireward_sum * done_f),
        "ep_count": acc["ep_count"] + torch.sum(done_f),
    }
    keep = 1.0 - done_f
    stats = EpisodeStats(*(getattr(stats, f.name) * keep for f in fields(EpisodeStats)))
    return stats, acc


def collect_extras_logs(extras: dict) -> dict[str, torch.Tensor]:
    """Per-step means of the env's ``episode`` (preferred) or ``log`` extras."""
    group = extras.get("episode", extras.get("log", {}))
    return {k: torch.as_tensor(v, dtype=torch.float32).mean() for k, v in group.items()}


@register("algorithm")
class PPO:
    """Clipped-surrogate PPO with the adaptive-KL learning rate."""

    def __init__(
        self,
        policy,
        num_learning_epochs: int = 5,
        num_mini_batches: int = 4,
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
        if not policy.is_recurrent:
            raise NotImplementedError(
                "the feedforward PPO update is not ported yet (ROADMAP.md Queue 1,"
                " 'Feedforward PPO')"
            )
        self.policy = policy
        self.device = policy.device
        self.num_learning_epochs = num_learning_epochs
        self.num_mini_batches = int(num_mini_batches)
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

        self.params = list(policy.parameters())
        self.lr = torch.tensor(learning_rate, dtype=torch.float32, device=self.device)
        # optax.scale_by_adam state (b1=0.9, b2=0.999, eps=1e-8, eps_root=0)
        self.adam_count = torch.zeros((), dtype=torch.int32, device=self.device)
        self.adam_mu = [torch.zeros_like(p) for p in self.params]
        self.adam_nu = [torch.zeros_like(p) for p in self.params]
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

    def update(self, cs: CollectState, rollout: Rollout):
        """GAE + epochs x minibatches; returns ``(cs, metrics)`` (tensors)."""
        policy = self.policy
        N = rollout.num_envs
        with torch.no_grad():
            # advances the critic memory, like the reference's stateful evaluate
            last_values, carry = policy.value(cs.obs, cs.carry)
            returns, advantages = compute_gae(
                rollout.rewards, rollout.values, rollout.dones, last_values,
                self.gamma, self.lam,
                normalize_advantage=not self.normalize_advantage_per_mini_batch,
            )
        cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        data = {
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
        nb = N // self.num_mini_batches
        outs: dict[str, list] = {}
        for start in recurrent_minibatch_starts(N, self.num_mini_batches, self.num_learning_epochs):
            batch = slice_envs(data, start, nb)
            carry0 = slice_envs(rollout.carry0, start, nb, axis=0)
            loss, aux = self._loss(batch, carry0)
            grads = torch.autograd.grad(loss, self.params)
            if self.desired_kl is not None and self.schedule == "adaptive":
                self._adapt_lr(aux["kl"])
            self._apply(grads)
            for k, v in aux.items():
                outs.setdefault(k, []).append(v)
            outs.setdefault("learning_rate", []).append(self.lr.clone())
        metrics = {f"Loss/{k}": torch.stack(v).mean() for k, v in outs.items() if k != "learning_rate"}
        metrics["Loss/learning_rate"] = outs["learning_rate"][-1]
        return cs, metrics

    @torch.no_grad()
    def _adapt_lr(self, kl_mean: torch.Tensor) -> None:
        lr = self.lr
        up = torch.clamp(lr * 1.5, max=self.max_lr)
        down = torch.clamp(lr / 1.5, min=self.min_lr)
        lr = torch.where(
            kl_mean > self.desired_kl * 2.0,
            down,
            torch.where((kl_mean < self.desired_kl / 2.0) & (kl_mean > 0.0), up, lr),
        )
        self.lr = lr

    @torch.no_grad()
    def _apply(self, grads) -> None:
        """``clip_by_global_norm`` -> ``scale_by_adam`` -> ``p -= lr * u``,
        with optax's formulas (the clip scales by ``max_norm / norm`` only
        when ``norm >= max_norm``)."""
        grads = list(grads)
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.adam_count = self.adam_count + 1
        count = self.adam_count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=self.device), count)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=self.device), count)
        for p, g, mu, nu in zip(self.params, grads, self.adam_mu, self.adam_nu):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.sub_(self.lr * u)

    # ------------------------------------------------------------------ loss

    def _loss(self, batch: dict, carry0):
        """Per-minibatch loss over a ``[T, nb]`` window; returns ``(loss, aux)``."""
        advantages = batch["advantages"]
        if self.normalize_advantage_per_mini_batch:
            advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        mean, std, value = self.policy.act_value_seq(batch["obs"], carry0, batch["resets"])
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
