"""Student-teacher distillation (behavior cloning) with truncated BPTT
(counterpart of ``rsl_rl_tpu/algorithms/distillation.py``).

- :meth:`Distillation.collect` runs the window step by step: the student
  acts (sampled; ``action_noise`` replaces the normal draws, to replay
  another implementation's noise), the teacher's action is recorded as
  ``privileged_actions``, the env steps, the student's normalizer folds in
  the post-step obs and done envs' carries reset.
- :meth:`Distillation.update` replays the window through the student and
  takes an optimizer step every ``gradient_length`` replayed steps. The
  epochs are laid end to end; each gradient segment is split at epoch
  boundaries (where the carry rewinds to the window-start carry) into
  chunks of contiguous steps, each replayed in one call of
  ``policy.student_seq`` (for a recurrent student one launch per kernel of
  the x-streaming replay). The carry is detached between segments; steps
  that fill no segment are replayed forward only and count in the logged
  mean; the acting carry continues from the end of the replay.

:meth:`Distillation.collect_stacked` / :meth:`Distillation.update_stacked`
do the same for G seeds at once (a multi-seed distillation study, the
counterpart of ``jax.vmap`` over the JAX package's collect and update): the
students (and the frozen teachers, which a study loads once for every seed)
stack on a leading ``[G]`` axis (``algorithms.ppo.StackedTrainState``), the
policy runs through ``torch.func.vmap``, and each chunk of the replay is one
batched call for all seeds (the recurrent student's replay takes the xproj
kernels with the seeds as streams).

The loss is the per-step mean of the elementwise ``mse`` or ``huber``
(delta 1, optax's ``huber_loss``) error, summed over a segment. The
optimizer (``adam``, ``adamw``, ``sgd`` or ``rmsprop``) as in PPO, applied as
``p - lr * u`` at the constant learning rate; ``max_grad_norm`` clips the
``student`` MLP's gradients only, by their own global norm (``optax.masked``):
the memory and the std are not clipped. The JAX package also has a per-step scan form of the update for
configs with very many segments, a compile-time workaround for XLA with the
same math; the port keeps the chunked form only.

On a mesh (:meth:`Distillation.distribute`, as ``algorithms/ppo.py``'s) each
data rank replays its env shard: the per-step loss is this rank's share of
the global mean, the gradients are summed over the data group before each
step and the logged loss is the global one.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.func import functional_call, vmap

from rsl_rl_tpu_torch.algorithms.ppo import (
    ACC_KEYS,
    PPO,
    CollectState,
    StackedTrainState,
    Trainer,
    clip_step,
    collect_extras_logs,
    distribute,
    global_metrics,
    stack_trained,
    stacked_step,
    step_episode_stats,
    step_noise,
    sum_with_grads,
)
from rsl_rl_tpu_torch.modules.policy import seed_call
from rsl_rl_tpu_torch.networks.memory import mask_carry
from rsl_rl_tpu_torch.ops import distributions
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils import trace
from rsl_rl_tpu_torch.utils.registry import register


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss, optax's formula: ``0.5 q^2 + delta (|e| - q)``
    with ``q = min(|e|, delta)``."""
    abs_err = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def chunks_between(s0: int, s1: int, T: int) -> list[tuple[int, int]]:
    """The window steps ``[t0, t1)`` of global replay steps ``[s0, s1)``
    (step ``s`` replays window step ``s % T``), split where a new epoch
    starts."""
    out, s = [], s0
    while s < s1:
        t = s % T
        n = min(s1 - s, T - t)
        out.append((t, t + n))
        s += n
    return out


@register("algorithm")
class Distillation(Trainer):
    """Behavior cloning of the teacher's actions with truncated BPTT."""

    def __init__(
        self,
        policy,
        num_learning_epochs: int = 1,
        gradient_length: int = 15,
        learning_rate: float = 1e-3,
        max_grad_norm: float | None = None,
        loss_type: str = "mse",
        optimizer: str = "adam",
        seed: int = 0,
        **kwargs,
    ):
        if kwargs:
            print(
                "Distillation.__init__ got unexpected arguments, which will be ignored: "
                + str(list(kwargs.keys()))
            )
        if loss_type == "mse":
            self._elem_loss = lambda a, b: torch.square(a - b)
        elif loss_type == "huber":
            self._elem_loss = huber_loss
        else:
            raise ValueError(f"Unknown loss type: {loss_type}. Supported types are: ['mse', 'huber']")
        self.policy = policy
        self.device = policy.device
        self.num_learning_epochs = num_learning_epochs
        self.gradient_length = gradient_length
        self.learning_rate = learning_rate
        # the reference clips the student MLP only; a falsy norm clips nothing
        self.max_grad_norm = max_grad_norm if max_grad_norm else None
        # the teacher (and its memory) require no gradient: not trained
        super().__init__([(n, p) for n, p in policy.named_parameters() if p.requires_grad], learning_rate,
                         self.device, optimizer)
        self.clip_mask = [n.startswith("student.") for n in self.param_names]
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    # the collect state is PPO's (with no RND reward normalizer to size)
    init_collect_state = PPO.init_collect_state
    init_stacked_collect_state = PPO.init_stacked_collect_state
    rnd = None

    def distribute(self, mesh) -> None:
        """Train on ``mesh`` (``parallel/mesh.py``): this process is one rank,
        its envs one data shard."""
        distribute(self, mesh)

    # --------------------------------------------------------------- collect

    @torch.no_grad()
    def collect(self, env, cs: CollectState, num_steps: int, action_noise: torch.Tensor | None = None):
        """Run one window; returns ``(cs, rollout, metrics)``.

        ``action_noise [T, N, A]`` replaces the standard normal draws of the
        student's action sampling (on a mesh the global ``[T, N_global, A]``;
        the metrics are the data group's)."""
        policy = self.policy
        env_state, obs, carry, stats = cs.env_state, cs.obs, cs.carry, cs.stats
        carry0 = carry
        acc = {k: torch.zeros((), device=self.device) for k in ACC_KEYS}
        steps = {k: [] for k in ("obs", "actions", "privileged_actions", "rewards", "dones", "std")}
        logs: dict[str, list] = {}
        for t in range(num_steps):
            mean, std, carry = policy.act(obs, carry)
            noise = step_noise(mean, action_noise, t, self.mesh, self.generator)
            action = distributions.sample(mean, std, noise, self.generator)
            privileged, carry = policy.evaluate(obs, carry)

            env_state, next_obs, rew, done, extras = env.step(env_state, action)
            policy.update_normalization(next_obs)
            carry = policy.reset_carry(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, torch.zeros_like(rew), done.to(torch.float32))
            for k, v in collect_extras_logs(extras).items():
                logs.setdefault(k, []).append(v)

            for k, v in (("obs", obs), ("actions", action), ("privileged_actions", privileged),
                         ("rewards", rew), ("dones", done), ("std", std.mean())):
                steps[k].append(v)
            obs = next_obs

        rollout = Rollout(
            obs={k: torch.stack([o[k] for o in steps["obs"]]) for k in steps["obs"][0]},
            **{k: torch.stack(steps[k]) for k in ("actions", "privileged_actions", "rewards", "dones")},
            carry0=carry0,
        )
        metrics = dict(acc)
        metrics["Policy/mean_noise_std"] = torch.stack(steps["std"]).mean()
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean()
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, global_metrics(metrics, self.mesh)

    def make_host_collect_fn(self, env, num_steps_per_env: int, bridge=None):
        """The collection window for a host env: ``collect(cs,
        action_noise=None) -> (cs, rollout, metrics)``, the loop of
        ``PPO.make_host_collect_fn`` with the student's sampled action, the
        teacher's action recorded as ``privileged_actions``, and a step's
        processing the student's normalizer update and the done envs' carry
        reset. The tracer's phases and a ``bridge`` as there."""
        from rsl_rl_tpu_torch.algorithms.host_collect import HostEpisodeTracker, host_step, stack_trajectory

        if bridge is not None:
            self.distribute(bridge.mesh)
        policy, device = self.policy, self.device

        @torch.no_grad()
        def collect(cs: CollectState, action_noise: torch.Tensor | None = None):
            obs, carry = cs.obs, cs.carry
            carry0 = carry
            tracker = HostEpisodeTracker(cs.stats, device)
            zero_irew = np.zeros(env.num_envs, np.float32)
            traj = {k: [] for k in ("obs", "actions", "privileged_actions", "rewards", "dones")}
            stds = []
            for t in range(num_steps_per_env):
                with trace.interval("act"):
                    mean, std, carry = policy.act(obs, carry)
                    noise = step_noise(mean, action_noise, t, self.mesh, self.generator)
                    action = distributions.sample(mean, std, noise, self.generator)
                    privileged, carry = policy.evaluate(obs, carry)
                (next_obs, rew, done, _), (rew_np, done_np, extras) = host_step(env, action, device)
                with trace.interval("process"):
                    policy.update_normalization(next_obs)
                    carry = policy.reset_carry(carry, done)
                    for k, v in (("obs", obs), ("actions", action), ("privileged_actions", privileged),
                                 ("rewards", rew), ("dones", done)):
                        traj[k].append(v)
                    stds.append(std.mean())
                    obs = next_obs
                    tracker.step(rew_np, zero_irew, done_np, extras)

            stacked = stack_trajectory(traj)
            if bridge is not None:
                stacked = bridge.constrain_time_major(stacked)
            rollout = Rollout(**stacked, carry0=carry0)
            metrics = tracker.metrics()
            local = list(metrics)
            metrics["Policy/mean_noise_std"] = torch.stack(stds).mean()
            metrics = global_metrics(metrics, self.mesh, local)
            return CollectState(env_state=(), obs=obs, carry=carry, stats=tracker.stats()), rollout, metrics

        return collect

    # ---------------------------------------------------------------- update

    def _per_step_loss(self, actions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-step loss means of a ``[g, N, A]`` chunk: ``[g]`` (on a mesh this
        rank's share of the global means, over equal shards)."""
        err = self._elem_loss(actions, targets)
        dims = tuple(range(1, err.ndim))
        if self.mesh is None:
            return err.mean(dim=dims)
        return err.mean(dim=dims) / self.mesh.data_size

    def _replay(self, rollout: Rollout, resets, carry0, carry, chunks):
        """The student's per-step losses over ``chunks`` of the window and the
        carry after them; the carry rewinds to ``carry0`` where a chunk
        starts an epoch."""
        losses = []
        for t0, t1 in chunks:
            if t0 == 0:
                carry = carry0
            obs = {k: v[t0:t1] for k, v in rollout.obs.items()}
            actions, carry = self.policy.student_seq(obs, carry, resets[t0:t1])
            losses.append(self._per_step_loss(actions, rollout.privileged_actions[t0:t1]))
        return torch.cat(losses), carry

    def update(self, cs: CollectState, rollout: Rollout):
        """Truncated-BPTT behavior cloning over the window; returns ``(cs,
        metrics)`` (tensors)."""
        policy = self.policy
        T, G = rollout.num_steps, self.gradient_length
        total_steps = self.num_learning_epochs * T
        num_segments = total_steps // G
        resets = rollout.replay_resets()
        carry0 = tree_map(torch.Tensor.detach, rollout.carry0) if policy.is_recurrent else ()
        carry = carry0
        all_losses = []
        for seg in range(num_segments):
            losses, carry = self._replay(rollout, resets, carry0, carry, chunks_between(seg * G, (seg + 1) * G, T))
            grads = torch.autograd.grad(losses.sum(), self.params, allow_unused=True)
            # the std gets no gradient from the loss: Adam sees zeros, as in JAX
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            if self.mesh is not None:
                grads, _ = sum_with_grads(self.mesh, grads, {})
            self.optimizer_step(grads, self.max_grad_norm, self.clip_mask)
            carry = tree_map(torch.Tensor.detach, carry)
            all_losses.append(losses.detach())
        # steps that fill no gradient segment still advance the carry and
        # count in the logged mean
        tail = chunks_between(num_segments * G, total_steps, T)
        if tail:
            with torch.no_grad():
                losses, carry = self._replay(rollout, resets, carry0, carry, tail)
            all_losses.append(losses)
        if policy.is_recurrent and policy.teacher_recurrent:
            # the replay leaves the teacher's carry alone: give it the resets
            # since the last rewind, as a step-by-step replay would
            t_end = (total_steps - 1) % T + 1
            carry = {**carry, "teacher": mask_carry(carry0["teacher"], resets[:t_end].any(dim=0))}
        if policy.is_recurrent:
            cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        loss = torch.cat(all_losses).mean()
        return cs, {"Loss/behavior": loss if self.mesh is None else self.mesh.data_sum_(loss.reshape(1))[0]}

    # ------------------------------------------------------- G seeds at once

    def init_stacked_state(self, policies, num_envs: int | None = None) -> StackedTrainState:
        """Stack G student-teacher policies (each its own init) into a fresh
        training state: the optimizer moments cover the trained parameters
        only (the frozen teachers stack beside them), every seed at the
        learning rate."""
        return stack_trained(policies, len(policies), self.learning_rate, self.device)

    @torch.no_grad()
    def collect_stacked(self, env, ts: StackedTrainState, cs: CollectState, num_steps: int,
                        action_noise: torch.Tensor | None = None):
        """:meth:`collect` for G seeds: returns ``(cs, rollout, metrics)`` with
        a leading ``[G]`` axis on the rollout and on every metric; the
        students' normalizer moments in ``ts.buffers`` update in place, per
        seed. ``action_noise [G, T, E, A]`` replaces the normal draws."""
        call = partial(seed_call, self.policy, ts.params, ts.buffers)
        env_state, obs, carry, stats = cs.env_state, cs.obs, cs.carry, cs.stats
        G, E = stats.cur_reward_sum.shape
        carry0 = carry
        acc = {k: torch.zeros(G, device=self.device) for k in ACC_KEYS}
        steps = {k: [] for k in ("obs", "actions", "privileged_actions", "rewards", "dones", "std")}
        logs: dict[str, list] = {}
        for t in range(num_steps):
            mean, std, carry = call("act", obs, carry)
            noise = None if action_noise is None else action_noise[:, t]
            action = distributions.sample(mean, std, noise, self.generator)
            privileged, carry = call("evaluate", obs, carry)

            env_state, *out = env.step(env_state, action.reshape(G * E, -1))
            next_obs, rew, done, extras = tree_map(lambda x: x.reshape(G, E, *x.shape[1:]), out)
            call("update_normalization", next_obs, out_dims=None)
            carry = vmap(self.policy.reset_carry)(carry, done)
            stats, acc = step_episode_stats(stats, acc, rew, torch.zeros_like(rew), done.to(torch.float32))
            for k, v in vmap(collect_extras_logs)(extras).items():
                logs.setdefault(k, []).append(v)

            for k, v in (("obs", obs), ("actions", action), ("privileged_actions", privileged),
                         ("rewards", rew), ("dones", done), ("std", std.flatten(1).mean(dim=1))):
                steps[k].append(v)
            obs = next_obs

        rollout = Rollout(
            obs={k: torch.stack([o[k] for o in steps["obs"]], dim=1) for k in steps["obs"][0]},
            **{k: torch.stack(steps[k], dim=1) for k in ("actions", "privileged_actions", "rewards", "dones")},
            carry0=carry0,
        )
        metrics = dict(acc)
        metrics["Policy/mean_noise_std"] = torch.stack(steps["std"]).mean(dim=0)
        for k, v in logs.items():
            metrics[f"extras/{k}"] = torch.stack(v).mean(dim=0)
        cs = CollectState(env_state=env_state, obs=obs, carry=carry, stats=stats)
        return cs, rollout, metrics

    def _seed_chunk(self, params: dict, buffers: dict, obs: dict, carry, resets, targets):
        """One seed's per-step losses over a chunk and the carry after it
        (vmapped over the seeds by :meth:`update_stacked`)."""
        actions, carry = functional_call(self.policy, (params, buffers), ("student_seq", obs, carry, resets))
        return self._per_step_loss(actions, targets), carry

    def _replay_stacked(self, ts: StackedTrainState, rollout: Rollout, resets, carry0, carry, chunks):
        """:meth:`_replay` for G seeds: each chunk is one batched call; the
        per-step losses are ``[G, steps]``."""
        losses = []
        for t0, t1 in chunks:
            if t0 == 0:
                carry = carry0
            obs = {k: v[:, t0:t1] for k, v in rollout.obs.items()}
            loss, carry = vmap(self._seed_chunk)(ts.params, ts.buffers, obs, carry, resets[:, t0:t1],
                                                 rollout.privileged_actions[:, t0:t1])
            losses.append(loss)
        return torch.cat(losses, dim=1), carry

    def update_stacked(self, ts: StackedTrainState, cs: CollectState, rollout: Rollout):
        """:meth:`update` for G seeds, in place on ``ts``; returns ``(ts, cs,
        metrics)`` with ``[G]`` metrics. Each gradient segment takes one
        gradient of the summed per-seed losses and steps each seed's clip
        (masked to its student MLP) and optimizer on its own."""
        policy = self.policy
        T, L = rollout.num_steps, self.gradient_length
        total_steps = self.num_learning_epochs * T
        num_segments = total_steps // L
        resets = rollout.replay_resets()
        carry0 = tree_map(torch.Tensor.detach, rollout.carry0) if policy.is_recurrent else ()
        carry = carry0
        names = ts.trained_names()
        clip_mask = [n.startswith("student.") for n in names]
        step = vmap(partial(clip_step, max_grad_norm=self.max_grad_norm, clip_mask=clip_mask,
                            direction=self.direction))
        all_losses = []
        for seg in range(num_segments):
            losses, carry = self._replay_stacked(ts, rollout, resets, carry0, carry,
                                                 chunks_between(seg * L, (seg + 1) * L, T))
            grads = torch.autograd.grad(losses.sum(), [ts.params[k] for k in names], allow_unused=True)
            # the std gets no gradient from the loss: the optimizer sees zeros, as in JAX
            grads = [torch.zeros_like(ts.params[k]) if g is None else g for g, k in zip(grads, names)]
            stacked_step(step, ts.params, grads, ts.adam_mu, ts.adam_nu, ts.adam_count, ts.lr)
            carry = tree_map(torch.Tensor.detach, carry)
            all_losses.append(losses.detach())
        tail = chunks_between(num_segments * L, total_steps, T)
        if tail:
            with torch.no_grad():
                losses, carry = self._replay_stacked(ts, rollout, resets, carry0, carry, tail)
            all_losses.append(losses)
        if policy.is_recurrent and policy.teacher_recurrent:
            t_end = (total_steps - 1) % T + 1
            carry = {**carry, "teacher": vmap(mask_carry)(carry0["teacher"], resets[:, :t_end].any(dim=1))}
        if policy.is_recurrent:
            cs = CollectState(env_state=cs.env_state, obs=cs.obs, carry=carry, stats=cs.stats)
        return ts, cs, {"Loss/behavior": torch.cat(all_losses, dim=1).mean(dim=1)}
