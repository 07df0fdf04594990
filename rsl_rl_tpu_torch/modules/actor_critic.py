"""Gaussian MLP actor-critic (counterpart of ``rsl_rl_tpu/modules/actor_critic.py``).

Scalar or log action std and optional running observation normalization, fp32.
The std is the raw parameter in ``"scalar"`` mode (it can drift negative, as
in the reference) and ``exp`` of it in ``"log"`` mode; ``noise_std_floor``
clamps it from below when set.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from rsl_rl_tpu_torch.modules.policy import concat_obs, obs_set_dim
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.ops.running_norm import RunningNormState, normalize, update_running_norm
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@register("policy")
class ActorCritic(nn.Module):
    """Gaussian MLP actor + MLP critic.

    Parameters are drawn on the CPU from a generator seeded with ``seed``
    and then moved to ``device``, so a seed gives the same weights on every
    device.
    """

    is_recurrent = False

    def __init__(
        self,
        obs: dict[str, torch.Tensor],
        obs_groups: dict[str, list[str]],
        num_actions: int,
        actor_obs_normalization: bool = False,
        critic_obs_normalization: bool = False,
        actor_hidden_dims: list[int] = (256, 256, 256),
        critic_hidden_dims: list[int] = (256, 256, 256),
        activation: str = "elu",
        init_noise_std: float = 1.0,
        noise_std_type: str = "scalar",
        state_dependent_std: bool = False,
        noise_std_floor: float | None = None,
        dtype: Any = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
        trunk_inputs: tuple[int, int] | None = None,
        **kwargs,
    ):
        super().__init__()
        if kwargs:
            print(
                "ActorCritic.__init__ got unexpected arguments, which will be ignored: "
                + str(list(kwargs.keys()))
            )
        if dtype is not None:
            raise NotImplementedError(
                "reduced-precision policies are not ported yet (ROADMAP.md Queue 1,"
                " 'bf16 MLP trunks'); use dtype=None (fp32)"
            )
        if state_dependent_std:
            raise NotImplementedError(
                "state-dependent std is not ported yet (ROADMAP.md Queue 1, 'Actor-critic')"
            )
        if noise_std_type not in ("scalar", "log"):
            raise ValueError(
                f"Unknown standard deviation type: {noise_std_type}. Should be 'scalar' or 'log'"
            )
        self.device = resolve_device(device)
        self.obs_groups = obs_groups
        self.num_actions = num_actions
        self.num_actor_obs = obs_set_dim(obs, obs_groups["policy"])
        self.num_critic_obs = obs_set_dim(obs, obs_groups["critic"])
        self.noise_std_type = noise_std_type
        self.noise_std_floor = noise_std_floor
        # the recurrent subclass feeds its memory outputs to the MLPs
        actor_in, critic_in = trunk_inputs or (self.num_actor_obs, self.num_critic_obs)
        gen = torch.Generator().manual_seed(int(seed))
        self.actor = MLP(actor_in, num_actions, list(actor_hidden_dims), activation, gen)
        self.critic = MLP(critic_in, 1, list(critic_hidden_dims), activation, gen)
        std0 = init_noise_std * torch.ones(num_actions)
        self.std = nn.Parameter(std0 if noise_std_type == "scalar" else torch.log(std0))
        self.norm_actor = RunningNormState(self.num_actor_obs) if actor_obs_normalization else None
        self.norm_critic = RunningNormState(self.num_critic_obs) if critic_obs_normalization else None
        self.to(self.device)

    # ------------------------------------------------------------- carries

    def initial_carry(self, num_envs: int) -> Any:
        return ()

    def reset_carry(self, carry: Any, dones: torch.Tensor) -> Any:
        return carry

    # ------------------------------------------------------------- forward

    def _dist_from_features(self, features: torch.Tensor):
        mean = self.actor(features)
        std = self.std if self.noise_std_type == "scalar" else torch.exp(self.std)
        std = std.expand_as(mean)
        if self.noise_std_floor is not None:
            std = torch.clamp(std, min=self.noise_std_floor)
        return mean, std

    def _actor_in(self, obs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = concat_obs(obs, self.obs_groups["policy"])
        return normalize(self.norm_actor, x) if self.norm_actor is not None else x

    def _critic_in(self, obs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = concat_obs(obs, self.obs_groups["critic"])
        return normalize(self.norm_critic, x) if self.norm_critic is not None else x

    def act(self, obs, carry):
        """Single-step distribution: ``(mean, std, carry)``."""
        mean, std = self._dist_from_features(self._actor_in(obs))
        return mean, std, carry

    def value(self, obs, carry):
        """Single-step value ``[N]`` and the carry."""
        return self.critic(self._critic_in(obs)).squeeze(-1), carry

    def act_value_seq(self, obs, carry0, resets):
        """``(mean, std, value)`` of an update batch."""
        mean, std = self._dist_from_features(self._actor_in(obs))
        return mean, std, self.critic(self._critic_in(obs)).squeeze(-1)

    def act_inference(self, obs, carry=()):
        """Deterministic action (the mean) and the carry."""
        return self._dist_from_features(self._actor_in(obs))[0], carry

    # -------------------------------------------------------- normalization

    @torch.no_grad()
    def update_normalization(self, obs: dict[str, torch.Tensor]) -> None:
        """Fold a batch of observations into the normalizer moments, in place."""
        if self.norm_actor is not None:
            update_running_norm(self.norm_actor, concat_obs(obs, self.obs_groups["policy"]))
        if self.norm_critic is not None:
            update_running_norm(self.norm_critic, concat_obs(obs, self.obs_groups["critic"]))

