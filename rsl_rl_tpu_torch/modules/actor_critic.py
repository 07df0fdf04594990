"""Gaussian MLP actor-critic (counterpart of ``rsl_rl_tpu/modules/actor_critic.py``).

Scalar, log or state-dependent action std and optional running observation
normalization. Parameters are fp32; ``dtype=torch.bfloat16`` runs the MLP
trunks in bf16 with fp32 output heads.
The std is the raw parameter in ``"scalar"`` mode (it can drift negative, as
in the reference) and ``exp`` of it in ``"log"`` mode; with
``state_dependent_std`` the actor's head outputs ``[2, A]``, the mean and the
raw std (the same two modes), and there is no std parameter. ``noise_std_floor``
clamps the std from below when set.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from rsl_rl_tpu_torch.modules.policy import check_state_compatible, concat_obs, obs_set_dim
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
        self.state_dependent_std = state_dependent_std
        self.noise_std_floor = noise_std_floor
        # the recurrent subclass feeds its memory outputs to the MLPs
        actor_in, critic_in = trunk_inputs or (self.num_actor_obs, self.num_critic_obs)
        self.dtype = dtype
        # reduced precision stays in the trunks; the output heads compute in
        # fp32, as in the JAX package (a bf16 actor head biases the sigma
        # gradient on long runs)
        head = torch.float32 if dtype is not None else None
        gen = torch.Generator().manual_seed(int(seed))
        # a state-dependent std is the second row of the actor's [2, A] output
        actor_out = (2, num_actions) if state_dependent_std else num_actions
        self.actor = MLP(actor_in, actor_out, list(actor_hidden_dims), activation, gen,
                         dtype=dtype, head_dtype=head)
        self.critic = MLP(critic_in, 1, list(critic_hidden_dims), activation, gen,
                          dtype=dtype, head_dtype=head)
        if state_dependent_std:
            # the std half of the last layer: zero weights, the initial std as bias
            last = getattr(self.actor, f"dense_{self.actor.num_linear - 1}")
            with torch.no_grad():
                last.weight[num_actions:].zero_()
                last.bias[num_actions:] = (init_noise_std if noise_std_type == "scalar"
                                           else math.log(init_noise_std + 1e-7))
            self.std = None
        else:
            std0 = init_noise_std * torch.ones(num_actions)
            self.std = nn.Parameter(std0 if noise_std_type == "scalar" else torch.log(std0))
        self.norm_actor = RunningNormState(self.num_actor_obs) if actor_obs_normalization else None
        self.norm_critic = RunningNormState(self.num_critic_obs) if critic_obs_normalization else None
        self.to(self.device)

    def forward(self, method: str, *args):
        """``self.<method>(*args)``: lets ``torch.func.functional_call`` run any
        policy method with a substituted state (see ``modules.policy.seed_call``)."""
        return getattr(self, method)(*args)

    # ------------------------------------------------------------- carries

    def initial_carry(self, num_envs: int) -> Any:
        return ()

    def reset_carry(self, carry: Any, dones: torch.Tensor) -> Any:
        return carry

    # ------------------------------------------------------------- forward

    def _dist_from_features(self, features: torch.Tensor):
        out = self.actor(features)
        if self.state_dependent_std:
            mean, raw = out[..., 0, :], out[..., 1, :]
            std = raw if self.noise_std_type == "scalar" else torch.exp(raw)
        else:
            mean = out
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

    def act_seq(self, obs, carry0, resets):
        """``(mean, std)`` of an update batch."""
        return self._dist_from_features(self._actor_in(obs))

    def value_seq(self, obs, carry0, resets):
        """Value ``[...]`` of an update batch."""
        return self.critic(self._critic_in(obs)).squeeze(-1)

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

    # ----------------------------------------------------------- checkpoint

    def load_policy_state(self, state: dict) -> bool:
        """Restore the policy from a checkpoint's model state dict (the JAX
        package's ``load_state_dict``): strict, raising ``ValueError`` on a
        structural mismatch before anything is copied. Returns the resume
        flag, always ``True`` here."""
        check_state_compatible(self.state_dict(), state)
        self.load_state_dict(state)
        return True
