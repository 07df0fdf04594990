"""Recurrent Gaussian actor-critic (counterpart of
``rsl_rl_tpu/modules/actor_critic_recurrent.py``): a GRU ``Memory`` in front
of the actor and of the critic MLP. The hidden state is an explicit carry
``{"actor": (h,...), "critic": (h,...)}``; the update replays both memories
over the window through :func:`~rsl_rl_tpu_torch.networks.memory.paired_sequence`.
"""

from __future__ import annotations

import torch

from rsl_rl_tpu_torch.modules.actor_critic import ActorCritic
from rsl_rl_tpu_torch.networks.memory import Memory, mask_carry, paired_sequence
from rsl_rl_tpu_torch.utils.registry import register


@register("policy")
class ActorCriticRecurrent(ActorCritic):
    is_recurrent = True

    def __init__(
        self,
        obs,
        obs_groups,
        num_actions,
        rnn_type: str = "lstm",
        rnn_hidden_dim: int = 256,
        rnn_num_layers: int = 1,
        **kwargs,
    ):
        super().__init__(
            obs, obs_groups, num_actions, trunk_inputs=(rnn_hidden_dim, rnn_hidden_dim), **kwargs
        )
        self.rnn_type = rnn_type
        self.rnn_hidden_dim = rnn_hidden_dim
        self.rnn_num_layers = rnn_num_layers
        gen = torch.Generator().manual_seed(int(kwargs.get("seed", 0)) + 1)
        self.memory_a = Memory(self.num_actor_obs, rnn_hidden_dim, rnn_type, rnn_num_layers,
                               generator=gen)
        self.memory_c = Memory(self.num_critic_obs, rnn_hidden_dim, rnn_type, rnn_num_layers,
                               generator=gen)
        self.to(self.device)

    # ------------------------------------------------------------- carries

    def initial_carry(self, num_envs: int):
        return {
            "actor": self.memory_a.initialize_carry(num_envs, self.device),
            "critic": self.memory_c.initialize_carry(num_envs, self.device),
        }

    def reset_carry(self, carry, dones: torch.Tensor):
        """Zero the hidden states of done envs."""
        return {"actor": mask_carry(carry["actor"], dones), "critic": mask_carry(carry["critic"], dones)}

    # ------------------------------------------------------------- forward

    def act(self, obs, carry):
        new_a, features = self.memory_a.step(carry["actor"], self._actor_in(obs))
        mean, std = self._dist_from_features(features)
        return mean, std, {**carry, "actor": new_a}

    def value(self, obs, carry):
        new_c, features = self.memory_c.step(carry["critic"], self._critic_in(obs))
        return self.critic(features).squeeze(-1), {**carry, "critic": new_c}

    def act_value_seq(self, obs, carry0, resets):
        """Actor distribution and value of a ``[T, B]`` update batch, replaying
        the actor and critic memories from the window-start ``carry0`` with
        ``resets[t] = done[t-1]``, both in one stream-paired launch per kernel."""
        fa, fc = paired_sequence(
            self.memory_a, carry0["actor"], self._actor_in(obs),
            self.memory_c, carry0["critic"], self._critic_in(obs),
            resets,
        )
        mean, std = self._dist_from_features(fa)
        return mean, std, self.critic(fc).squeeze(-1)

    def act_inference(self, obs, carry):
        """Stateful single-step deterministic action: ``(mean, carry)``."""
        new_a, features = self.memory_a.step(carry["actor"], self._actor_in(obs))
        return self.actor(features), {**carry, "actor": new_a}
