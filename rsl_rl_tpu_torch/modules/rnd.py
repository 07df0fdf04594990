"""Random Network Distillation intrinsic reward (counterpart of
``rsl_rl_tpu/modules/rnd.py``).

A frozen random ``target`` MLP and a trained ``predictor`` MLP embed the
(optionally normalized) ``rnd_state`` obs set; the intrinsic reward is the
L2 distance between the embeddings, optionally divided by the std of its
discounted sum (``ops/running_norm.py`` ``DiscountedVariationNormState``),
times a weight that a constant, step or linear schedule draws from an
env-step counter. Every mutable piece (the predictor's parameters, both
normalizers' moments, the counter) is a tensor of this module updated in
place, so a CUDA graph of the training iteration replays it.
"""

from __future__ import annotations

import torch
from torch import nn

from rsl_rl_tpu_torch.modules.policy import concat_obs
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.ops.running_norm import (
    DiscountedVariationNormState,
    RunningNormState,
    normalize,
    normalize_reward,
    update_running_norm,
)

#: both RND normalizers stop updating after this many samples (the reference's)
NORM_UNTIL = 1.0e8


class RandomNetworkDistillation(nn.Module):
    """RND: intrinsic reward and predictor loss.

    Hidden dims of ``-1`` take ``num_states``. The MLPs are drawn on the CPU
    from a generator seeded with ``seed``, then moved to ``device``. The
    reward normalizer holds one accumulator an env, so it is made by
    :meth:`init_reward_norm` once the env count is known.
    """

    def __init__(
        self,
        num_states: int,
        obs_groups: dict[str, list[str]],
        num_outputs: int,
        predictor_hidden_dims: list[int],
        target_hidden_dims: list[int],
        activation: str = "elu",
        weight: float = 0.0,
        state_normalization: bool = False,
        reward_normalization: bool = False,
        weight_schedule: dict | None = None,
        dtype=None,
        device: str | torch.device = "cpu",
        seed: int = 0,
        **kwargs,
    ):
        super().__init__()
        if kwargs:
            print("RandomNetworkDistillation.__init__ got unexpected arguments, which will be ignored: "
                  + str(list(kwargs.keys())))
        if weight_schedule is not None and weight_schedule.get("mode") not in ("constant", "step", "linear"):
            raise ValueError(f"Unknown RND weight schedule mode: {weight_schedule}")
        self.num_states = num_states
        self.obs_groups = obs_groups
        self.initial_weight = weight
        self.weight_schedule = weight_schedule
        self.reward_normalization = reward_normalization
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(int(seed))

        def dims(hidden):
            return [num_states if d == -1 else d for d in hidden]

        self.predictor = MLP(num_states, num_outputs, dims(predictor_hidden_dims), activation, gen, dtype=dtype)
        self.target = MLP(num_states, num_outputs, dims(target_hidden_dims), activation, gen, dtype=dtype)
        self.target.requires_grad_(False)
        self.state_norm = RunningNormState(num_states, until=NORM_UNTIL) if state_normalization else None
        self.reward_norm = None
        self.register_buffer("counter", torch.zeros((), dtype=torch.int32))
        self.to(self.device)

    def forward(self, method: str, *args):
        """``self.<method>(*args)``: lets ``torch.func.functional_call`` run any
        method with a substituted state (each seed's, in a study)."""
        return getattr(self, method)(*args)

    def init_reward_norm(self, num_envs: int) -> None:
        """Make the reward normalizer for ``num_envs`` envs (with
        ``reward_normalization``)."""
        if self.reward_normalization:
            self.reward_norm = DiscountedVariationNormState(num_envs, until=NORM_UNTIL).to(self.device)

    def current_weight(self, counter: torch.Tensor) -> torch.Tensor:
        """The scheduled weight at env step ``counter`` (a device tensor)."""
        w0 = torch.full((), float(self.initial_weight), device=counter.device)
        cfg = self.weight_schedule
        if cfg is None or cfg["mode"] == "constant":
            return w0
        step = counter.to(torch.float32)
        if cfg["mode"] == "step":
            return torch.where(step < cfg["final_step"], w0, torch.full_like(w0, cfg["final_value"]))
        frac = torch.clamp((step - cfg["initial_step"]) / (cfg["final_step"] - cfg["initial_step"]), 0.0, 1.0)
        return w0 + (cfg["final_value"] - w0) * frac

    def _state_in(self, obs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = concat_obs(obs, self.obs_groups["rnd_state"])
        return normalize(self.state_norm, x) if self.state_norm is not None else x

    @torch.no_grad()
    def get_intrinsic_reward(self, obs: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """The weighted intrinsic reward ``[N]`` of one env step and the
        weight. The counter advances once a call; the state normalizer is
        read, not updated; the reward normalizer updates."""
        self.counter.add_(1)
        x = self._state_in(obs)
        reward = torch.linalg.vector_norm(self.target(x) - self.predictor(x), dim=-1)
        if self.reward_norm is not None:
            reward = normalize_reward(self.reward_norm, reward)
        weight = self.current_weight(self.counter)
        return reward * weight, weight

    @torch.no_grad()
    def update_normalization(self, obs: dict[str, torch.Tensor]) -> None:
        """Fold the rnd obs into the state normalizer, in place."""
        if self.state_norm is not None:
            update_running_norm(self.state_norm, concat_obs(obs, self.obs_groups["rnd_state"]))

    def predictor_loss(self, obs: dict[str, torch.Tensor], mean=torch.mean) -> torch.Tensor:
        """Mean squared error of the predictor against the frozen target on
        the normalized rnd obs; differentiable in the predictor only.
        ``mean`` takes the mean (data parallelism passes this rank's share
        of the global batch's)."""
        x = self._state_in(obs).detach()
        with torch.no_grad():
            target = self.target(x)
        return mean(torch.square(self.predictor(x) - target))


def resolve_rnd_config(alg_cfg: dict, obs, obs_groups, env) -> dict:
    """Fill in ``num_states`` and ``obs_groups`` and scale the weight by the
    env's ``step_dt``, on a copy of ``rnd_cfg`` (the caller's config is not
    changed, so runners built from one template do not compound the
    scaling)."""
    if alg_cfg.get("rnd_cfg") is not None:
        rnd_cfg = dict(alg_cfg["rnd_cfg"])
        num_rnd_state = 0
        for group in obs_groups["rnd_state"]:
            if obs[group].ndim != 2:
                raise ValueError("The RND module only supports 1D observations.")
            num_rnd_state += obs[group].shape[-1]
        rnd_cfg["num_states"] = num_rnd_state
        rnd_cfg["obs_groups"] = obs_groups
        step_dt = getattr(getattr(env, "unwrapped", env), "step_dt", None)
        if step_dt is not None:
            rnd_cfg["weight"] = rnd_cfg["weight"] * step_dt
        alg_cfg["rnd_cfg"] = rnd_cfg
    return alg_cfg
