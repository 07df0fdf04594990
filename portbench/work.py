"""The yardstick's arithmetic: model FLOPs of an iteration counted from the
configuration's shapes, the memory-replay kernels' least time from their
operations and bytes, and the published peaks they are held against.

The kernel counts are frozen copies of the bring-up smoke's ``work`` and
``bound_ms`` (every input read once, every output written once, fp32 at 4
bytes a value), so the same work is counted whatever implements it.
"""

from __future__ import annotations

#: published dense peaks (NVIDIA data sheets) by part: fp32 outside the
#: tensor cores, bf16 on them (held for the SXM part only) and memory bandwidth
PEAKS = {
    "PCIe": {"fp32_flops": 51e12, "bf16_flops": None, "bytes_per_s": 2.0e12},
    "NVL": {"fp32_flops": 60e12, "bf16_flops": None, "bytes_per_s": 3.9e12},
    "SXM": {"fp32_flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}
#: gates a cell of each memory family computes
GATES = {"gru": 3, "lstm": 4}


def peaks_of(device_name: str) -> dict:
    """The peaks of the H100 part ``device_name`` names (SXM unless it says PCIe or NVL)."""
    for part in ("PCIe", "NVL"):
        if part in device_name:
            return PEAKS[part]
    return PEAKS["SXM"]


def mlp_flops(sizes: list[int]) -> int:
    """Multiply-adds of one sample through dense layers of ``sizes``, as 2 FLOPs each."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def sample_flops(config: dict, obs_dim: int, num_actions: int) -> tuple[int, int]:
    """Forward FLOPs of one sample through the actor and through the critic:
    each's memory step (its input and recurrent products) and MLP trunk."""
    pol = config["train_cfg"]["policy"]
    recurrent = pol["class_name"] == "ActorCriticRecurrent"
    H = pol.get("rnn_hidden_dim", 0) if recurrent else 0
    memory = 0
    if recurrent:
        G = GATES[pol["rnn_type"]]
        memory = 2 * obs_dim * G * H + 2 * H * G * H
    trunk_in = H if recurrent else obs_dim
    actor = memory + mlp_flops([trunk_in, *pol["actor_hidden_dims"], num_actions])
    critic = memory + mlp_flops([trunk_in, *pol["critic_hidden_dims"], 1])
    return actor, critic


def iteration_flops(config: dict, num_envs: int, obs_dim: int, num_actions: int) -> int:
    """Model FLOPs of one PPO iteration over ``num_envs`` envs (all ranks):
    acting and valuing every env-step of the window, the bootstrap value of
    the last obs, and every epoch's forward and backward (twice the forward)
    over the window. Env physics and the backward's recomputation are not
    counted."""
    actor, critic = sample_flops(config, obs_dim, num_actions)
    cfg = config["train_cfg"]
    rows = cfg["num_steps_per_env"] * num_envs
    epochs = cfg["algorithm"]["num_learning_epochs"]
    return rows * (actor + critic) + num_envs * critic + 3 * epochs * rows * (actor + critic)


def kernel_work(family: str, S: int, T: int, B: int, D: int, H: int) -> dict[str, tuple[int, int]]:
    """``{kernel: (operations, bytes)}`` each replay kernel's function needs."""
    f = 4
    rows = T * B
    cell = family.split("_")[0]
    G = GATES[cell]
    fwd, bwd, wgrad = (f"{family}_{k}" for k in ("fwd", "bwd", "wgrad"))
    if cell == "gru":
        rec_weights, bias_cols, carries, states = S * (H * 3 * H + H), H, S * B * H, S * rows * H
    else:
        rec_weights, bias_cols, carries, states = S * (H * 4 * H + 4 * H), 4 * H, 2 * S * B * H, 2 * S * rows * H
    if family.endswith("_xp"):
        fwd_ops = S * 2 * rows * H * G * H
        inputs = S * rows * G * H + S * rows + carries + rec_weights
        return {
            fwd: (fwd_ops, f * (inputs + states)),
            bwd: (2 * fwd_ops, f * (inputs + states + S * rows * H + carries + S * rows * 4 * H)),
            wgrad: (S * (2 * rows * H * G * H + rows * bias_cols),
                    f * (S * rows + S * B * H + S * rows * H + S * rows * 4 * H + S * (H * G * H + bias_cols))),
        }
    weights = rec_weights + S * D * G * H + (S * 3 * H if cell == "gru" else 0)
    fwd_ops = S * 2 * rows * (H + D) * G * H
    return {
        fwd: (fwd_ops, f * (S * rows * D + rows + carries + weights + states)),
        bwd: (fwd_ops + S * 2 * rows * G * H * (H + D),
              f * (S * rows * D + rows + carries + weights + states + S * rows * H
                   + S * rows * D + carries + S * rows * 4 * H)),
        wgrad: (S * (2 * rows * (H + D) * G * H + rows * 4 * H),
                f * (S * rows * D + rows + S * B * H + S * rows * H + S * rows * 4 * H + S * (H + D + 1) * 4 * H)),
    }


def bound_ms(ops: int, nbytes: int, peaks: dict, bf16: bool) -> float | None:
    """The card's least time for the work: operations at the fp32 peak (bf16
    mode: the tensor-core peak, None where none is held) or bytes at the
    memory rate, whichever is longer."""
    peak = peaks["bf16_flops" if bf16 else "fp32_flops"]
    if peak is None:
        return None
    return max(ops / peak, nbytes / peaks["bytes_per_s"]) * 1e3


def replay_bound_ms(config: dict, num_envs: int, obs_dim: int, peaks: dict) -> float | None:
    """Least time of one iteration's memory replays: every minibatch of every
    epoch replays the actor and critic memories (``S = 2`` streams) over the
    window, ``B = num_envs / minibatches`` rows. None for a policy without memory."""
    cfg = config["train_cfg"]
    pol = cfg["policy"]
    if pol["class_name"] != "ActorCriticRecurrent":
        return None
    alg = cfg["algorithm"]
    launches = alg["num_learning_epochs"] * alg["num_mini_batches"]
    bf16 = pol.get("dtype") == "bfloat16"
    works = kernel_work(pol["rnn_type"], 2, cfg["num_steps_per_env"], num_envs // alg["num_mini_batches"],
                        obs_dim, pol["rnn_hidden_dim"])
    bounds = [bound_ms(ops, nbytes, peaks, bf16) for ops, nbytes in works.values()]
    return None if None in bounds else launches * sum(bounds)
