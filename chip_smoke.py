#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card: print ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and turn TF32 off for matmuls and cuDNN, so fp32 means IEEE fp32.
2. Build the CUDA kernels from ``rsl_rl_tpu_torch/csrc/`` (into ``build/``,
   one ``nvcc`` per source, all in parallel).
3. Hold every kernel against its plain PyTorch version on the same inputs:
   the x-streaming kernels (GRU and LSTM) at their main-path shape (T=24,
   B=1024, D=15, H=256) with S=2 and S=1, the xproj kernels at theirs
   (G=16 streams of B=128: 8 seeds x actor and critic, per-stream resets)
   and at G=1, B=1024 (the wide-input shape, D=520), each in IEEE fp32 and
   in bf16-operand mode, and at T=1. Every kernel also at edge shapes (H=128
   and 200, B=200 and 203, T=1 and 5, resets at t=0 and mid-window,
   per-stream resets for the xproj families, and H=384 and 512 for all four
   families; the xproj families also at G=17, B=130, H=36, at B=1 and 7, at
   H=1, at G=40 with H=64 and 384, and in more waves than the card runs
   clusters at once), in both modes; two calls of each kernel redesigned for
   Hopper (``gru_x_fwd``, ``lstm_x_fwd``, ``gru_xp_fwd``, ``lstm_xp_fwd``,
   ``gru_x_bwd``, ``lstm_x_bwd``, ``gru_xp_bwd``, ``lstm_xp_bwd`` and the
   four weight-gradient reductions) must give the same bits.
   The x-streaming kernels also at one stream and the distillation
   student's replay shapes (T=15 and the 9-step tail, B=4096), both modes.
4. The slices, every kernel launch counter set to 0 just before each and
   read just after: through ``OnPolicyRunner.learn`` (3 iterations),
   ``recurrent_gru256`` (GRU-256 actor and critic memories, [256, 256] MLPs,
   obs normalization, fp32) and ``recurrent_lstm256_bf16`` (the same with
   LSTM-256 memories and ``dtype=bfloat16``: bf16 MLP trunks with fp32
   heads, bf16 memory matmul operands), both on 4096 ``NLinkPendulum`` envs
   with 5 links, T=24, 5 epochs x 4 minibatches; through
   ``MultiSeedRunner.learn``, ``multiseed8_recurrent_gru256`` and
   ``multiseed8_recurrent_lstm256_bf16``, the same policies for 8 seeds of
   512 envs each (4096 in all); ``ppo_ff256x3_bf16``, the feedforward
   headline (``ActorCritic`` [256, 256, 256], bf16 trunks, 4096 envs), which
   launches no kernel; then the teacher -> student flow on 4096
   ``DomainRandomizedNLink`` envs: the privileged teacher
   (``ppo_ff256x3_bf16_dr``, 2 iterations) saved with
   ``OnPolicyRunner.save`` and loaded into ``DistillationRunner`` (its
   teacher must then act as the trained actor, bit for bit), the GRU-256
   student ``distill_gru256_bf16`` (3 iterations: each replays the 15-step
   segment and the 9-step tail through the x-streaming kernels at S=1,
   ``gru_x_fwd`` twice and ``gru_x_bwd`` and ``gru_x_wgrad`` once) and the
   LSTM-256 student (1 iteration, ``lstm_x_*``). After each, check finite
   (and, across seeds, distinct) metrics, and that the kernel replay of a
   collected window reproduces the acting-time policy (per seed; for the
   students the replay of the update's chunks, for the headline the batched
   MLPs). First, the random draws (per-env keys in their state) of both
   envs and of the four of phase 6c on the card must equal the CPU's bit for
   bit, through a reset and a step.
4b. Whole-iteration dispatch: for ``recurrent_gru256``,
   ``recurrent_lstm256_bf16``, the two multi-seed slices, ``ppo_ff256x3_bf16``
   and ``distill_gru256_bf16`` (from phase 4's saved teacher), three runners
   from the same seed, eager, ``fuse_iteration=True`` (each iteration one
   CUDA graph replay) and ``iterations_per_dispatch=2`` (a group of two
   replays and a remainder of one), train 3 iterations each with the launch
   counters zeroed just before and read just after. The graphed runs' state
   (parameters, Adam moments, count and learning rate, normalizer moments,
   env state, carries) and metrics must equal the eager run's bit for bit,
   their launches the eager run's, their metrics finite; then the steady
   env-steps/s of the three (iterations 1-2; the K=2 run's remainder,
   iteration 2), the capture's seconds and the graph pool's bytes, beside
   the card's name and power limit. Each runner's graph is freed before the
   next.
4c. PPO's options and the parity study, the counters zeroed just before
   each run and read just after: ``recurrent_gru256_rnd`` (the GRU-256 flagship with
   ``benchmarks/parity_pendulum.py``'s RND config) eager, fused and at K=2
   for 3 iterations, bit for bit with the RND state (predictor, target,
   both normalizers, counter, the RND Adam); the three symmetry modes
   ``recurrent_gru256_symmetry_{aug,mirror,log}`` on 4096 ``PointMass``
   envs (2 iterations, eager), each with its launches (the paired x kernels
   at S=2, B=2048; the mirror replay ``act_seq`` at S=1, B=2048, forward and
   backward, or forward only when the loss is only logged); the parity
   study (a) of ``parity_torch.py``, ``multiseed40_po_nlink_gru64`` (40
   seeds x 64 ``PartiallyObservableNLink`` envs, GRU-64, fp32: ``gru_xp_*``
   at G=80, B=16, H=64) eager and fused, with the grid ``gru_xp_fwd``
   chose there; and ``ppo_ff256x3_bf16`` with adamw, sgd and rmsprop eager
   and fused for 2 iterations. Their shapes (``PATH_SHAPES``) are held
   against the plain versions in phase 3 and timed in phase 5.
5. Time each kernel, in fp32 and in bf16-operand mode, at its main-path
   shape beside its plain version, a PyTorch yardstick the port never calls
   (cuDNN's ``torch.nn.GRU`` / ``torch.nn.LSTM``; one ``torch.bmm`` for the
   weight-gradient reductions; none for the xproj forward and backward at
   G=16, which no single library call computes) and the card's lower bound
   for the same work (bf16 mode: operations at the bf16 tensor-core peak);
   then the x-streaming kernels at S=1, and the xproj kernels and the port's
   whole xproj replay (outside projection included) at G=1 beside cuDNN on
   the raw wide input. Also the phase split (gates / chain / dx, CUDA events
   between the phases of a dedicated timing call) of ``gru_x_bwd`` and
   ``lstm_x_bwd`` at S=2 and S=1 and of ``gru_xp_bwd`` and ``lstm_xp_bwd``
   (gates / chain) at G=16, the grid the cluster forwards ``gru_x_fwd``,
   ``lstm_x_fwd``, ``gru_xp_fwd`` and ``lstm_xp_fwd`` chose (the clusters the
   card runs at once, the batch rows of a cluster, the clusters launched, the
   streams a cluster's rows touch, the waves, the streams whose weight slices
   stream from L2), and how many clusters of 16 CTAs the card runs at once
   with the shared memory a 16-CTA layout of the xproj forwards would need.
   The x-streaming kernels also at the GRU and LSTM students' shape (S=1,
   T=15, B=4096), beside cuDNN and their bounds.

6. The host-env path (run after phase 4d, so that it loads phase 4's
   teacher), each step fatal. The card's machine has neither MuJoCo nor
   Gymnasium, so the script's own ``HostNLink`` (a ``HostVecEnv`` over the
   port's ``NLinkPendulum`` on the CPU, numpy in and out, a writable
   ``episode_length_buf`` that each step reads) stands in for an external
   simulator, and ``HostDRNLink`` for ``DomainRandomizedNLink``; the env
   steps on the host, the policy on the card. 6a: ``recurrent_gru256_host``,
   phase 4's GRU-256 flagship on 4096 such envs through
   ``OnPolicyRunner.learn(3, init_at_random_ep_len=True)`` with the counters
   zeroed just before and read just after (20 launches of each ``gru_x_*``
   kernel an iteration, none of any other): finite metrics, the buffer
   randomized in place (the same ndarray, clocks spread over ``[0,
   max_episode_length)``), finished episodes; then 2 iterations with the
   collection's phases fenced (``host ... collection split`` line: the act
   step on the card, the action's copy to the host, the env step, the copies
   back, the step processing; beside the untimed steady env-steps/s and the
   card), the kernel replay of a host window against acting, the same
   config with ``fuse_iteration=True`` (runs split, the same launches), and
   ``iterations_per_dispatch=2`` and ``eval_interval=1`` refused. 6b:
   ``distill_gru256_bf16_host``, the GRU-256 bf16 student on 4096
   ``HostDRNLink`` envs with phase 4's teacher, 2 iterations (``gru_x_fwd``
   4, ``gru_x_bwd`` 2, ``gru_x_wgrad`` 2), and the replay of a host window in
   the update's chunks. 6c: the headline policy on 4096 envs of
   ``CartPoleSwingUp``, ``Reacher``, ``Hopper`` and ``SparseGoalReach``, and
   ``benchmarks/bench_configs.py``'s config #3 (RND, [128, 128], 512
   ``SparseGoalReach`` envs with ``goal_dist=6.0``,
   ``max_episode_length=100``), eager and fused for 2 iterations, bit for
   bit (phase 4's first check also holds these envs' draws, card against
   CPU). 6d: 6a's policy through ``utils/export.py`` (``torch.export``) and
   ``utils/torch_deploy.py``'s ``as_torch_policy`` against
   ``get_inference_policy()`` over 50 steps of 4096 envs with resets, at
   ``DEPLOY_TOL``.

Prints ``{"kernels": [...]}`` on the line before the last and, as the last
line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or when any phase fails.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.func import functional_call, vmap

from parity_torch import train_cfg as parity_cfg
from rsl_rl_tpu_torch.algorithms.distillation import chunks_between
from rsl_rl_tpu_torch.algorithms.host_collect import PHASES
from rsl_rl_tpu_torch.env import (
    CartPoleSwingUp,
    DomainRandomizedNLink,
    Hopper,
    HostVecEnv,
    NLinkPendulum,
    PartiallyObservableNLink,
    PointMass,
    Reacher,
    SparseGoalReach,
)
from rsl_rl_tpu_torch.networks.memory import memory_sequence, paired_sequence
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import slice_envs
from rsl_rl_tpu_torch.utils import cuda_build
from rsl_rl_tpu_torch.utils.cuda_graph import flatten
from rsl_rl_tpu_torch.utils.evaluation import EVAL_KEYS, evaluate_policy
from rsl_rl_tpu_torch.utils.export import export_policy, load_policy
from rsl_rl_tpu_torch.utils.torch_deploy import as_torch_policy

PALLAS = "rsl_rl_tpu/ops/pallas_rnn.py"
#: kernel families: the x-streaming kernels (the input projection inside) and
#: the xproj ones (over a projection computed outside, one reset mask per stream)
FAMILIES = {
    "gru": {"module": gru_rnn, "source": "rsl_rl_tpu_torch/csrc/gru_x.cu", "gates": 3,
            "counts": "launch_counts", "kernels": ("gru_x_fwd", "gru_x_bwd", "gru_x_wgrad")},
    "lstm": {"module": lstm_rnn, "source": "rsl_rl_tpu_torch/csrc/lstm_x.cu", "gates": 4,
             "counts": "launch_counts", "kernels": ("lstm_x_fwd", "lstm_x_bwd", "lstm_x_wgrad")},
    "gru_xp": {"module": gru_rnn, "source": "rsl_rl_tpu_torch/csrc/gru_xp.cu", "gates": 3,
               "counts": "xp_launch_counts", "kernels": ("gru_xp_fwd", "gru_xp_bwd", "gru_xp_wgrad")},
    "lstm_xp": {"module": lstm_rnn, "source": "rsl_rl_tpu_torch/csrc/lstm_xp.cu", "gates": 4,
                "counts": "xp_launch_counts", "kernels": ("lstm_xp_fwd", "lstm_xp_bwd", "lstm_xp_wgrad")},
}
#: the TPU kernel each replaces (the pallas_call, or for a weight-gradient
#: reduction the accumulation line of its kernel body) and further ones it
#: replaces at S=1
REPLACES = {
    "gru_x_fwd": (f"{PALLAS}:1354", [f"{PALLAS}:492"]),
    "gru_x_bwd": (f"{PALLAS}:1414", [f"{PALLAS}:548"]),
    "gru_x_wgrad": (f"{PALLAS}:1485", [f"{PALLAS}:619"]),
    "lstm_x_fwd": (f"{PALLAS}:1619", [f"{PALLAS}:1051"]),
    "lstm_x_bwd": (f"{PALLAS}:1690", [f"{PALLAS}:1122"]),
    "lstm_x_wgrad": (f"{PALLAS}:1764", [f"{PALLAS}:1195"]),
    "gru_xp_fwd": (f"{PALLAS}:271", []),
    "gru_xp_bwd": (f"{PALLAS}:392", []),
    "gru_xp_wgrad": (f"{PALLAS}:360", []),
    "lstm_xp_fwd": (f"{PALLAS}:836", []),
    "lstm_xp_bwd": (f"{PALLAS}:968", []),
    "lstm_xp_wgrad": (f"{PALLAS}:937", []),
}

RECURRENT_GRU256 = {
    "num_steps_per_env": 24,
    "save_interval": 50,
    "seed": 1,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "policy": {
        "class_name": "ActorCriticRecurrent",
        "rnn_type": "gru",
        "rnn_hidden_dim": 256,
        "rnn_num_layers": 1,
        "actor_hidden_dims": [256, 256],
        "critic_hidden_dims": [256, 256],
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
    },
    "algorithm": {"class_name": "PPO", "num_learning_epochs": 5, "num_mini_batches": 4},
}
# bench.py's recurrent_lstm256_bf16: the same _build with rnn_type="lstm" and
# dtype=bfloat16
RECURRENT_LSTM256_BF16 = copy.deepcopy(RECURRENT_GRU256)
RECURRENT_LSTM256_BF16["policy"].update(rnn_type="lstm", dtype=torch.bfloat16)
SLICES = {"recurrent_gru256": ("gru", RECURRENT_GRU256),
          "recurrent_lstm256_bf16": ("lstm", RECURRENT_LSTM256_BF16)}
# the multi-seed slices: examples/train_multiseed.py's 8 seeds x 512 envs
# (bench.py's measure_multiseed(8)) with the recurrent flagships' policies;
# every minibatch replays the 8 seeds' actor and critic memories in one
# launch per kernel (G = 16 streams of 128 envs)
MULTISEED_SLICES = {"multiseed8_recurrent_gru256": ("gru_xp", RECURRENT_GRU256),
                    "multiseed8_recurrent_lstm256_bf16": ("lstm_xp", RECURRENT_LSTM256_BF16)}
# bench.py's headline (:75-88, :345): the feedforward ActorCritic [256, 256,
# 256], bf16 trunks with fp32 heads, on 4096 NLinkPendulum envs
PPO_FF256X3_BF16 = copy.deepcopy(RECURRENT_GRU256)
PPO_FF256X3_BF16["policy"] = {
    "class_name": "ActorCritic",
    "actor_hidden_dims": [256, 256, 256],
    "critic_hidden_dims": [256, 256, 256],
    "actor_obs_normalization": True,
    "critic_obs_normalization": True,
    "dtype": torch.bfloat16,
}
# examples/distill_privileged.py:40-56: the headline policy, sigma-floored,
# trained with PPO on the privileged obs of DomainRandomizedNLink
PPO_FF256X3_BF16_DR = copy.deepcopy(PPO_FF256X3_BF16)
PPO_FF256X3_BF16_DR["obs_groups"] = {"policy": ["privileged"], "critic": ["privileged"]}
PPO_FF256X3_BF16_DR["policy"]["noise_std_floor"] = 0.01
PPO_FF256X3_BF16_DR["algorithm"].update(schedule="adaptive", desired_kl=0.01)
# the blind student of examples/distill_privileged.py:64-85 with a GRU-256
# memory (StudentTeacherRecurrent), distilled from that teacher
DISTILL_GRU256_BF16 = {
    "num_steps_per_env": 24,
    "save_interval": 50,
    "seed": 2,
    "obs_groups": {"policy": ["policy"], "teacher": ["privileged"]},
    "policy": {
        "class_name": "StudentTeacherRecurrent",
        "rnn_type": "gru",
        "rnn_hidden_dim": 256,
        "student_obs_normalization": True,
        "teacher_obs_normalization": True,
        "student_hidden_dims": [256, 256, 256],
        "teacher_hidden_dims": [256, 256, 256],
        "dtype": torch.bfloat16,
    },
    "algorithm": {"class_name": "Distillation", "learning_rate": 1e-3, "gradient_length": 15,
                  "num_learning_epochs": 1},
}
DISTILL_LSTM256_BF16 = copy.deepcopy(DISTILL_GRU256_BF16)
DISTILL_LSTM256_BF16["policy"]["rnn_type"] = "lstm"
#: the students: (family, config, iterations)
DISTILL_SLICES = {"distill_gru256_bf16": ("gru", DISTILL_GRU256_BF16, 3),
                  "distill_lstm256_bf16": ("lstm", DISTILL_LSTM256_BF16, 1)}
TEACHER_ITERATIONS = 2
#: the dispatch phase's runs: the runner keys of each, eager first
DISPATCH_MODES = {"eager": {}, "fused": {"fuse_iteration": True}, "k2": {"iterations_per_dispatch": 2}}
# RND and symmetry on the GRU-256 flagship: benchmarks/parity_pendulum.py's
# rnd_cfg (its weight scaled by the env's step_dt) on 4096 NLinkPendulum envs
RECURRENT_GRU256_RND = copy.deepcopy(RECURRENT_GRU256)
RECURRENT_GRU256_RND["obs_groups"]["rnd_state"] = ["policy"]
RECURRENT_GRU256_RND["algorithm"]["rnd_cfg"] = parity_cfg(1, rnd=True)["algorithm"]["rnd_cfg"]
#: the symmetry modes: (use_data_augmentation, use_mirror_loss), on 4096
#: PointMass envs with benchmarks/parity_symmetry.py's augmentation
SYMMETRY_MODES = {"aug": (True, False), "mirror": (False, True), "log": (False, False)}
SYMMETRY_ITERATIONS = 2
# the parity study (a) of parity_torch.py: 40 seeds of 64 PartiallyObservableNLink envs
STUDY40 = {k: v for k, v in parity_cfg(1, recurrent=True).items() if k != "fuse_iteration"}
STUDY40_SEEDS, STUDY40_ENVS = 40, 64
#: the optimizers held under graphs on the feedforward headline
OPTIMIZERS = ("adamw", "sgd", "rmsprop")
NUM_ENVS, NUM_LINKS, ITERATIONS = 4096, 5, 3
NUM_SEEDS, ENVS_PER_SEED = 8, 512
# phase 4d: the rest of the study. PBT on the GRU study: an exchange every
# 2 iterations replacing floor(8 x 0.25) = 2 seeds (episode clocks scattered,
# so every seed has a fitness after iteration 1)
PBT_CFG = {"exploit_interval": 2, "exploit_fraction": 0.25}
#: the multi-seed students' iterations: the LSTM student runs 2, the fewest
#: in which a fused run replays its graph
STUDY_DISTILL = {"multiseed8_distill_gru256_bf16": ("gru_xp", DISTILL_GRU256_BF16, ITERATIONS),
                 "multiseed8_distill_lstm256_bf16": ("lstm_xp", DISTILL_LSTM256_BF16, 2)}
#: the symmetry studies: 8 seeds x 512 PointMass envs, their modes
STUDY_SYMMETRY = ("aug", "mirror")
WIDE_D = 520  # an input width beyond the x-streaming kernels' 512

# Tolerances of kernel against plain version. fp32: the two sum in another
# order (the plain version through cuBLAS); values of the forward are O(1).
# The backward sums over T*B = 24,576 rows, so its tolerances are relative to
# each tensor's max. bf16 operands: a one-ulp fp32 difference between the two
# can round an operand to the neighbouring bf16 value (2^-8 relative), and
# the recurrence carries that on, so the bound is that of bf16 rounding.
TOL = {
    False: {"fwd_rtol": 1e-4, "fwd_atol": 1e-5, "bwd_rtol": 1e-3, "bwd_atol_rel": 1e-4},
    True: {"fwd_rtol": 1e-3, "fwd_atol": 2e-3, "bwd_rtol": 1e-2, "bwd_atol_rel": 5e-3},
}
# Replay against acting. The memory outputs hold the bars of the JAX
# package's same-scheme test (tests/test_pallas_rnn.py:153-175): fp32
# differences of summation order, and in bf16 mode the operand roundings they
# flip. The policy mean and value: in fp32 summation-order bars; in bf16 the MLP
# trunks go through cuBLAS bf16 GEMMs at other shapes when acting ([4096,256])
# and replaying ([24*1024,256]), which may sum in another order (split-K with
# bf16 reductions is allowed by default) and round each layer's output to
# bf16 on its own, so a trunk activation may differ by a few bf16 ulps
# (2^-8 relative each): the bound is 8 ulps of bf16 at the output's scale.
MEMORY_TOL = {"rtol": 1e-3, "atol": 5e-4}
# (mean atol, relative to max(1, max |mean|)?, value atol relative to max(1, max |value|))
POLICY_TOL = {False: (1e-4, False, 1e-3), True: (2.0**-5, True, 2.0**-5)}

# Published dense peaks (NVIDIA data sheets): fp32 outside the tensor cores,
# bf16 on the tensor cores (held for the SXM part only; the bf16 bound of
# another part is left empty) and memory bandwidth, by part.
PEAKS = {
    "PCIe": {"fp32_flops": 51e12, "bf16_flops": None, "bytes_per_s": 2.0e12},
    "NVL": {"fp32_flops": 60e12, "bf16_flops": None, "bytes_per_s": 3.9e12},
    "SXM": {"fp32_flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}
#: the kernels redesigned for Hopper after their bring-up, held for
#: bitwise-repeatable outputs in phase 3
REDESIGNED = ("gru_x_fwd", "lstm_x_fwd", "gru_xp_fwd", "lstm_xp_fwd", "gru_x_bwd", "lstm_x_bwd", "gru_xp_bwd",
              "lstm_xp_bwd", "gru_x_wgrad", "lstm_x_wgrad", "gru_xp_wgrad", "lstm_xp_wgrad")
#: (family, streams, T, B, H): H that the 128- and 64-wide tiles do not divide
#: (at H=200, 25 hidden columns a CTA of lstm_x_fwd's clusters), a ragged batch
#: (203 rows: no whole number of a cluster's rows), one-step windows, and the
#: hidden states above 256 (two columns a thread in the one-thread-per-column
#: kernels; the weights streamed from L2 in the cluster forwards); for the
#: xproj families also one stream more than the multi-seed path's 16 with
#: 130 rows at H=36 (no multiple of 4), a batch of 1 and of 7, H=1, 16 GRU
#: streams at H=288 (bf16: two weight slices do not fit a CTA, so a cluster
#: a stream in two waves, its slice resident), and 40 streams, at H=64 (a
#: cluster serves the weight slices of several) and at H=384 (a cluster a
#: stream: more clusters than the card runs at once); D = 15 (the xproj
#: families project it)
EDGE_CASES = [("lstm", 2, 5, 200, 200), ("lstm", 1, 1, 200, 128), ("gru", 2, 5, 200, 200),
              ("gru", 1, 1, 200, 128), ("gru_xp", 3, 5, 200, 200), ("lstm_xp", 3, 5, 200, 128),
              ("lstm", 1, 5, 203, 200), ("gru", 1, 5, 203, 200),
              ("lstm", 2, 3, 64, 384), ("lstm", 1, 2, 48, 512), ("gru", 2, 3, 64, 384), ("gru", 1, 2, 48, 512),
              ("gru_xp", 2, 3, 64, 384), ("gru_xp", 1, 2, 48, 512), ("lstm_xp", 2, 3, 64, 384),
              ("lstm_xp", 1, 2, 48, 512), ("gru_xp", 17, 24, 130, 36), ("lstm_xp", 17, 24, 130, 36),
              ("gru_xp", 16, 24, 1, 256), ("lstm_xp", 16, 24, 1, 256), ("gru_xp", 3, 1, 7, 1),
              ("lstm_xp", 3, 1, 7, 1), ("gru_xp", 16, 3, 64, 288), ("gru_xp", 40, 5, 16, 64), ("lstm_xp", 40, 5, 16, 64),
              ("gru_xp", 40, 5, 16, 384), ("lstm_xp", 40, 5, 16, 384)]


#: the kernel shapes of phase 4c's paths: (family, streams, B, D, H) held
#: in phase 3 and timed in phase 5 (T=24, fp32): the paired replay of an
#: augmented PointMass minibatch, the actor's replay of the mirrored obs
#: (act_seq), and the 40 seeds' actor and critic memories of study (a)
PATH_SHAPES = {
    "symmetry_aug": ("gru", 2, 2048, 2, 256),
    "symmetry_mirror": ("gru", 1, 2048, 2, 256),
    "study40": ("gru_xp", 80, 16, 10, 64),
}
#: the xproj shapes of phase 4d's studies: (family, streams, B, D, H, T,
#: launches an iteration) held in both modes in phase 3 and timed in phase 5:
#: the multi-seed students' replay (8 seeds' student memories, the 15-step
#: segment and the 9-step tail of 512 envs), the augmented symmetry replay
#: (8 seeds' actor and critic memories over a minibatch of 128 envs and its
#: mirror copies) and the mirror loss's actor replay (8 seeds' actors)
STUDY_SHAPES = {
    "distill8_gru_t15": ("gru_xp", 8, 512, 15, 256, 15, (1, 1, 1)),
    "distill8_gru_t9": ("gru_xp", 8, 512, 15, 256, 9, (1, 0, 0)),
    "distill8_lstm_t15": ("lstm_xp", 8, 512, 15, 256, 15, (1, 1, 1)),
    "distill8_lstm_t9": ("lstm_xp", 8, 512, 15, 256, 9, (1, 0, 0)),
    "symmetry8_aug": ("gru_xp", 16, 256, 2, 256, 24, (20, 20, 20)),
    "symmetry8_mirror": ("gru_xp", 8, 256, 2, 256, 24, (20, 20, 20)),
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[str, dict]:
    if "H100" not in name:
        fail(f"peak rates are tabulated for the H100 only, got {name!r}")
    part = "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    return part, PEAKS[part]


def cell_of(family: str) -> str:
    return family.split("_")[0]


def plain(name: str):
    """The plain PyTorch version of a kernel entry point: ``gru_x_fwd`` ->
    ``gru_x_plain_fwd``."""
    head, tail = name.rsplit("_", 1)
    module = gru_rnn if name.startswith("gru") else lstm_rnn
    return getattr(module, f"{head}_plain_{tail}")


def make_inputs(family, S, T, B, D, H, seed):
    """Random replay inputs on the card: torch-default RNN init, normal
    inputs, 15% resets (none at t=0), a random carry and output gradient.
    ``x["w"]`` holds the positional inputs of the family's kernels: for the
    xproj families, the input projection of ``xs`` and one reset mask per
    stream."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    xp = family.endswith("_xp")
    resets = (torch.rand(*((S,) if xp else ()), T, B, generator=g) < 0.15).float()
    resets[..., 0, :] = 0.0
    if cell_of(family) == "gru":
        tensors = {
            "wx": u(S, D, 3 * H), "bx": u(S, 3 * H), "wh": u(S, H, 3 * H), "bhn": u(S, H),
            "carry0": torch.randn(S, B, H, generator=g) * 0.5,
        }
    else:
        tensors = {
            "wx": u(S, D, 4 * H), "wh": u(S, H, 4 * H), "bh": u(S, 4 * H),
            "c0": torch.randn(S, B, H, generator=g), "h0": torch.randn(S, B, H, generator=g) * 0.5,
        }
    tensors.update(xs=torch.randn(S, T, B, D, generator=g), resets=resets,
                   ghs=torch.randn(S, T, B, H, generator=g))
    x = {k: v.cuda().contiguous() for k, v in tensors.items()}
    if cell_of(family) == "gru":
        x["h0"] = x["carry0"]  # the hidden state entering step 0, as for the LSTM
        names = ("wh", "bhn", "carry0", "xproj", "resets") if xp else ("wx", "bx", "wh", "bhn", "carry0", "xs", "resets")
    else:
        names = ("wh", "bh", "c0", "h0", "xproj", "resets") if xp else ("wx", "wh", "bh", "c0", "h0", "xs", "resets")
    if xp:
        mod = FAMILIES[family]["module"]
        weights = (x["wx"], x["bx"]) if cell_of(family) == "gru" else (x["wx"],)
        x["xproj"] = mod.input_projection(*weights, x["xs"]).contiguous()
    x["w"] = tuple(x[k] for k in names)
    return x


def compare(got, want, rtol, atol, relative_atol):
    """``(max abs error, max |want|, within |err| <= rtol*|want| + atol)``,
    with ``atol`` scaled by ``max |want|`` when ``relative_atol``."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    bound = atol * (scale if relative_atol else 1.0)
    ok = bool(torch.all(err <= rtol * want.abs() + bound)) and bool(torch.isfinite(got).all())
    return float(err.max()), scale, ok


def forward_state(family, hs_cs):
    """The forward outputs the backward takes: ``(hs,)`` or ``(hs, cs)``."""
    return (hs_cs,) if cell_of(family) == "gru" else hs_cs


def wgrad_rows(family, x, state, gs):
    """The weight-gradient reduction's inputs (the xproj one has no x columns)."""
    rows = (x["resets"], x["h0"], state[0], gs)
    return rows if family.endswith("_xp") else (x["xs"], *rows)


def check_kernels(family, S, T, B, D, H, bf16, seed, resets_at_start=False):
    """One case: each kernel of the family against its plain version on the
    same inputs (with ``resets_at_start``, a third of the rows reset at t=0
    too). The backward and the reduction both take the plain version's
    upstream outputs, so each kernel is held against its plain version alone.
    Returns ``(results, repeatable)``: two calls of each redesigned kernel
    compared bit for bit."""
    mod = FAMILIES[family]["module"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    x = make_inputs(family, S, T, B, D, H, seed)
    if resets_at_start:
        x["resets"][..., 0, : B // 3] = 1.0
    tol = TOL[bf16]
    w = x["w"]
    state = forward_state(family, plain(fwd)(*w, bf16))
    want = plain(bwd)(*w, *state, x["ghs"], bf16)
    rows = wgrad_rows(family, x, state, want[-1])
    calls = {fwd: (lambda: forward_state(family, getattr(mod, fwd)(*w, bf16)), state, False),
             bwd: (lambda: getattr(mod, bwd)(*w, *state, x["ghs"], bf16), want, True),
             wgrad: (lambda: getattr(mod, wgrad)(*rows, bf16), plain(wgrad)(*rows, bf16), True)}
    result, repeat = {}, {}
    for name, (call, ref, relative) in calls.items():
        got = [t.clone() for t in call()]
        rtol, atol = (tol["bwd_rtol"], tol["bwd_atol_rel"]) if relative else (tol["fwd_rtol"], tol["fwd_atol"])
        result[name] = [compare(a, b, rtol, atol, relative) for a, b in zip(got, ref)]
        if name in REDESIGNED:
            repeat[name] = all(torch.equal(a, b) for a, b in zip(got, call()))
    torch.cuda.synchronize()
    return result, repeat


def kernel_calls(family, x, bf16=False):
    """``{kernel: (kernel call, plain-version call)}`` on the inputs ``x`` in
    the given operand mode, and the reduction's inputs for its library
    yardstick."""
    mod = FAMILIES[family]["module"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    w = x["w"]
    state = forward_state(family, getattr(mod, fwd)(*w, bf16))
    rows = wgrad_rows(family, x, state, getattr(mod, bwd)(*w, *state, x["ghs"], bf16)[-1])
    calls = {
        fwd: (lambda: getattr(mod, fwd)(*w, bf16), lambda: plain(fwd)(*w, bf16)),
        bwd: (lambda: getattr(mod, bwd)(*w, *state, x["ghs"], bf16),
              lambda: plain(bwd)(*w, *state, x["ghs"], bf16)),
        wgrad: (lambda: getattr(mod, wgrad)(*rows, bf16), lambda: plain(wgrad)(*rows, bf16)),
    }
    return calls, rows


def mode_times(family, x, reps=20):
    """``{bf16: {kernel: (ms, plain ms)}}`` in both operand modes, and the
    reduction's inputs (fp32 mode)."""
    times = {}
    for bf16 in (False, True):
        calls, rows_bf16 = kernel_calls(family, x, bf16)
        if not bf16:
            rows = rows_bf16
        times[bf16] = {name: (time_ms(kernel, reps), time_ms(plain_call, 5))
                       for name, (kernel, plain_call) in calls.items()}
    return times, rows


def phase_split(family, x, bf16, reps=10) -> str:
    """The mean milliseconds of the three phases (gates, chain, dx) of the
    family's backward over ``reps`` timing calls (CUDA events between the
    phases; each call waits for the stream), as a line."""
    mod = FAMILIES[family]["module"]
    fwd, bwd, _ = FAMILIES[family]["kernels"]
    w = x["w"]
    state = forward_state(family, getattr(mod, fwd)(*w, bf16))
    timed = getattr(mod, f"{bwd}_phase_ms")
    timed(*w, *state, x["ghs"], bf16)
    gates, chain, dx = np.mean([timed(*w, *state, x["ghs"], bf16) for _ in range(reps)], axis=0)
    return (f"gates {gates:.4f} ms, chain {chain:.4f} ms ({chain / x['xs'].shape[1] * 1e3:.1f} us a step),"
            f" dx {dx:.4f} ms")


def fmt_ms(ms) -> str:
    return "not held for this part" if ms is None else f"{ms:.4f} ms"


def bound_ms(ops, nbytes, peaks, bf16):
    """The card's least time for the work and what bounds it: operations at
    the fp32 peak (bf16 mode: the bf16 tensor-core peak, ``None`` where the
    script holds none) or bytes at the memory rate."""
    peak = peaks["bf16_flops" if bf16 else "fp32_flops"]
    if peak is None:
        return None, None
    t_ops, t_bytes = ops / peak * 1e3, nbytes / peaks["bytes_per_s"] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def work(family, S, T, B, D, H):
    """Operations and bytes each kernel's function needs (fp32, 4 B a value):
    every input read once, every output written once."""
    f = 4
    rows = T * B
    G = FAMILIES[family]["gates"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    if cell_of(family) == "gru":
        rec_weights = S * (H * 3 * H + H)  # wh, bhn
        bias_cols = H  # dbhn
        carries = S * B * H  # carry0 in, dcarry0 out
        states = S * rows * H  # hs
    else:
        rec_weights = S * (H * 4 * H + 4 * H)  # wh, bh
        bias_cols = 4 * H  # dbh
        carries = 2 * S * B * H  # (c0, h0) in, (dc0, dh0) out
        states = 2 * S * rows * H  # hs, cs
    if family.endswith("_xp"):
        # the input projection comes in, G*H columns a row; one reset mask a stream
        fwd_ops = S * 2 * rows * H * G * H
        inputs = S * rows * G * H + S * rows + carries + rec_weights
        return {
            fwd: (fwd_ops, f * (inputs + states)),
            # recompute of h @ Wh and dgates @ Whᵀ; out: the gate-gradient scratch
            bwd: (2 * fwd_ops, f * (inputs + states + S * rows * H + carries + S * rows * 4 * H)),
            # dWh and the bias sums
            wgrad: (S * (2 * rows * H * G * H + rows * bias_cols),
                    f * (S * rows + S * B * H + S * rows * H + S * rows * 4 * H + S * (H * G * H + bias_cols))),
        }
    weights = rec_weights + S * D * G * H + (S * 3 * H if cell_of(family) == "gru" else 0)
    fwd_ops = S * 2 * rows * (H + D) * G * H
    return {
        fwd: (fwd_ops, f * (S * rows * D + rows + carries + weights + states)),
        # recompute of the forward products, dgates @ Whᵀ, dgates @ Wxᵀ
        bwd: (
            fwd_ops + S * 2 * rows * G * H * (H + D),
            f * (S * rows * D + rows + carries + weights + states + S * rows * H
                 + S * rows * D + carries + S * rows * 4 * H),
        ),
        # dWh, dWx products and the bias sums
        wgrad: (
            S * (2 * rows * (H + D) * G * H + rows * 4 * H),
            f * (S * rows * D + rows + S * B * H + S * rows * H + S * rows * 4 * H
                 + S * (H + D + 1) * 4 * H),
        ),
    }


def cudnn_rnn(family, x, s):
    """cuDNN's ``torch.nn.GRU`` / ``torch.nn.LSTM`` holding stream ``s``'s
    weights: with no resets the same function as the replay."""
    D, H = x["wx"].shape[1], x["wh"].shape[1]
    if cell_of(family) == "gru":
        net = torch.nn.GRU(D, H).cuda()
        with torch.no_grad():
            net.weight_ih_l0.copy_(x["wx"][s].T)
            net.weight_hh_l0.copy_(x["wh"][s].T)
            net.bias_ih_l0.copy_(x["bx"][s])
            net.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device="cuda"), x["bhn"][s]]))
    else:
        net = torch.nn.LSTM(D, H).cuda()
        with torch.no_grad():
            net.weight_ih_l0.copy_(x["wx"][s].T)
            net.weight_hh_l0.copy_(x["wh"][s].T)
            net.bias_ih_l0.zero_()
            net.bias_hh_l0.copy_(x["bh"][s])
    return net


def fwd_bwd_ms(fwd, leaves, ghs, reps):
    """Forward ms, backward ms (gradients of every leaf) and the forward's
    output of a differentiable replay ``fwd()``."""
    fwd_ms = time_ms(fwd, reps)
    out = fwd()
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, ghs, retain_graph=True), reps)
    return fwd_ms, bwd_ms, out.detach()


def library_rnn_ms(family, S, x, reps):
    """cuDNN on the same shapes with no resets: forward ms, backward ms (data
    and weight gradients together) for S streams, and the forward output of
    stream 0 for an agreement check."""
    nets = [cudnn_rnn(family, x, s) for s in range(S)]
    xs = [x["xs"][s].clone().requires_grad_(True) for s in range(S)]
    if cell_of(family) == "gru":
        carry = [x["carry0"][s][None].clone().requires_grad_(True) for s in range(S)]
        leaves = [[c] for c in carry]
    else:
        carry = [(x["h0"][s][None].clone().requires_grad_(True), x["c0"][s][None].clone().requires_grad_(True))
                 for s in range(S)]
        leaves = [list(c) for c in carry]
    grads_in = [p for s in range(S) for p in (xs[s], *leaves[s], *nets[s].parameters())]

    def fwd():
        return torch.stack([nets[s](xs[s], carry[s])[0] for s in range(S)])

    fwd_ms, bwd_ms, out = fwd_bwd_ms(fwd, grads_in, x["ghs"], reps)
    return fwd_ms, bwd_ms, out[0]


def port_replay_ms(family, x, reps):
    """The port's whole xproj replay (``*_sequence_xproj``: the outside
    projection and the xproj kernels) with no resets: forward ms, backward ms
    (every gradient) and its output of stream 0."""
    mod = FAMILIES[family]["module"]
    names = ("wx", "bx", "wh", "bhn") if cell_of(family) == "gru" else ("wx", "wh", "bh")
    params = {k: x[k].clone().requires_grad_(True) for k in names}
    carry = [x[k].clone().requires_grad_(True) for k in (("carry0",) if cell_of(family) == "gru" else ("c0", "h0"))]
    xs = x["xs"].clone().requires_grad_(True)
    no_resets = torch.zeros_like(x["resets"])

    def fwd():
        if cell_of(family) == "gru":
            return mod.gru_sequence_xproj(params, carry[0], xs, no_resets)
        return mod.lstm_sequence_xproj(params, tuple(carry), xs, no_resets)[0]

    fwd_ms, bwd_ms, out = fwd_bwd_ms(fwd, [*params.values(), *carry, xs], x["ghs"], reps)
    return fwd_ms, bwd_ms, out[0]


def library_wgrad_ms(rows, reps):
    """One ``torch.bmm`` of the prepared ``[h_masked | x | 1]ᵀ [S, M, T*B]``
    (no x columns for the xproj reduction) by the gate-gradient scratch
    ``[S, T*B, 4H]``: the function of the weight-gradient reduction (in fp32;
    the bf16 mode has no library call)."""
    *xs, resets, h0, hs, gs = rows
    S, T, B, H = hs.shape
    keep = 1.0 - (resets if resets.ndim == 3 else resets[None])
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * keep[..., None]
    A = torch.cat([h_prev, *xs, torch.ones(S, T, B, 1, device=hs.device)], dim=-1).reshape(S, T * B, -1)
    At, G = A.transpose(1, 2), gs.reshape(S, T * B, 4 * H)
    return time_ms(lambda: torch.bmm(At, G), reps)


def all_counts() -> dict:
    return {
        name: getattr(getattr(fam["module"], fam["counts"]), f"{name.split('_')[-1]}_launches")
        for fam in FAMILIES.values() for name in fam["kernels"]
    }


def reset_counts() -> None:
    for fam in FAMILIES.values():
        getattr(fam["module"], fam["counts"]).reset()


def check_launches(name, counts, expected: dict) -> dict:
    """Fail unless the slice launched each kernel as often as ``expected``
    says and no other; returns the kernels it launched."""
    want = {k: expected.get(k, 0) for k in counts}
    print(f"{name} launches: {counts} (expected {expected or 'none'}, 0 of the others)")
    if counts != want:
        fail(f"{name}: main path launches {counts}, expected {want}")
    return {k: v for k, v in counts.items() if v}


def ppo_launches(family, cfg) -> dict:
    """A PPO slice's launches: one of each of the family's kernels a minibatch."""
    alg_cfg = cfg["algorithm"]
    expected = ITERATIONS * alg_cfg["num_learning_epochs"] * alg_cfg["num_mini_batches"]
    return {k: expected for k in FAMILIES[family]["kernels"]}


def distill_launches(family, cfg, iterations) -> dict:
    """A distillation slice's launches: an update replays each chunk of its
    gradient segments forward and backward (one launch of each kernel), and
    the chunks of the tail that fills no segment forward only."""
    T, alg = cfg["num_steps_per_env"], cfg["algorithm"]
    total, seg = alg["num_learning_epochs"] * T, alg["gradient_length"]
    trained = len(chunks_between(0, total // seg * seg, T))
    tail = len(chunks_between(total // seg * seg, total, T))
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    return {fwd: iterations * (trained + tail), bwd: iterations * trained, wgrad: iterations * trained}


def print_history(name, runner) -> None:
    for row in runner.history:
        bad = {k: v for k, v in row["metrics"].items() if not np.isfinite(v).all()}
        if bad:
            fail(f"{name}: non-finite metrics in iteration {row['iteration']}: {bad}")
        print(f"{name} iteration {row['iteration']}: collection {row['collection_s']:.4f} s,"
              f" learning {row['learn_s']:.4f} s, {row['steps_per_s']:.0f} env-steps/s,"
              f" losses " + ", ".join(f"{k}={np.round(v, 4)}" for k, v in row["metrics"].items()
                                      if k.startswith("Loss/")))
    print(f"{name}: " + json.dumps({"iterations": [
        {k: row[k] for k in ("iteration", "collection_s", "learn_s", "steps_per_s")}
        for row in runner.history]}))


def replay_outputs(policy, obs, carry0, resets):
    """The kernel replay of a window (``act_value_seq``'s mean and value, and
    the paired memory replay) beside the acting-time memory outputs (one
    ``Memory.step`` at a time)."""
    mean, _, value = policy.act_value_seq(obs, carry0, resets)
    xa, xc = policy._actor_in(obs), policy._critic_in(obs)
    fa, fc = paired_sequence(policy.memory_a, carry0["actor"], xa, policy.memory_c, carry0["critic"], xc, resets)
    ra = memory_sequence(policy.memory_a, carry0["actor"], xa, resets)
    rc = memory_sequence(policy.memory_c, carry0["critic"], xc, resets)
    return mean, value, fa, fc, ra, rc


class _Replay(torch.nn.Module):
    """:func:`replay_outputs` as a module, for ``torch.func.functional_call``
    with one seed's state."""

    def __init__(self, policy):
        super().__init__()
        self.policy = policy

    def forward(self, obs, carry0, resets):
        return replay_outputs(self.policy, obs, carry0, resets)


def check_replay(label, outputs, mu, values, bf16) -> bool:
    """Hold one seed's kernel replay against its acting-time outputs."""
    mean, value, fa, fc, ra, rc = outputs
    ok = True
    for role, got, want in (("actor", fa, ra), ("critic", fc, rc)):
        err, scale, mem_ok = compare(got, want, MEMORY_TOL["rtol"], MEMORY_TOL["atol"], False)
        ok &= mem_ok
        print(f"{label} replay vs acting, {role} memory outputs: max_abs_err={err:.3e}"
              f" (max |acting| {scale:.3g}; rtol {MEMORY_TOL['rtol']:g} atol {MEMORY_TOL['atol']:g})"
              f" {'ok' if mem_ok else 'FAIL'}")
    mu_tol, mu_relative, v_tol = POLICY_TOL[bf16]
    err_mu = float((mean - mu).abs().max())
    err_v = float((value - values).abs().max())
    mu_bound = mu_tol * (max(1.0, float(mu.abs().max())) if mu_relative else 1.0)
    v_bound = v_tol * max(1.0, float(values.abs().max()))
    print(f"{label} replay vs acting over a collected window: mean max_abs_err={err_mu:.3e}"
          f" (bound {mu_bound:.3e}), value max_abs_err={err_v:.3e} (bound {v_bound:.3e})")
    return ok and err_mu < mu_bound and err_v < v_bound


#: the functional envs whose random draws phase 4 holds on the card against
#: the CPU: constructors ``(num_envs, device, max_episode_length)`` and the
#: state fields computed from the draws through cos / sin (Reacher's target
#: is ``radius * (cos, sin)(angle)``), which CUDA's and the CPU's math
#: libraries may round an ulp apart: those are held at DERIVED_ATOL, the
#: draws themselves and every other field bit for bit
DRAW_ENVS = {
    "NLinkPendulum": (lambda n, device, m: NLinkPendulum(n, NUM_LINKS, max_episode_length=m, device=device), ()),
    "DomainRandomizedNLink": (lambda n, device, m: DomainRandomizedNLink(n, NUM_LINKS, max_episode_length=m,
                                                                          device=device), ()),
    "CartPoleSwingUp": (lambda n, device, m: CartPoleSwingUp(n, max_episode_length=m, device=device), ()),
    "Reacher": (lambda n, device, m: Reacher(n, max_episode_length=m, device=device), ("target",)),
    "Hopper": (lambda n, device, m: Hopper(n, max_episode_length=m, device=device), ()),
    "SparseGoalReach": (lambda n, device, m: SparseGoalReach(n, max_episode_length=m, device=device), ()),
}
DERIVED_ATOL = 2.4e-7  # 4 ulps of fp32 at |x| < 1


def env_draws(make_env, device: str) -> list[tuple[str, torch.Tensor]]:
    """The env's reset state on ``device`` and, after a step in which half
    the envs reset, every key and the reset envs' fresh draws (the other
    envs' physics may round differently on two devices), on the CPU, by
    field name."""
    env = make_env(NUM_ENVS, device, 2)
    state, _ = env.reset(3)
    first = [(k, v.cpu().clone()) for k, v in vars(state).items()]
    state.episode_length[::2] = 1  # these envs reset in the step
    state, *_ = env.step(state, torch.zeros(NUM_ENVS, env.num_actions, device=device))
    fresh = [(k, v[::2].cpu()) for k, v in vars(state).items() if k not in ("rng", "episode_length")]
    return first + [("rng", state.rng.cpu())] + fresh


def check_env_draws() -> None:
    """Each env's random draws on the card give the CPU's bits (the domain-
    randomized env's mass scales too): they come from per-env keys in the
    state (integer hashing), not from a device generator."""
    for name, (make_env, derived) in DRAW_ENVS.items():
        cpu, card = env_draws(make_env, "cpu"), env_draws(make_env, "cuda")
        same = len(cpu) == len(card) and all(
            k == k2 and (torch.equal(a, b) if k not in derived else bool((a - b).abs().max() <= DERIVED_ATOL))
            for (k, a), (k2, b) in zip(cpu, card))
        note = ""
        if derived:
            worst = max(float((a - b).abs().max()) for (k, a), (_, b) in zip(cpu, card) if k in derived)
            note = f" ({', '.join(derived)} from cos / sin of the draws: max_abs_err={worst:.3e}, atol {DERIVED_ATOL:g})"
        print(f"{name} draws on the card equal the CPU's through a reset and a step: {same}{note}")
        if not same:
            fail(f"{name}'s random draws differ between the card and the CPU")


def run_slice(name, family, cfg, T, B):
    """Train ``cfg`` for ITERATIONS through ``OnPolicyRunner.learn`` with the
    launch counters zeroed just before and read just after; then hold the
    kernel replay of a collected window against the acting-time outputs.
    Returns the launches of the family's kernels."""
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda")
    runner = OnPolicyRunner(env, cfg, device="cuda")
    reset_counts()
    runner.learn(ITERATIONS)
    torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), ppo_launches(family, cfg))
    print_history(name, runner)

    # the kernel replay of a fresh window reproduces the acting-time outputs
    # (the PPO invariant: replayed log-probs equal behavior log-probs). The
    # normalizers are frozen for this window, since the update replays with
    # the moments as they stand after the collection.
    policy = runner.alg.policy
    for norm in (policy.norm_actor, policy.norm_critic):
        norm.until = float(norm.count)
    _, rollout, _ = runner.alg.collect(env, runner.collect_state, T)
    with torch.no_grad():
        carry0 = slice_envs(rollout.carry0, 0, B, axis=0)
        obs = {k: v[:, :B] for k, v in rollout.obs.items()}
        outputs = replay_outputs(policy, obs, carry0, rollout.replay_resets()[:, :B])
    if not check_replay(name, outputs, rollout.mu[:, :B], rollout.values[:, :B], policy.dtype is not None):
        fail(f"{name}: kernel replay does not reproduce the acting-time outputs")
    return launches


def run_multiseed_slice(name, family, cfg, T, B):
    """Train ``cfg`` for NUM_SEEDS seeds through ``MultiSeedRunner.learn``
    with the launch counters zeroed just before and read just after; check
    finite, per-seed distinct losses, and hold each seed's kernel replay of a
    collected window against its acting-time outputs. Returns the launches
    of the family's kernels."""
    env = NLinkPendulum(ENVS_PER_SEED, NUM_LINKS, device="cuda")
    runner = MultiSeedRunner(env, cfg, NUM_SEEDS, device="cuda")
    reset_counts()
    runner.learn(ITERATIONS)
    torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), ppo_launches(family, cfg))
    print_history(name, runner)
    for row in runner.history:
        for k in ("Loss/value_function", "Loss/surrogate"):
            if len({float(v) for v in row["metrics"][k]}) != NUM_SEEDS:
                fail(f"{name}: {k} is not distinct across the {NUM_SEEDS} seeds: {row['metrics'][k]}")
    rewards, count = runner.seed_rewards()
    print(f"{name}: per-seed trailing mean rewards {np.round(rewards, 3).tolist()} ({count:.0f} episodes)")

    # as in run_slice, per seed; until=0 freezes every seed's normalizer
    policy, ts = runner.alg.policy, runner.train_state
    for norm in (policy.norm_actor, policy.norm_critic):
        norm.until = 0.0
    _, rollout, _ = runner.alg.collect_stacked(env, ts, runner.collect_state, T)
    replay = _Replay(policy)
    state = ({f"policy.{k}": v for k, v in ts.params.items()}, {f"policy.{k}": v for k, v in ts.buffers.items()})
    with torch.no_grad():
        carry0 = slice_envs(rollout.carry0, 0, B, axis=1)
        obs = {k: v[:, :, :B] for k, v in rollout.obs.items()}
        resets = rollout.replay_resets()[:, :, :B]
        outputs = vmap(lambda p, b, *a: functional_call(replay, (p, b), a))(*state, obs, carry0, resets)
    ok = True
    for g in range(NUM_SEEDS):
        ok &= check_replay(f"{name} seed {g}", [o[g] for o in outputs], rollout.mu[g, :, :B],
                           rollout.values[g, :, :B], policy.dtype is not None)
    if not ok:
        fail(f"{name}: kernel replay does not reproduce the acting-time outputs")
    return launches


def freeze(norm) -> None:
    """Stop a normalizer's updates, so a collected window and its replay see
    the same moments."""
    if norm is not None:
        norm.until = float(norm.count)


def run_ff_slice(name, cfg, T):
    """Train the feedforward headline for ITERATIONS through
    ``OnPolicyRunner.learn`` with the launch counters zeroed just before and
    read just after (it launches no kernel); then hold the update's batched
    MLPs over a collected window against the acting-time outputs."""
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda")
    runner = OnPolicyRunner(env, cfg, device="cuda")
    reset_counts()
    runner.learn(ITERATIONS)
    torch.cuda.synchronize()
    check_launches(name, all_counts(), {})
    print_history(name, runner)
    policy = runner.alg.policy
    freeze(policy.norm_actor)
    freeze(policy.norm_critic)
    _, rollout, _ = runner.alg.collect(env, runner.collect_state, T)
    with torch.no_grad():
        mean, _, value = policy.act_value_seq(rollout.obs, (), None)
    mu_tol, _, v_tol = POLICY_TOL[True]
    err_mu, err_v = float((mean - rollout.mu).abs().max()), float((value - rollout.values).abs().max())
    mu_bound = mu_tol * max(1.0, float(rollout.mu.abs().max()))
    v_bound = v_tol * max(1.0, float(rollout.values.abs().max()))
    print(f"{name} update batch vs acting over a collected window ([T*N] rows at once): mean max_abs_err="
          f"{err_mu:.3e} (bound {mu_bound:.3e}), value max_abs_err={err_v:.3e} (bound {v_bound:.3e})")
    if not (err_mu < mu_bound and err_v < v_bound):
        fail(f"{name}: the update's batched policy does not reproduce the acting-time outputs")


def check_student_replay(name, runner, T) -> None:
    """The kernel replay of a collected window in the update's chunks
    (``student_seq``: the x-streaming kernels at S=1 over T=15, then the
    9-step tail from the carry it leaves) against acting: the memory outputs
    against one ``Memory.step`` at a time, the actions against the
    acting-time means (the window is collected with zero noise)."""
    policy, alg = runner.alg.policy, runner.alg
    freeze(policy.norm_student)
    noise = torch.zeros(T, NUM_ENVS, NUM_LINKS, device="cuda")
    if runner.host_collect is None:
        _, rollout, _ = alg.collect(runner.env, runner.collect_state, T, action_noise=noise)
    else:  # a host env: the host collection window (its own steps; T must match)
        _, rollout, _ = runner.host_collect(runner.collect_state, action_noise=noise)
    resets = rollout.replay_resets()
    x = policy._student_in(rollout.obs)
    carry0 = rollout.carry0["student"]
    chunks = [(0, alg.gradient_length), (alg.gradient_length, T)]
    with torch.no_grad():
        feats, actions, carry = [], [], rollout.carry0
        for t0, t1 in chunks:
            a, carry_next = policy.student_seq({k: v[t0:t1] for k, v in rollout.obs.items()}, carry, resets[t0:t1])
            f, _ = policy.memory_s.sequence_with_carry(carry["student"], x[t0:t1], resets[t0:t1])
            feats.append(f)
            actions.append(a)
            carry = carry_next
        got, acting = torch.cat(feats), memory_sequence(policy.memory_s, carry0, x, resets)
        replayed = torch.cat(actions)
    err, scale, mem_ok = compare(got, acting, MEMORY_TOL["rtol"], MEMORY_TOL["atol"], False)
    print(f"{name} replay vs acting in chunks {chunks}, student memory outputs: max_abs_err={err:.3e}"
          f" (max |acting| {scale:.3g}; rtol {MEMORY_TOL['rtol']:g} atol {MEMORY_TOL['atol']:g})"
          f" {'ok' if mem_ok else 'FAIL'}")
    mu_tol = POLICY_TOL[True][0]
    err_a = float((replayed - rollout.actions).abs().max())
    bound = mu_tol * max(1.0, float(rollout.actions.abs().max()))
    print(f"{name} replay vs acting, student actions: max_abs_err={err_a:.3e} (bound {bound:.3e})")
    if not (mem_ok and err_a < bound):
        fail(f"{name}: kernel replay does not reproduce the student's acting-time actions")


def check_teacher(name, runner, teacher) -> None:
    """After ``load``, the student's teacher is the trained actor: the same
    fp32 parameters and normalizer on the card, and the same actions, bit
    for bit."""
    policy, actor = runner.alg.policy, teacher.alg.policy
    pairs = [(policy.teacher, actor.actor), (policy.norm_teacher, actor.norm_actor)]
    same = all(a.dtype == torch.float32 and a.is_cuda and torch.equal(a, b)
               for mine, theirs in pairs for a, b in zip(mine.state_dict().values(), theirs.state_dict().values()))
    obs = runner.collect_state.obs
    with torch.no_grad():
        got, _ = policy.evaluate(obs, policy.initial_carry(NUM_ENVS))
        want, _ = actor.act_inference(obs)
    same_actions = torch.equal(got, want)
    print(f"{name}: teacher parameters equal the trained actor's: {same}; teacher actions equal the actor's"
          f" on {NUM_ENVS} envs, bit for bit: {same_actions}")
    if not (same and same_actions):
        fail(f"{name}: the loaded teacher is not the trained actor")


def run_distill_slices(T, tmp) -> tuple[dict, str]:
    """Train the privileged teacher, save it under ``tmp``, and for each
    student load it into ``DistillationRunner`` and train with the launch
    counters zeroed just before and read just after; check the teacher and
    the student's kernel replay. Returns ``{slice: {kernel: launches}}`` and
    the teacher's checkpoint."""
    teacher = OnPolicyRunner(DomainRandomizedNLink(NUM_ENVS, NUM_LINKS, device="cuda"),
                             copy.deepcopy(PPO_FF256X3_BF16_DR), device="cuda")
    reset_counts()
    teacher.learn(TEACHER_ITERATIONS)
    torch.cuda.synchronize()
    check_launches("ppo_ff256x3_bf16_dr", all_counts(), {})
    print_history("ppo_ff256x3_bf16_dr", teacher)
    launches = {}
    path = os.path.join(tmp, f"model_{teacher.current_learning_iteration}.pt")
    teacher.save(path)
    for name, (family, cfg, iterations) in DISTILL_SLICES.items():
        runner = DistillationRunner(DomainRandomizedNLink(NUM_ENVS, NUM_LINKS, device="cuda"),
                                    copy.deepcopy(cfg), device="cuda")
        runner.load(path)
        check_teacher(name, runner, teacher)
        reset_counts()
        runner.learn(iterations)
        torch.cuda.synchronize()
        launches[name] = check_launches(name, all_counts(), distill_launches(family, cfg, iterations))
        print_history(name, runner)
        check_student_replay(name, runner, T)
    return launches, path


def run_state(runner) -> list[torch.Tensor]:
    """Every tensor a run carries from one iteration to the next: the
    policy's parameters and normalizer moments, the Adam moments, count and
    learning rate (stacked for a study, with each seed's RND state and the
    PBT state), the env state, obs, carries and episode sums."""
    if isinstance(runner, MultiSeedRunner):
        tree = runner._graph_state()  # the stacked train state (RND included), the collect and PBT states
    else:
        alg = runner.alg
        tree = (alg.policy.state_dict(), alg.adam_mu, alg.adam_nu, alg.adam_count, alg.lr, runner.collect_state)
        if alg.rnd is not None:  # predictor, target, both normalizers, counter, and the RND Adam
            opt = alg.rnd_optimizer
            tree += (alg.rnd.state_dict(), opt.adam_mu, opt.adam_nu, opt.adam_count)
    return [t.detach().clone() for t in flatten(tree)[0]]


def dispatch_runs(name, make_runner, smi, modes=tuple(DISPATCH_MODES), iterations=ITERATIONS,
                  expected=None) -> dict:
    """Train the slice eagerly, fused and at K=2 (``DISPATCH_MODES``, or the
    ``modes`` given) for ``iterations`` from the same seed; fail unless the
    graphed runs' state, metrics and launches equal the eager run's bit for
    bit and their metrics are finite, and, with ``expected``, unless the
    eager run launched what it says. Prints the steady env-steps/s of the
    runs, the capture's seconds and the graph pool's bytes. Returns the
    kernels the eager run launched."""
    runs = {}
    for mode in modes:
        runner = make_runner(DISPATCH_MODES[mode])
        reset_counts()
        runner.learn(iterations)
        torch.cuda.synchronize()
        counts = all_counts()
        for row in runner.history:
            bad = {k: v for k, v in row["metrics"].items() if not np.isfinite(v).all()}
            if bad:
                fail(f"{name} {mode}: non-finite metrics in iteration {row['iteration']}: {bad}")
        steady = runner.history[2:] if mode == "k2" else runner.history[1:]
        graph = runner.iteration_graph
        runs[mode] = {
            "state": run_state(runner), "counts": counts,
            "metrics": [{k: np.asarray(v) for k, v in row["metrics"].items()} for row in runner.history],
            "steps_per_s": float(np.mean([row["steps_per_s"] for row in steady])),
            "capture_s": None if graph is None else graph.capture_s,
            "pool_bytes": None if graph is None else graph.pool_bytes,
        }
        if graph is not None:
            graph.release()
        del runner, graph
        gc.collect()
        torch.cuda.empty_cache()
        runs[mode]["reserved_after"] = torch.cuda.memory_reserved()
    eager = runs["eager"]
    for mode in modes[1:]:
        run = runs[mode]
        differ = [i for i, (a, b) in enumerate(zip(eager["state"], run["state"])) if not torch.equal(a, b)]
        same_metrics = all(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
                           for a, b in zip(eager["metrics"], run["metrics"]))
        launched = {k: n for k, n in run["counts"].items() if n}
        print(f"dispatch {name} {mode}: state equal to eager bit for bit: {not differ}"
              f" ({len(run['state'])} tensors, differing {differ}); metrics equal: {same_metrics};"
              f" launches {launched or 'none'}, as eager: {run['counts'] == eager['counts']};"
              f" capture {run['capture_s']} s, graph pool {run['pool_bytes']} bytes; reserved after its release"
              f" {run['reserved_after']} bytes (after the eager run's {eager['reserved_after']})")
        if differ or len(run["state"]) != len(eager["state"]) or not same_metrics:
            fail(f"{name}: the {mode} run's state or metrics differ from the eager run's")
        if run["counts"] != eager["counts"]:
            fail(f"{name}: the {mode} run launched {run['counts']}, the eager run {eager['counts']}")
    print(f"dispatch {name} steady env-steps/s: " + json.dumps(
        {**{mode: runs[mode]["steps_per_s"] for mode in modes},
         "fused_capture_s": runs["fused"]["capture_s"], "fused_pool_bytes": runs["fused"]["pool_bytes"],
         "card": smi}))
    if expected is not None:
        return check_launches(f"{name} eager", eager["counts"], expected)
    return {k: n for k, n in eager["counts"].items() if n}


def dispatch_slices(teacher_path) -> dict:
    """Phase 4b's slices: ``{name: make_runner(runner keys)}``."""
    def nlink(envs):
        return NLinkPendulum(envs, NUM_LINKS, device="cuda")

    def ppo(cfg):
        return lambda keys: OnPolicyRunner(nlink(NUM_ENVS), {**copy.deepcopy(cfg), **keys}, device="cuda")

    def study(cfg):
        return lambda keys: MultiSeedRunner(nlink(ENVS_PER_SEED), {**copy.deepcopy(cfg), **keys}, NUM_SEEDS,
                                            device="cuda")

    def student(keys):
        runner = DistillationRunner(DomainRandomizedNLink(NUM_ENVS, NUM_LINKS, device="cuda"),
                                    {**copy.deepcopy(DISTILL_GRU256_BF16), **keys}, device="cuda")
        runner.load(teacher_path)
        return runner

    return {**{name: ppo(cfg) for name, (_, cfg) in SLICES.items()},
            **{name: study(cfg) for name, (_, cfg) in MULTISEED_SLICES.items()},
            "ppo_ff256x3_bf16": ppo(PPO_FF256X3_BF16), "distill_gru256_bf16": student}


def symmetry_launches(mode: str) -> dict:
    """A symmetry slice's launches: each minibatch replays the (augmented)
    batch through the paired x kernels; the mirror-loss mode adds the
    actor's replay of the mirrored obs at S=1 forward and backward, the
    logging mode that replay forward only."""
    minibatches = SYMMETRY_ITERATIONS * RECURRENT_GRU256["algorithm"]["num_learning_epochs"] * \
        RECURRENT_GRU256["algorithm"]["num_mini_batches"]
    extra = {"aug": (0, 0), "mirror": (1, 1), "log": (1, 0)}[mode]
    fwd, bwd, wgrad = FAMILIES["gru"]["kernels"]
    return {fwd: minibatches * (1 + extra[0]), bwd: minibatches * (1 + extra[1]),
            wgrad: minibatches * (1 + extra[1])}


def run_symmetry_slice(mode: str) -> dict:
    """Train the GRU-256 flagship with symmetry in ``mode`` on 4096
    ``PointMass`` envs (SYMMETRY_ITERATIONS, eager) with the launch counters
    zeroed just before and read just after; fail unless it launched
    :func:`symmetry_launches` and its metrics, the mirror loss among them,
    are finite."""
    name = f"recurrent_gru256_symmetry_{mode}"
    aug, mirror = SYMMETRY_MODES[mode]
    cfg = copy.deepcopy(RECURRENT_GRU256)
    cfg["algorithm"]["symmetry_cfg"] = {
        "use_data_augmentation": aug, "use_mirror_loss": mirror, "mirror_loss_coeff": 0.5 if mirror else 0.0,
        "data_augmentation_func": "rsl_rl_tpu_torch.env.toy:point_mass_symmetry"}
    runner = OnPolicyRunner(PointMass(NUM_ENVS, device="cuda"), cfg, device="cuda")
    reset_counts()
    runner.learn(SYMMETRY_ITERATIONS)
    torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), symmetry_launches(mode))
    print_history(name, runner)
    if "Loss/symmetry" not in runner.history[-1]["metrics"]:
        fail(f"{name}: no Loss/symmetry metric")
    return launches


def path_slices(smi) -> dict:
    """Phase 4c's paths: RND on the flagship eager, fused and
    at K=2; the three symmetry modes; the parity study (a) eager and fused;
    the feedforward headline with each optimizer eager and fused. Returns
    ``{slice: {kernel: launches}}`` of their eager runs."""
    by_slice = {}

    def rnd(keys):
        return OnPolicyRunner(NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda"),
                              {**copy.deepcopy(RECURRENT_GRU256_RND), **keys}, device="cuda")

    by_slice["recurrent_gru256_rnd"] = dispatch_runs("recurrent_gru256_rnd", rnd, smi,
                                                     expected=ppo_launches("gru", RECURRENT_GRU256_RND))
    for mode in SYMMETRY_MODES:
        by_slice[f"recurrent_gru256_symmetry_{mode}"] = run_symmetry_slice(mode)

    def study(keys):
        env = PartiallyObservableNLink(STUDY40_ENVS, NUM_LINKS, max_episode_length=400, device="cuda")
        return MultiSeedRunner(env, {**copy.deepcopy(STUDY40), **keys}, STUDY40_SEEDS, device="cuda")

    by_slice["multiseed40_po_nlink_gru64"] = dispatch_runs(
        "multiseed40_po_nlink_gru64", study, smi, modes=("eager", "fused"),
        expected=ppo_launches("gru_xp", STUDY40))
    _, G, B, _, H = PATH_SHAPES["study40"]
    print(f"grid gru_xp_fwd G={G} B={B} H={H} fp32 (XpFp32Cost's pick at study (a)):"
          f" {json.dumps(gru_rnn.gru_xp_fwd_plan(G, B, H, False))}")

    for optimizer in OPTIMIZERS:
        def headline(keys, optimizer=optimizer):
            cfg = copy.deepcopy(PPO_FF256X3_BF16)
            cfg["algorithm"]["optimizer"] = optimizer
            return OnPolicyRunner(NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda"), {**cfg, **keys}, device="cuda")

        dispatch_runs(f"ppo_ff256x3_bf16_{optimizer}", headline, smi, modes=("eager", "fused"), iterations=2,
                      expected={})
    return by_slice


def study_launches(family, iterations, per_minibatch=1) -> dict:
    """A PPO study's launches: each minibatch replays every seed's memories
    in ``per_minibatch`` launches of each xproj kernel."""
    alg = RECURRENT_GRU256["algorithm"]
    n = iterations * alg["num_learning_epochs"] * alg["num_mini_batches"] * per_minibatch
    return {k: n for k in FAMILIES[family]["kernels"]}


def check_clones(runner) -> None:
    """Right after an exchange (iteration 2 of an eager PBT study), each of
    the 2 replaced seeds holds its source's parameters, optimizer moments and
    normalizer moments, and a learning rate within the perturbation band."""
    ts = runner.train_state
    G = runner.num_seeds
    exploits = runner.history[-1]["metrics"]["PBT/exploits"]
    tensors = [*ts.params.values(), *ts.buffers.values(), *ts.adam_mu.values(), *ts.adam_nu.values()]
    same = [[all(torch.equal(t[i], t[j]) for t in tensors) for j in range(G)] for i in range(G)]
    in_pairs = sorted({i for i in range(G) for j in range(G) if i != j and same[i][j]})
    ratios = [float(ts.lr[i] / ts.lr[j]) for i in in_pairs for j in in_pairs if i < j and same[i][j]]
    print(f"pbt8_recurrent_gru256: after iteration 2 PBT/exploits={exploits}; seeds equal to another seed"
          f" {in_pairs}; learning-rate ratios within a cloned pair {np.round(ratios, 4).tolist()}")
    if int(exploits) != 2:
        fail(f"pbt8_recurrent_gru256: PBT/exploits reads {exploits} after iteration 2, expected 2")
    if not 3 <= len(in_pairs) <= 4 or not all(ratios) or not all(0.8 <= min(r, 1 / r) for r in ratios):
        fail(f"pbt8_recurrent_gru256: the exchange did not clone 2 seeds from the top: {in_pairs}, {ratios}")


def check_evaluation(name, runner, num_seeds=None) -> dict:
    """Evaluate ``runner``'s policy twice from one seed (the env's longest
    episode, ``act_inference``): equal metrics, every envs' episode
    completed, and the training state as it was. Returns the metrics."""
    before = run_state(runner)
    state = None if num_seeds is None else (runner.train_state.params, runner.train_state.buffers)
    steps = int(torch.as_tensor(runner.env.max_episode_length).max())
    start = time.perf_counter()
    first = evaluate_policy(runner.env, runner.alg.policy, state, steps, 11, num_seeds=num_seeds)
    seconds = time.perf_counter() - start
    again = evaluate_policy(runner.env, runner.alg.policy, state, steps, 11, num_seeds=num_seeds)
    after = run_state(runner)
    equal = all(np.array_equal(first[k], again[k]) for k in EVAL_KEYS)
    untouched = len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
    envs = runner.env.num_envs * (num_seeds or 1)
    print(f"eval {name}: {json.dumps({k: np.asarray(v).tolist() for k, v in first.items()})}; twice equal: {equal};"
          f" training state untouched: {untouched}; {steps} steps of {envs} envs in {seconds:.3f} s"
          f" ({steps * envs / seconds:.0f} env-steps/s)")
    if not (equal and untouched):
        fail(f"eval {name}: two evaluations differ or the training state moved")
    if not (np.all(np.asarray(first["Eval/episode_count"]) == runner.env.num_envs)
            and np.isfinite(np.asarray(first["Eval/mean_reward"])).all()):
        fail(f"eval {name}: not every env completed its episode, or a non-finite return")
    return first


def check_save_seed(study, tmp) -> None:
    """``save_seed`` of one seed loads into a fresh ``OnPolicyRunner`` on the
    card: the same parameters bit for bit, and its inference policy gives
    that seed's actions on that seed's obs."""
    seed = 3
    path = os.path.join(tmp, "seed.pt")
    study.save_seed(path, seed)
    single = OnPolicyRunner(NLinkPendulum(ENVS_PER_SEED, NUM_LINKS, device="cuda"), copy.deepcopy(RECURRENT_GRU256),
                            device="cuda")
    single.load(path)
    ts = study.train_state
    same = all(torch.equal(p, ts.params[n][seed]) for n, p in single.alg.policy.named_parameters())
    obs = {k: v[seed] for k, v in study.collect_state.obs.items()}
    state = ({k: v[seed] for k, v in ts.params.items()}, {k: v[seed] for k, v in ts.buffers.items()})
    with torch.no_grad():
        want, _ = functional_call(study.alg.policy, state, ("act_inference", obs,
                                                             single.alg.policy.initial_carry(ENVS_PER_SEED)))
    err = float((single.get_inference_policy()(obs) - want).abs().max())
    print(f"save_seed: seed {seed} loads into OnPolicyRunner, parameters equal: {same}; inference actions against"
          f" the study's seed {seed} on {ENVS_PER_SEED} envs: max_abs_err={err:.3e} (bound 1e-5)")
    if not (same and err <= 1e-5):
        fail("save_seed: the exported seed does not act as the study's seed")


def study_slices(smi, teacher_path, tmp) -> dict:
    """Phase 4d: the rest of the multi-seed study at 8 seeds x 512 envs,
    each eager, fused and at K=2 bit for bit with its launches: RND, the
    symmetry modes, PBT, the students (teacher through ``load_teacher``);
    then evaluation of the flagship and the study, and ``save_seed``.
    Returns ``{slice: {kernel: launches}}``."""
    by_slice = {}

    def study(cfg, env_cls=NLinkPendulum, pbt=None, scatter=False):
        def make(keys):
            env = env_cls(ENVS_PER_SEED, device="cuda") if env_cls is PointMass else \
                env_cls(ENVS_PER_SEED, NUM_LINKS, device="cuda")
            runner = MultiSeedRunner(env, {**copy.deepcopy(cfg), **keys}, NUM_SEEDS, device="cuda", pbt=pbt)
            if scatter:
                runner.collect_state.env_state = env.randomize_episode_length(runner.collect_state.env_state)
            return runner
        return make

    by_slice["multiseed8_recurrent_gru256_rnd"] = dispatch_runs(
        "multiseed8_recurrent_gru256_rnd", study(RECURRENT_GRU256_RND), smi,
        expected=study_launches("gru_xp", ITERATIONS))
    for mode in STUDY_SYMMETRY:
        aug, mirror = SYMMETRY_MODES[mode]
        cfg = copy.deepcopy(RECURRENT_GRU256)
        cfg["algorithm"]["symmetry_cfg"] = {
            "use_data_augmentation": aug, "use_mirror_loss": mirror, "mirror_loss_coeff": 0.5 if mirror else 0.0,
            "data_augmentation_func": "rsl_rl_tpu_torch.env.toy:point_mass_symmetry"}
        name = f"multiseed8_recurrent_gru256_symmetry_{mode}"
        # the mirror loss adds the seeds' actor replay of the mirrored obs
        by_slice[name] = dispatch_runs(name, study(cfg, PointMass), smi,
                                       expected=study_launches("gru_xp", ITERATIONS, 2 if mirror else 1))
    pbt_study = study(RECURRENT_GRU256, pbt=PBT_CFG, scatter=True)
    by_slice["pbt8_recurrent_gru256"] = dispatch_runs("pbt8_recurrent_gru256", pbt_study, smi,
                                                      expected=study_launches("gru_xp", ITERATIONS))
    runner = pbt_study({})
    runner.learn(2)
    check_clones(runner)
    del runner

    for name, (family, cfg, iterations) in STUDY_DISTILL.items():
        def student(keys, cfg=cfg):
            runner = MultiSeedRunner(DomainRandomizedNLink(ENVS_PER_SEED, NUM_LINKS, device="cuda"),
                                     {**copy.deepcopy(cfg), **keys}, NUM_SEEDS, device="cuda")
            runner.load_teacher(teacher_path)
            return runner

        modes = tuple(DISPATCH_MODES) if iterations >= 3 else ("eager", "fused")
        by_slice[name] = dispatch_runs(name, student, smi, modes=modes, iterations=iterations,
                                       expected=distill_launches(family, cfg, iterations))

    flagship = OnPolicyRunner(NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda"), copy.deepcopy(RECURRENT_GRU256),
                              device="cuda")
    flagship.learn(1)
    check_evaluation("recurrent_gru256", flagship)
    del flagship
    gru_study = study(RECURRENT_GRU256)({})
    gru_study.learn(1)
    check_evaluation("multiseed8_recurrent_gru256", gru_study, NUM_SEEDS)
    check_save_seed(gru_study, tmp)
    return by_slice


def study_shape_times(peaks, errs) -> dict:
    """Phase 5 at :data:`STUDY_SHAPES`: each kernel's time in both operand
    modes beside its plain version, its bounds, ``torch.bmm`` for the
    reduction (no single library call computes G streams of their own
    weights) and cuDNN on the raw input at G=1 as a yardstick; ``{kernel:
    {label: entry}}``."""
    out = {}
    for i, (label, (family, S, B, D, H, T, per_it)) in enumerate(STUDY_SHAPES.items()):
        x = make_inputs(family, S, T, B, D, H, seed=900 + i)
        times, rows = mode_times(family, x)
        fwd, bwd, wgrad = FAMILIES[family]["kernels"]
        g1 = dict(zip((fwd, bwd), library_rnn_ms(family, 1, make_inputs(family, 1, T, B, D, H, seed=950 + i),
                                                 20)[:2]))
        library = {fwd: None, bwd: None, wgrad: library_wgrad_ms(rows, 20)}
        for (name, (ops, nbytes)), launches in zip(work(family, S, T, B, D, H).items(), per_it):
            bound, bound_by = bound_ms(ops, nbytes, peaks, False)
            bf16_bound = bound_ms(ops, nbytes, peaks, True)[0]
            entry = {"S": S, "T": T, "B": B, "D": D, "H": H, "launches_per_iteration": launches,
                     "max_abs_err": errs[label][False][name], "bf16_max_abs_err": errs[label][True][name],
                     "ms": times[False][name][0], "plain_ms": times[False][name][1], "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library[name], "cudnn_g1_ms": g1.get(name),
                     "bf16_ms": times[True][name][0], "bf16_plain_ms": times[True][name][1],
                     "bf16_bound_ms": bf16_bound}
            out.setdefault(name, {})[label] = entry
            lib = "none" if library[name] is None else f"{library[name]:.4f} ms"
            g1_ms = "" if name not in g1 else f", cuDNN at G=1 {g1[name]:.4f} ms"
            print(f"time {name} at {label} G={S} T={T} B={B} D={D} H={H}: fp32 {entry['ms']:.4f} ms (plain"
                  f" {entry['plain_ms']:.4f} ms, bound {bound:.4f} ms, {bound_by}); bf16 {entry['bf16_ms']:.4f} ms"
                  f" (plain {entry['bf16_plain_ms']:.4f} ms, bound {fmt_ms(bf16_bound)}); library {lib}{g1_ms};"
                  f" {launches} launches an iteration")
    return out


def path_shape_times(peaks, path_err) -> dict:
    """Phase 5 at :data:`PATH_SHAPES`: each kernel's time in both operand
    modes beside its plain version, its bound and its library call (cuDNN's
    GRU for the x kernels' forward and backward, ``torch.bmm`` for the
    reductions; none for the xproj forward and backward); ``{kernel:
    {label: entry}}``."""
    out = {}
    T = RECURRENT_GRU256["num_steps_per_env"]
    for i, (label, (family, S, B, D, H)) in enumerate(PATH_SHAPES.items()):
        x = make_inputs(family, S, T, B, D, H, seed=700 + i)
        times, rows = mode_times(family, x)
        fwd, bwd, wgrad = FAMILIES[family]["kernels"]
        library = {fwd: None, bwd: None}
        if not family.endswith("_xp"):
            library = dict(zip((fwd, bwd), library_rnn_ms(family, S, x, 20)[:2]))
        library[wgrad] = library_wgrad_ms(rows, 20)
        for name, (ops, nbytes) in work(family, S, T, B, D, H).items():
            bound, bound_by = bound_ms(ops, nbytes, peaks, False)
            entry = {"S": S, "T": T, "B": B, "D": D, "H": H, "max_abs_err": path_err[label][name],
                     "ms": times[False][name][0], "plain_ms": times[False][name][1], "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library[name], "bf16_ms": times[True][name][0],
                     "bf16_bound_ms": bound_ms(ops, nbytes, peaks, True)[0]}
            out.setdefault(name, {})[label] = entry
            lib = "none" if library[name] is None else f"{library[name]:.4f} ms"
            print(f"time {name} at {label} S={S} B={B} D={D} H={H}: fp32 {entry['ms']:.4f} ms (plain"
                  f" {entry['plain_ms']:.4f} ms, library {lib}, bound {bound:.4f} ms, {bound_by}); bf16"
                  f" {entry['bf16_ms']:.4f} ms")
    return out


# ---- phase 6: the host-env path


class HostNLink(HostVecEnv):
    """Smoke-test scaffolding, not a package feature: the port's
    ``NLinkPendulum`` kept and stepped on the CPU behind the stateful numpy
    API of an external simulator (``env/host_env.py``), so the policy acts
    on the card and the env steps on the host. Its writable
    ``episode_length_buf`` is the env's clock: each step reads it and writes
    the new one back into the same array."""

    env_cls = NLinkPendulum

    def __init__(self, num_envs: int | None = None):
        num_envs = NUM_ENVS if num_envs is None else num_envs
        self.sim = self.env_cls(num_envs, NUM_LINKS, device="cpu")
        self.num_envs, self.num_actions = num_envs, self.sim.num_actions
        self.max_episode_length = int(self.sim.max_episode_length)
        self.episode_length_buf = np.zeros(num_envs, np.int32)
        self.state = None

    def reset(self, seed=None):
        self.state, obs = self.sim.reset(0 if seed is None else int(seed))
        self.episode_length_buf[:] = self.state.episode_length.numpy()
        return {k: v.numpy() for k, v in obs.items()}

    def step(self, actions):
        self.state.episode_length = torch.from_numpy(self.episode_length_buf)
        # one CPU thread, as a simulator process of its own would step: the
        # [4096]-wide elementwise ops gain nothing from torch's intra-op pool
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            self.state, obs, rew, done, extras = self.sim.step(self.state, torch.from_numpy(actions))
        finally:
            torch.set_num_threads(threads)
        self.episode_length_buf[:] = self.state.episode_length.numpy()
        return ({k: v.numpy() for k, v in obs.items()}, rew.numpy(), done.numpy(),
                {"time_outs": extras["time_outs"].numpy(), "log": {k: v.numpy() for k, v in extras["log"].items()}})


class HostDRNLink(HostNLink):
    """:class:`HostNLink` over ``DomainRandomizedNLink`` (``"policy"`` and
    ``"privileged"`` obs)."""

    env_cls = DomainRandomizedNLink


#: phase 6c: the remaining functional envs under the feedforward headline
#: (constructors at ``num_envs`` on the card), and benchmarks/bench_configs.py's
#: config #3, PPO with RND on 512 SparseGoalReach envs
REMAINING_ENVS = {
    "cartpole": lambda n: CartPoleSwingUp(n, device="cuda"),
    "reacher": lambda n: Reacher(n, device="cuda"),
    "hopper": lambda n: Hopper(n, device="cuda"),
    "sparse": lambda n: SparseGoalReach(n, device="cuda"),
}
PPO_RND_SPARSE_GOAL_512 = {
    "num_steps_per_env": 24, "save_interval": 10_000, "seed": 1,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"], "rnd_state": ["policy"]},
    "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [128, 128], "critic_hidden_dims": [128, 128],
               "actor_obs_normalization": True, "critic_obs_normalization": True},
    "algorithm": {"class_name": "PPO", "schedule": "adaptive", "desired_kl": 0.01, "entropy_coef": 0.01,
                  "rnd_cfg": {"weight": 2.0, "predictor_hidden_dims": [64, 64], "target_hidden_dims": [64, 64],
                              "num_outputs": 16, "state_normalization": True, "reward_normalization": True,
                              "learning_rate": 1e-3}},
}
# Phase 6d: the exported program runs act_inference's own ops, so it holds
# the fp32 bar of summation order alone; as_torch_policy's nn.GRU is cuDNN's
# (its own GEMMs and gate order) against the port's plain step over 50
# recurrent steps: the same bar, checked as |got - want| <= atol + rtol |want|
DEPLOY_TOL = {"rtol": 1e-6, "atol": 1e-6}
DEPLOY_STEPS = 50


def host_gru_slice(smi, T, B) -> tuple[dict, OnPolicyRunner]:
    """6a: the GRU-256 flagship on :class:`HostNLink` through
    ``OnPolicyRunner.learn(init_at_random_ep_len=True)``, the counters zeroed
    just before and read just after; checks finite metrics, the buffer
    randomized in place, finished episodes, then times two iterations with
    the collection's phases fenced, holds the kernel replay of a host window
    against acting, and runs ``fuse_iteration=True`` (eager, the same
    launches) and the refused keys. Returns the launches and the runner."""
    name = "recurrent_gru256_host"
    cfg = RECURRENT_GRU256
    env = HostNLink()
    runner = OnPolicyRunner(env, copy.deepcopy(cfg), device="cuda")
    buf = env.episode_length_buf
    reset_counts()
    runner.learn(ITERATIONS, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), ppo_launches("gru", cfg))
    print_history(name, runner)
    episodes = sum(row["metrics"]["ep_count"] for row in runner.history)
    spread = len(np.unique(buf))
    print(f"{name}: episode_length_buf randomized in place: {env.episode_length_buf is buf}, {spread} distinct"
          f" clocks in [{buf.min()}, {buf.max()}] (max_episode_length {env.max_episode_length});"
          f" {episodes:.0f} episodes finished")
    if not (env.episode_length_buf is buf and spread > min(100, env.num_envs // 2) and buf.max() < env.max_episode_length
            and episodes > 0):
        fail(f"{name}: the episode clocks were not randomized in place, or no episode finished")
    steady = runner.history[1:]

    # the collection's phases, each fenced (costs a synchronization a phase and step)
    runner.host_collect.timings = timings = {}
    runner.learn(2)
    timed = runner.history[-2:]
    collection_s = sum(row["collection_s"] for row in timed)
    report = {
        "steady_env_steps_per_s": float(np.mean([row["steps_per_s"] for row in steady])),
        "steady_collection_s": float(np.mean([row["collection_s"] for row in steady])),
        "steady_learn_s": float(np.mean([row["learn_s"] for row in steady])),
        "timed_env_steps_per_s": float(np.mean([row["steps_per_s"] for row in timed])),
        "timed_collection_s": collection_s / 2,
        "phase_s": {k: timings[k] / 2 for k in PHASES},
        "phase_share_of_collection": {k: timings[k] / collection_s for k in PHASES},
        "card": smi,
    }
    print(f"host {name} env-steps/s and collection split (per iteration): {json.dumps(report)}")
    runner.host_collect.timings = None

    # the kernel replay of a host window reproduces the acting-time outputs
    policy = runner.alg.policy
    freeze(policy.norm_actor)
    freeze(policy.norm_critic)
    _, rollout, _ = runner.host_collect(runner.collect_state)
    with torch.no_grad():
        carry0 = slice_envs(rollout.carry0, 0, B, axis=0)
        obs = {k: v[:, :B] for k, v in rollout.obs.items()}
        outputs = replay_outputs(policy, obs, carry0, rollout.replay_resets()[:, :B])
    if not check_replay(name, outputs, rollout.mu[:, :B], rollout.values[:, :B], False):
        fail(f"{name}: kernel replay does not reproduce the acting-time outputs")

    fused = OnPolicyRunner(HostNLink(), {**copy.deepcopy(cfg), "fuse_iteration": True}, device="cuda")
    reset_counts()
    fused.learn(ITERATIONS, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    print(f"{name} fuse_iteration=True: resolves to {fused.fuse_iteration}, graph {fused.iteration_graph}")
    if fused.fuse_iteration or fused.iteration_graph is not None:
        fail(f"{name}: fuse_iteration on a host env did not resolve to the split iteration")
    check_launches(f"{name} fuse_iteration=True", all_counts(), ppo_launches("gru", cfg))
    del fused
    for key, value in (("iterations_per_dispatch", 2), ("eval_interval", 1)):
        try:
            OnPolicyRunner(HostNLink(), {**copy.deepcopy(cfg), key: value}, device="cuda")
        except ValueError as err:
            print(f"{name} {key}={value}: ValueError ({err})")
        else:
            fail(f"{name}: {key}={value} on a host env did not raise")
    return launches, runner


def host_student_slice(teacher_path, T) -> dict:
    """6b: the GRU-256 bf16 student on :class:`HostDRNLink`, its teacher
    phase 4's checkpoint, 2 iterations with the counters zeroed just before
    and read just after; checks finite metrics and the replay of a host
    window in the update's chunks. Returns the launches."""
    name, iterations = "distill_gru256_bf16_host", 2
    runner = DistillationRunner(HostDRNLink(), copy.deepcopy(DISTILL_GRU256_BF16), device="cuda")
    runner.load(teacher_path)
    reset_counts()
    runner.learn(iterations)
    torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), distill_launches("gru", DISTILL_GRU256_BF16, iterations))
    print_history(name, runner)
    check_student_replay(name, runner, T)
    return launches


def remaining_env_slices(smi) -> None:
    """6c: the headline policy on 4096 envs of each remaining env, and config
    #3 (RND on 512 SparseGoalReach envs), eager and fused for 2 iterations,
    bit for bit, no kernel launched."""
    for name, make_env in REMAINING_ENVS.items():
        def make(keys, make_env=make_env):
            return OnPolicyRunner(make_env(NUM_ENVS), {**copy.deepcopy(PPO_FF256X3_BF16), **keys}, device="cuda")

        dispatch_runs(f"ppo_ff256x3_bf16_{name}", make, smi, modes=("eager", "fused"), iterations=2, expected={})

    def sparse_rnd(keys):
        env = SparseGoalReach(512, goal_dist=6.0, max_episode_length=100, device="cuda")
        return OnPolicyRunner(env, {**copy.deepcopy(PPO_RND_SPARSE_GOAL_512), **keys}, device="cuda")

    dispatch_runs("ppo_rnd_sparse_goal_512", sparse_rnd, smi, modes=("eager", "fused"), iterations=2, expected={})


def check_export(runner, tmp) -> None:
    """6d: ``export_policy`` of 6a's trained policy, reloaded with
    ``load_policy``, and ``as_torch_policy`` must give
    ``get_inference_policy()``'s actions over DEPLOY_STEPS steps of NUM_ENVS
    envs on the card, carries reset where episodes end (NLinkPendulum with a
    20-step limit and scattered clocks), at DEPLOY_TOL."""
    policy = runner.alg.policy
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, max_episode_length=20, device="cuda")
    state, obs = env.reset(5)
    state = env.randomize_episode_length(state)
    path = os.path.join(tmp, "policy.pt2")
    start = time.perf_counter()
    export_policy(policy, obs, path)
    export_s = time.perf_counter() - start
    loaded = load_policy(path)
    module = as_torch_policy(policy).eval()
    reference = runner.get_inference_policy()
    hidden = None
    err = {"export": 0.0, "as_torch_policy": 0.0}
    excess = {"export": 0.0, "as_torch_policy": 0.0}  # max of |got - want| - (atol + rtol |want|)
    resets = 0
    with torch.no_grad():
        for _ in range(DEPLOY_STEPS):
            want = reference(obs)
            got_t, hidden = module(torch.cat([obs[k] for k in module.obs_names], dim=-1), hidden)
            for label, got in (("export", loaded(obs)), ("as_torch_policy", got_t)):
                diff = (got - want).abs()
                err[label] = max(err[label], float(diff.max()))
                bound = DEPLOY_TOL["atol"] + DEPLOY_TOL["rtol"] * want.abs()
                excess[label] = max(excess[label], float((diff - bound).max()))
            state, obs, _, done, _ = env.step(state, want)
            reference.reset(done)
            loaded.reset(done)
            hidden[:, done] = 0.0
            resets += int(done.sum())
    ok = resets > 0 and all(v <= 0.0 for v in excess.values())
    print(f"export: {DEPLOY_STEPS} steps of {NUM_ENVS} envs ({resets} resets) against get_inference_policy():"
          f" max_abs_err {json.dumps(err)} (rtol {DEPLOY_TOL['rtol']:g} atol {DEPLOY_TOL['atol']:g}:"
          f" {'ok' if ok else 'FAIL'}); torch.export in {export_s:.2f} s, {os.path.getsize(path)} bytes")
    if not ok:
        fail("export: the exported policy or as_torch_policy does not act as get_inference_policy()")


def host_slices(smi, teacher_path, tmp, T, B) -> dict:
    """Phase 6; returns ``{slice: {kernel: launches}}``."""
    launches, runner = host_gru_slice(smi, T, B)
    by_slice = {"recurrent_gru256_host": launches,
                "distill_gru256_bf16_host": host_student_slice(teacher_path, T)}
    remaining_env_slices(smi)
    check_export(runner, tmp)
    return by_slice


def kernel_entry(name, family, launches, max_abs, passed, times, library_ms, ops, nbytes, peaks):
    """The kernel's line of the JSON result: fp32-mode time, plain time, bound
    and library time, and the bf16-mode time, plain time and bound."""
    (ms, plain_ms), (bf16_ms, bf16_plain_ms) = times[False][name], times[True][name]
    bound, bound_by = bound_ms(ops, nbytes, peaks, False)
    bf16_bound, bf16_bound_by = bound_ms(ops, nbytes, peaks, True)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    bf16_b = fmt_ms(bf16_bound) + ("" if bf16_bound is None else f" ({bf16_bound_by})")
    print(f"time {name}: fp32 {ms:.4f} ms (plain {plain_ms:.4f} ms, library {lib}, bound {bound:.4f} ms,"
          f" {bound_by}: {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); bf16 {bf16_ms:.4f} ms"
          f" (plain {bf16_plain_ms:.4f} ms, bound {bf16_b})")
    return {
        "name": name,
        "route": "cuda",
        "source": FAMILIES[family]["source"],
        "replaces": REPLACES[name][0],
        "also_replaces": REPLACES[name][1],
        "launches": sum(launches[name].values()),
        "launches_by_slice": launches[name],
        "max_abs_err": max_abs[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "bf16_ms": bf16_ms,
        "bf16_plain_ms": bf16_plain_ms,
        "bf16_bound_ms": bf16_bound,
        "bf16_bound_by": bf16_bound_by,
        "passed": passed[name],
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"TF32 off: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    kind = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(kind)
    print(f"device: {kind} ({part} peaks: {peaks['fp32_flops'] / 1e12:.0f} TFLOP/s fp32,"
          f" {peaks['bytes_per_s'] / 1e12:.2f} TB/s); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    start = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - start:.1f} s")
    for name, log in cuda_build.BUILD_LOG.items():
        lines = [ln.strip() for ln in log["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: nvcc {log['seconds']:.1f} s; ptxas: " + " | ".join(lines))

    # ---- 3. kernels against their plain versions
    T = RECURRENT_GRU256["num_steps_per_env"]
    num_mini_batches = RECURRENT_GRU256["algorithm"]["num_mini_batches"]
    B = NUM_ENVS // num_mini_batches
    B_seed = ENVS_PER_SEED // num_mini_batches
    G = 2 * NUM_SEEDS  # the seeds' actor and critic memories, one launch
    D = 3 * NUM_LINKS
    H = RECURRENT_GRU256["policy"]["rnn_hidden_dim"]
    max_abs = {}
    passed = {}
    repeatable = {}
    x_cases = [(2, T, B, D, bf16) for bf16 in (False, True)] + [(1, T, B, D, bf16) for bf16 in (False, True)]
    x_cases += [(2, 1, B, D, False), (2, 1, B, D, True)]
    # the distillation students' replay: the 15-step segment and the 9-step
    # tail of all 4096 envs at one stream
    seg = DISTILL_GRU256_BF16["algorithm"]["gradient_length"]
    x_cases += [(1, t, NUM_ENVS, D, bf16) for t in (seg, T - seg) for bf16 in (False, True)]
    student_err = {}
    xp_cases = [(G, T, B_seed, D, bf16) for bf16 in (False, True)] + [(1, T, B, WIDE_D, bf16) for bf16 in (False, True)]
    xp_cases += [(G, 1, B_seed, D, False), (G, 1, B_seed, D, True)]
    for offset, family, cases in ((100, "gru", x_cases), (200, "lstm", x_cases),
                                  (300, "gru_xp", xp_cases), (400, "lstm_xp", xp_cases)):
        for i, (S, t, b, d, bf16) in enumerate(cases):
            res, repeat = check_kernels(family, S, t, b, d, H, bf16, seed=offset + i)
            for name, same in repeat.items():
                repeatable[name] = repeatable.get(name, True) and same
            summary = []
            for name, checks in res.items():
                err = max(e for e, _, _ in checks)
                scale = max(m for _, m, _ in checks)
                ok = all(o for _, _, o in checks)
                passed[name] = passed.get(name, True) and ok
                if (S, t, bf16) == (cases[0][0], T, False):
                    max_abs[name] = err
                if (S, t, b, bf16) == (1, seg, NUM_ENVS, True):
                    student_err[name] = err
                summary.append(f"{name} max_abs_err={err:.3e} (max |plain| {scale:.3g})"
                               f" {'ok' if ok else 'FAIL'}")
            tol = TOL[bf16]
            print(f"check S={S} T={t} B={b} D={d} H={H} {'bf16' if bf16 else 'fp32'}"
                  f" (fwd rtol {tol['fwd_rtol']:g} atol {tol['fwd_atol']:g}; bwd rtol {tol['bwd_rtol']:g}"
                  f" atol {tol['bwd_atol_rel']:g} x max |plain|): " + "; ".join(summary))
    # every kernel at edge shapes, resets at t=0 and mid-window
    for i, (family, S, t, b, h) in enumerate(EDGE_CASES):
        for bf16 in (False, True):
            res, repeat = check_kernels(family, S, t, b, D, h, bf16, seed=500 + 10 * i + bf16, resets_at_start=True)
            summary = []
            for name, checks in res.items():
                ok = all(o for _, _, o in checks)
                passed[name] = passed[name] and ok
                if name in repeat:
                    repeatable[name] = repeatable[name] and repeat[name]
                summary.append(f"{name} max_abs_err={max(e for e, _, _ in checks):.3e}"
                               f" (max |plain| {max(m for _, m, _ in checks):.3g}) {'ok' if ok else 'FAIL'}"
                               + (f", {'bitwise repeatable' if repeat[name] else 'NOT REPEATABLE'}" if name in repeat else ""))
            print(f"edge {family} S={S} T={t} B={b} D={D} H={h} {'bf16' if bf16 else 'fp32'},"
                  f" resets at t=0: " + "; ".join(summary))
    # the shapes of phase 4c's paths
    path_err = {}
    for i, (label, (family, S, b, d, h)) in enumerate(PATH_SHAPES.items()):
        res, repeat = check_kernels(family, S, T, b, d, h, False, seed=600 + i)
        path_err[label] = {}
        summary = []
        for name, checks in res.items():
            ok = all(o for _, _, o in checks)
            passed[name] = passed[name] and ok
            if name in repeat:
                repeatable[name] = repeatable[name] and repeat[name]
            path_err[label][name] = max(e for e, _, _ in checks)
            summary.append(f"{name} max_abs_err={path_err[label][name]:.3e} (max |plain|"
                           f" {max(m for _, m, _ in checks):.3g}) {'ok' if ok else 'FAIL'}")
        print(f"check {label} S={S} T={T} B={b} D={d} H={h} fp32: " + "; ".join(summary))
    # the xproj shapes of phase 4d's studies, in both operand modes
    study_err = {}
    for i, (label, (family, S, b, d, h, t, _)) in enumerate(STUDY_SHAPES.items()):
        study_err[label] = {}
        for bf16 in (False, True):
            res, repeat = check_kernels(family, S, t, b, d, h, bf16, seed=800 + 2 * i + bf16)
            study_err[label][bf16] = {}
            summary = []
            for name, checks in res.items():
                ok = all(o for _, _, o in checks)
                passed[name] = passed[name] and ok
                if name in repeat:
                    repeatable[name] = repeatable[name] and repeat[name]
                study_err[label][bf16][name] = max(e for e, _, _ in checks)
                summary.append(f"{name} max_abs_err={study_err[label][bf16][name]:.3e} (max |plain|"
                               f" {max(m for _, m, _ in checks):.3g}) {'ok' if ok else 'FAIL'}")
            print(f"check {label} G={S} T={t} B={b} D={d} H={h} {'bf16' if bf16 else 'fp32'}: "
                  + "; ".join(summary))
    print(f"two calls bitwise equal: {repeatable}")
    if not all(passed.values()):
        fail(f"kernel disagrees with its plain version: {passed}")
    if not all(repeatable.values()):
        fail(f"redesigned kernel not bitwise repeatable: {repeatable}")

    # ---- 4. the slices
    check_env_draws()
    by_slice = {}
    for name, (family, cfg) in SLICES.items():
        by_slice[name] = run_slice(name, family, cfg, T, B)
    for name, (family, cfg) in MULTISEED_SLICES.items():
        by_slice[name] = run_multiseed_slice(name, family, cfg, T, B_seed)
    run_ff_slice("ppo_ff256x3_bf16", copy.deepcopy(PPO_FF256X3_BF16), T)
    with tempfile.TemporaryDirectory() as tmp:
        distill_launches_, teacher_path = run_distill_slices(T, tmp)
        by_slice.update(distill_launches_)

        # ---- 4b. whole-iteration dispatch against eager
        for name, make_runner in dispatch_slices(teacher_path).items():
            dispatch_runs(name, make_runner, smi)
        # ---- 4c. RND, symmetry, the 40-seed study, the optimizers
        by_slice.update(path_slices(smi))
        # ---- 4d. RND, symmetry, PBT and students in the study; evaluation; save_seed
        by_slice.update(study_slices(smi, teacher_path, tmp))
        # ---- 6. the host-env path, the remaining envs, export
        by_slice.update(host_slices(smi, teacher_path, tmp, T, B))
    launches = {k: {} for k in all_counts()}
    for slice_name, counts in by_slice.items():
        for k, n in counts.items():
            launches[k][slice_name] = n

    # ---- 5. times at the main-path shapes, fp32 and bf16 operand modes
    kernels = []
    for seed, family in ((7, "gru"), (9, "lstm")):
        S = 2
        x = make_inputs(family, S, T, B, D, H, seed=seed)
        times, rows = mode_times(family, x)
        lib_fwd, lib_bwd, lib_out = library_rnn_ms(family, S, x, 20)
        fwd, bwd, wgrad = FAMILIES[family]["kernels"]
        # with no resets the kernel computes cuDNN's function: check agreement
        hs0 = getattr(FAMILIES[family]["module"], fwd)(*x["w"][:6], torch.zeros_like(x["resets"]))
        hs0 = hs0 if family == "gru" else hs0[0]
        lib_err = float((hs0[0] - lib_out).abs().max())
        print(f"cuDNN {family.upper()} vs {fwd} without resets: max_abs_err={lib_err:.3e}")
        if not lib_err < 1e-4:
            fail(f"{fwd} disagrees with cuDNN's {family.upper()} where both compute the same function")
        library = {fwd: lib_fwd, bwd: lib_bwd, wgrad: library_wgrad_ms(rows, 20)}
        for name, (ops, nbytes) in work(family, S, T, B, D, H).items():
            kernels.append(kernel_entry(name, family, launches, max_abs, passed, times, library[name],
                                        ops, nbytes, peaks))
        print(f"time {bwd} + {wgrad} at S={S}: fp32 {times[False][bwd][0] + times[False][wgrad][0]:.4f} ms,"
              f" bf16 {times[True][bwd][0] + times[True][wgrad][0]:.4f} ms; cuDNN backward {lib_bwd:.4f} ms")
        # the same kernels at S=1, the work of the single-stream Pallas kernels
        x1 = make_inputs(family, 1, T, B, D, H, seed=seed + 1)
        times1, rows = mode_times(family, x1)
        lib1 = dict(zip((fwd, bwd), library_rnn_ms(family, 1, x1, 20)[:2]))
        lib1[wgrad] = library_wgrad_ms(rows, 20)
        for name, (ops, nbytes) in work(family, 1, T, B, D, H).items():
            print(f"time {name} at S=1: fp32 {times1[False][name][0]:.4f} ms (plain {times1[False][name][1]:.4f} ms,"
                  f" library {lib1[name]:.4f} ms, bound {fmt_ms(bound_ms(ops, nbytes, peaks, False)[0])});"
                  f" bf16 {times1[True][name][0]:.4f} ms (bound {fmt_ms(bound_ms(ops, nbytes, peaks, True)[0])})")
        print(f"time {bwd} + {wgrad} at S=1: fp32 {times1[False][bwd][0] + times1[False][wgrad][0]:.4f} ms,"
              f" bf16 {times1[True][bwd][0] + times1[True][wgrad][0]:.4f} ms; cuDNN backward {lib1[bwd]:.4f} ms")
        # the students' shape: S=1 over the 15-step segment of 4096 envs
        xs_ = make_inputs(family, 1, seg, NUM_ENVS, D, H, seed=seed + 2)
        times_s, rows = mode_times(family, xs_)
        lib_s = dict(zip((fwd, bwd), library_rnn_ms(family, 1, xs_, 20)[:2]))
        lib_s[wgrad] = library_wgrad_ms(rows, 20)
        for name, (ops, nbytes) in work(family, 1, seg, NUM_ENVS, D, H).items():
            student = {
                "S": 1, "T": seg, "B": NUM_ENVS,
                "ms": times_s[False][name][0], "plain_ms": times_s[False][name][1],
                "bound_ms": bound_ms(ops, nbytes, peaks, False)[0],
                "bf16_ms": times_s[True][name][0], "bf16_plain_ms": times_s[True][name][1],
                "bf16_bound_ms": bound_ms(ops, nbytes, peaks, True)[0],
                "library_ms": lib_s[name], "bf16_max_abs_err": student_err[name],
            }
            next(k for k in kernels if k["name"] == name)["student_shape"] = student
            print(f"time {name} at the students' shape S=1 T={seg} B={NUM_ENVS}: bf16 {student['bf16_ms']:.4f} ms"
                  f" (plain {student['bf16_plain_ms']:.4f} ms, bound {fmt_ms(student['bf16_bound_ms'])});"
                  f" fp32 {student['ms']:.4f} ms (plain {student['plain_ms']:.4f} ms, bound"
                  f" {fmt_ms(student['bound_ms'])}); library {student['library_ms']:.4f} ms")
        print(f"time {bwd} + {wgrad} at the students' shape: fp32"
              f" {times_s[False][bwd][0] + times_s[False][wgrad][0]:.4f} ms, bf16"
              f" {times_s[True][bwd][0] + times_s[True][wgrad][0]:.4f} ms; cuDNN backward {lib_s[bwd]:.4f} ms")
        for S_, x_ in ((S, x), (1, x1), (1, xs_)):
            for bf16 in (False, True):
                print(f"phases {bwd} S={S_} B={x_['xs'].shape[2]} T={x_['xs'].shape[1]}"
                      f" {'bf16' if bf16 else 'fp32'}: {phase_split(family, x_, bf16)}")
        fwd_plan = getattr(FAMILIES[family]["module"], f"{fwd}_plan")
        for S_, b_ in ((S, B), (1, B), (1, NUM_ENVS)):
            for bf16 in (False, True):
                print(f"grid {fwd} S={S_} B={b_} H={H} {'bf16' if bf16 else 'fp32'}:"
                      f" {json.dumps(fwd_plan(S_, b_, D, H, bf16))}")
    for seed, family in ((11, "gru_xp"), (13, "lstm_xp")):
        x = make_inputs(family, G, T, B_seed, D, H, seed=seed)
        times, rows = mode_times(family, x)
        fwd, bwd, wgrad = FAMILIES[family]["kernels"]
        # no single library call computes the G-stream forward or backward
        library = {fwd: None, bwd: None, wgrad: library_wgrad_ms(rows, 20)}
        for name, (ops, nbytes) in work(family, G, T, B_seed, D, H).items():
            kernels.append(kernel_entry(name, family, launches, max_abs, passed, times, library[name],
                                        ops, nbytes, peaks))
        for bf16 in (False, True):
            print(f"phases {bwd} G={G} B={B_seed} {'bf16' if bf16 else 'fp32'}: {phase_split(family, x, bf16)}")
        # the grid the cluster forward chose
        fwd_plan = getattr(FAMILIES[family]["module"], f"{fwd}_plan")
        for g, b in ((G, B_seed), (1, B)):
            for bf16 in (False, True):
                print(f"grid {fwd} G={g} B={b} H={H} {'bf16' if bf16 else 'fp32'}:"
                      f" {json.dumps(fwd_plan(g, b, H, bf16))}")
        # G=1 at the wide-input shape: the kernels alone, the port's whole
        # replay (outside projection included) and cuDNN on the raw input
        x1 = make_inputs(family, 1, T, B, WIDE_D, H, seed=seed + 1)
        times1, rows = mode_times(family, x1)
        port_fwd, port_bwd, port_out = port_replay_ms(family, x1, 20)
        lib_fwd, lib_bwd, lib_out = library_rnn_ms(family, 1, x1, 20)
        lib_err = float((port_out - lib_out).abs().max())
        print(f"cuDNN {cell_of(family).upper()} vs the port's xproj replay without resets, D={WIDE_D}:"
              f" max_abs_err={lib_err:.3e}")
        if not lib_err < 1e-4:
            fail(f"the {family} replay disagrees with cuDNN where both compute the same function")
        for name, (ops, nbytes) in work(family, 1, T, B, WIDE_D, H).items():
            print(f"time {name} at G=1 B={B}: fp32 {times1[False][name][0]:.4f} ms"
                  f" (plain {times1[False][name][1]:.4f} ms, bound {fmt_ms(bound_ms(ops, nbytes, peaks, False)[0])});"
                  f" bf16 {times1[True][name][0]:.4f} ms (bound {fmt_ms(bound_ms(ops, nbytes, peaks, True)[0])})")
        print(f"time {family} replay at G=1 B={B} D={WIDE_D} (projection + kernels): forward {port_fwd:.4f} ms,"
              f" backward {port_bwd:.4f} ms; cuDNN {cell_of(family).upper()} forward {lib_fwd:.4f} ms,"
              f" backward {lib_bwd:.4f} ms; {wgrad} library (bmm) {library_wgrad_ms(rows, 20):.4f} ms")
    for name, shapes in path_shape_times(peaks, path_err).items():
        next(k for k in kernels if k["name"] == name)["path_shapes"] = shapes
    for name, shapes in study_shape_times(peaks, study_err).items():
        next(k for k in kernels if k["name"] == name)["study_shapes"] = shapes
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
