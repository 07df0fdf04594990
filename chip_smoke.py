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
7. Data and tensor parallelism on ``torch.distributed`` (after phase 6,
   with phase 4's teacher), 2 eager iterations each, every one against the
   one-process run of the same global config (4096 envs) made first, with
   no process group. 7a: ``recurrent_gru256`` through the mesh path in an
   NCCL group of one (20 launches of each ``gru_x_*`` an iteration; the
   losses, moments and parameters at ``PARALLEL_TOL``, and whether bit for
   bit). 7b and 7c: two ranks that the script spawns on ``cuda:0``
   (``--parallel-rank``; Gloo, since NCCL refuses two ranks on one card),
   each running, with the counters zeroed just before and read just after:
   the GRU flagship on 2 x 2048 device envs (10 launches of each ``gru_x_*``
   an iteration a rank: each owns two of the four recurrent minibatches)
   and on 2 x 2048 envs of a shardable ``HostNLink``, the GRU student
   through the host bridge on ``HostDRNLink`` shards, the headline and the
   GRU flagship with ``model_parallel_size: 2`` (memories replicated: 20
   launches a rank); ``phase7 {...}`` lines give each rank's launches,
   local minibatch shares, learn and collection seconds and local
   env-steps/s, and the c10d collectives' share of one more profiled
   iteration of the data-parallel flagship. The first iteration's metrics
   and the normalizer moments at ``PARALLEL_TOL``, the parameters' difference
   after two iterations below ``UPDATE_SHARE`` of the one-process update
   (beside how far a perturbation of the initial weights by one part in 1e7
   moves them); and on the same window, the one-process run's first,
   replayed through the ranks' data-parallel, tensor-parallel and
   distillation updates (``WINDOW_UPDATES``), the parameters at
   ``PARALLEL_TOL``; bf16 runs at ``BF16_FIRST_TOL`` / ``BF16_TOL``, the
   headline's sharded forward against the unsharded one on the same
   weights; the tensor-parallel flagship's checkpoint (rank 0 writes the
   gathered state) loads into one process bit for bit. Any
   rank's failure fails the smoke. 7b also trains the headline on the two
   ranks (``dp2_ppo_ff256x3_bf16``: each rank replays its fixed half of
   every global minibatch, 12,288 rows in every minibatch of every update
   on both ranks, from the window rows the ranks gather; the losses at the
   bf16 bars), and each rank checks first that a fused or K=2 runner over
   the Gloo group on the card raises ``ValueError`` and that a fused
   host-env runner on it trains split (no graph, the split iteration's
   launches, finite metrics), as the JAX runner does. 7d (in 7a's NCCL
   group of one): the GRU flagship, the LSTM bf16 flagship, the headline
   and the GRU student through the mesh path with ``fuse_iteration`` and with ``iterations_per_dispatch: 2``,
   their NCCL collectives captured in the graph, each for 2 iterations with
   the counters zeroed just before and read just after (40 launches of
   each ``gru_x_*`` / ``lstm_x_*``; the student 4/2/2), then 2 more
   replays; state, metrics and launches bit for bit those of the plain
   fused run of the same config made first with no process group, after
   the 2 iterations and after the replays. ``phase7d {...}`` lines give
   each mode's steady env-steps/s beside the plain fused rate, the
   capture's seconds, the graph pool's bytes, the launches and the
   collectives issued an iteration.
8. The simulator adapters (after phase 6, before phase 7). The card's
   machine has neither MuJoCo nor MJX nor Brax, so the script's own doubles
   stand in: ``ChainMJX``, an MJX-shaped simulator on torch tensors (a
   damped chain of 5 point masses an env, ``nq = nv = nu = 5``, a ``Data``
   dataclass of ``qpos``, ``qvel``, ``ctrl``), and ``ChainBrax``, a
   Brax-shaped single env of the same chain (``obs = [x, v]``, terminal
   when any ``|x|`` leaves the bound, a ``metrics`` dict). First each
   adapter's reset and 24 steps of 4096 envs under a fixed action sequence
   (time-outs and terminals both) on the card against the CPU: the keys,
   the reset's draws, the dones, time-outs and episode counters bit for
   bit, the states at ``SIM_TOL``. 8a ``mjx_recurrent_gru256``: the GRU-256
   flagship on 4096 ``MJXEnv`` envs (``done_fn`` set, episode length 400)
   and 8b ``brax_recurrent_lstm256_bf16``: the LSTM-256 bf16 flagship on
   4096 ``BraxVecEnv`` envs, each eager, fused and at K=2, 2 iterations with
   the counters zeroed just before and read just after (40 launches of each
   ``gru_x_*`` / ``lstm_x_*``, none of any other), then 2 more; the graphed
   runs' state, metrics and launches bit for bit the eager run's after both;
   ``phase8 {...}`` lines give each mode's steady env-steps/s beside phase
   4b's flagship rates, the capture's seconds, the graph pool's bytes, the
   launches and the ``extras/`` metrics (8b: the double's ``max_abs_x``,
   which the writer logs as ``Episode/max_abs_x``). 8c:
   ``MultiSeedRunner`` with 2 seeds x 512 ``MJXEnv`` envs and the GRU
   flagship's policy, 2 eager iterations (``gru_xp_*`` at G=4, 40 each),
   finite. Their kernel shapes (D=10) are held in phase 3 (``SIM_SHAPES``).

Prints ``{"kernels": [...]}`` on the line before the last and, as the last
line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or when any phase fails.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.func import functional_call, vmap

from parity_torch import train_cfg as parity_cfg
from rsl_rl_tpu_torch.algorithms.distillation import chunks_between
import rsl_rl_tpu_torch.algorithms.ppo as ppo_module
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState
from rsl_rl_tpu_torch.algorithms.host_collect import PHASES
from rsl_rl_tpu_torch.env import (
    BraxVecEnv,
    CartPoleSwingUp,
    DomainRandomizedNLink,
    Hopper,
    HostVecEnv,
    MJXEnv,
    NLinkPendulum,
    PartiallyObservableNLink,
    PointMass,
    Reacher,
    SparseGoalReach,
)
from rsl_rl_tpu_torch.env.mjx_env import MJXState
from rsl_rl_tpu_torch.env.nlink import hash_draws, uniform_draws
from rsl_rl_tpu_torch.networks.memory import memory_sequence, paired_sequence
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.parallel import distributed_init, gather_tree_tp
from rsl_rl_tpu_torch.parallel.mesh import local_slice
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, slice_envs, tree_map
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


def ppo_launches(family, cfg, iterations=ITERATIONS) -> dict:
    """A PPO slice's launches: one of each of the family's kernels a minibatch."""
    alg_cfg = cfg["algorithm"]
    expected = iterations * alg_cfg["num_learning_epochs"] * alg_cfg["num_mini_batches"]
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
                  expected=None, steady=0, report=None) -> dict:
    """Train the slice eagerly, fused and at K=2 (``DISPATCH_MODES``, or the
    ``modes`` given) for ``iterations`` from the same seed, the counters
    zeroed just before and read just after, then ``steady`` more
    iterations; fail unless the graphed runs' state, metrics and launches
    equal the eager run's bit for bit (after ``iterations`` and after the
    ``steady`` more) and their metrics are finite, and, with ``expected``,
    unless the eager run launched what it says. Prints the steady
    env-steps/s of the runs (the ``steady`` iterations; without them
    iterations 1.., at K=2 2..), the captures' seconds, the graph pools'
    bytes and the eager run's ``extras/`` metrics, and puts them into the
    dict ``report`` where one is given. Returns the kernels the eager run
    launched."""
    runs = {}
    for mode in modes:
        runner = make_runner(DISPATCH_MODES[mode])
        reset_counts()
        runner.learn(iterations)
        torch.cuda.synchronize()
        counts = all_counts()
        first = run_state(runner) if steady else None
        if steady:
            runner.learn(steady)
            torch.cuda.synchronize()
        for row in runner.history:
            bad = {k: v for k, v in row["metrics"].items() if not np.isfinite(v).all()}
            if bad:
                fail(f"{name} {mode}: non-finite metrics in iteration {row['iteration']}: {bad}")
        rows = runner.history[iterations:] if steady else runner.history[2:] if mode == "k2" else runner.history[1:]
        graph = runner.iteration_graph
        runs[mode] = {
            "first": first, "state": run_state(runner), "counts": counts,
            "metrics": [{k: np.asarray(v) for k, v in row["metrics"].items()} for row in runner.history],
            "steps_per_s": float(np.mean([row["steps_per_s"] for row in rows])),
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
        differ_first = [i for i, (a, b) in enumerate(zip(eager["first"] or [], run["first"] or []))
                        if not torch.equal(a, b)]
        same_metrics = all(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
                           for a, b in zip(eager["metrics"], run["metrics"]))
        launched = {k: n for k, n in run["counts"].items() if n}
        print(f"dispatch {name} {mode}: state equal to eager bit for bit: {not differ and not differ_first}"
              f" ({len(run['state'])} tensors, differing {differ}"
              + (f", after the first {iterations} iterations {differ_first}" if steady else "")
              + f"); metrics equal: {same_metrics};"
              f" launches {launched or 'none'}, as eager: {run['counts'] == eager['counts']};"
              f" capture {run['capture_s']} s, graph pool {run['pool_bytes']} bytes; reserved after its release"
              f" {run['reserved_after']} bytes (after the eager run's {eager['reserved_after']})")
        if differ or differ_first or len(run["state"]) != len(eager["state"]) or not same_metrics:
            fail(f"{name}: the {mode} run's state or metrics differ from the eager run's")
        if run["counts"] != eager["counts"]:
            fail(f"{name}: the {mode} run launched {run['counts']}, the eager run {eager['counts']}")
    summary = {**{mode: runs[mode]["steps_per_s"] for mode in modes},
               **{f"{mode}_capture_s": runs[mode]["capture_s"] for mode in modes[1:]},
               **{f"{mode}_pool_bytes": runs[mode]["pool_bytes"] for mode in modes[1:]},
               "extras": sorted(k for k in eager["metrics"][-1] if k.startswith("extras/")), "card": smi}
    print(f"dispatch {name} steady env-steps/s: " + json.dumps(summary))
    if report is not None:
        report.update(summary)
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

    def __init__(self, num_envs: int | None = None, env_offset: int = 0, seed: int | None = None):
        num_envs = NUM_ENVS if num_envs is None else num_envs
        self.sim = self.env_cls(num_envs, NUM_LINKS, device="cpu")
        self.num_envs, self.num_actions = num_envs, self.sim.num_actions
        self.max_episode_length = int(self.sim.max_episode_length)
        self.episode_length_buf = np.zeros(num_envs, np.int32)
        self.state = None
        # phase 7: a shard holds the envs env_offset.. of a global env reset
        # from a fixed seed, so that shards compose into the global env
        self.env_offset, self.seed = env_offset, seed

    def reset(self, seed=None):
        seed = self.seed if self.seed is not None else (0 if seed is None else int(seed))
        self.state, obs = self.sim.reset(seed, num_envs=self.num_envs, env_offset=self.env_offset)
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


# ---- phase 7: data and tensor parallelism on torch.distributed
#: the parallel runs' iterations (eager), and their layout: NCCL refuses two
#: ranks on one card, so 7b and 7c run two Gloo ranks on cuda:0
PARALLEL_ITERATIONS, PARALLEL_WORLD = 2, 2
#: the bars of phase 7. On the same window (the one-process run's first,
#: replayed through the ranks' update, with SGD, whose step is linear in the
#: gradient, so Adam's normalized steps do not amplify the ranks' summation
#: order): the parameters after the update at rtol 1e-5 / atol 1e-6 and the
#: update itself within ``WINDOW_SHARE`` of its largest entry (bf16: the
#: bf16 bar's 5e-2). Along a run: the first iteration's metrics (the same
#: weights and data, summed in another order) and the normalizer moments at
#: rtol 1e-5 / atol 1e-6 (fp32). A run then leaves the one-process run at
#: the rate it amplifies rounding (the NLink obs normalizer's small early
#: std, Adam's normalized steps, the chaotic pendulum): after two iterations the
#: parameters' difference is held below a tenth of the one-process update
#: (``UPDATE_SHARE``), and printed beside how far a perturbation of the
#: initial weights by one part in 1e7 moves them. bf16 trunks (the student,
#: the headline under tensor parallelism): the first iteration's losses at
#: rtol 1e-3 / atol 1e-4 (the surrogate and the KL are near-zero means of
#: terms of the whitened advantages' scale), the rest and the sharded
#: policy's outputs against the unsharded forward on the same weights at the
#: repo's bf16 bar (rtol 5e-2 / atol 3e-2, that of the bf16 update against
#: JAX)
PARALLEL_TOL = {"rtol": 1e-5, "atol": 1e-6}
UPDATE_SHARE = 0.1
WINDOW_SHARE = {"fp32": 1e-3, "bf16": 5e-2}
BF16_FIRST_TOL = {"rtol": 1e-3, "atol": 1e-4}
BF16_TOL = {"rtol": 5e-2, "atol": 3e-2}
#: one backward through a bf16 trunk on two model ranks against the
#: unsharded one: each parameter's gradient within this share of its norm
#: (tests/test_torch_port_tensor_parallel.py's bar; rounding each rank's
#: part to bf16 before the sum leaves about 5e-3)
TP_GRAD_SHARE = 1e-3
#: the rollout fields a window carries
WINDOW_FIELDS = ("actions", "rewards", "dones", "values", "log_probs", "mu", "sigma", "privileged_actions")


def tp_cfg(cfg) -> dict:
    """``cfg`` with its MLP trunks sharded over two model ranks."""
    return {**copy.deepcopy(cfg), "model_parallel_size": PARALLEL_WORLD}


def full_state(alg) -> dict:
    """The policy's full state on the CPU (tensor-parallel slices gathered)."""
    state = alg.policy.state_dict()
    if alg.tp_specs is not None:
        state = gather_tree_tp(state, alg.mesh, alg.tp_specs)
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def parallel_result(runner) -> dict:
    """What phase 7 holds of a run: the per-iteration metrics and seconds,
    the full policy state, the policy's deterministic actions (a fresh
    carry) on the current obs, and the obs."""
    obs = runner.collect_state.obs
    with torch.no_grad():
        outputs = runner.alg.policy.act_inference(
            obs, runner.alg.policy.initial_carry(next(iter(obs.values())).shape[0]))[0]
    return {"history": [{k: row[k] for k in ("collection_s", "learn_s", "steps_per_s", "metrics")}
                        for row in runner.history],
            "state": full_state(runner.alg), "outputs": outputs.cpu(),
            "obs": {k: v.cpu() for k, v in obs.items()}}


def local_minibatch_sizes(runner) -> list[int]:
    """This rank's envs of each recurrent minibatch of an epoch."""
    mesh, nb_total = runner.mesh, runner.alg.num_mini_batches
    n_global = runner.num_global_envs
    nb, (offset, n) = n_global // nb_total, ((0, n_global) if mesh is None else local_slice(mesh, n_global))
    return [max(0, min(s + nb, offset + n) - max(s, offset)) for s in range(0, n_global, nb)]


def parallel_scenarios(teacher_path, device, num_envs, rank):
    """7b and 7c on each rank, in order: ``{name: (make_runner, expected
    launches of this rank)}``. A device env is the global one, a host env
    this rank's shard of the same global env."""
    host = num_envs // PARALLEL_WORLD
    iters, alg = PARALLEL_ITERATIONS, RECURRENT_GRU256["algorithm"]
    # a data rank replays the minibatches of its envs (half of the 4), a
    # model rank all of them (the memories are replicated)
    per_rank = {k: iters * alg["num_learning_epochs"] * alg["num_mini_batches"] // PARALLEL_WORLD
                for k in FAMILIES["gru"]["kernels"]}
    replicated = ppo_launches("gru", RECURRENT_GRU256, iters)

    def student():
        runner = DistillationRunner(HostDRNLink(host, env_offset=rank * host, seed=1),
                                    copy.deepcopy(DISTILL_GRU256_BF16), device=device)
        runner.load(teacher_path)
        return runner

    return {
        "dp2_recurrent_gru256": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                        copy.deepcopy(RECURRENT_GRU256), device=device), per_rank),
        "dp2_recurrent_gru256_host": (lambda: OnPolicyRunner(HostNLink(host, env_offset=rank * host, seed=1),
                                                             copy.deepcopy(RECURRENT_GRU256), device=device),
                                      per_rank),
        "dp2_distill_gru256_bf16_host": (student, distill_launches("gru", DISTILL_GRU256_BF16, iters)),
        "tp2_ppo_ff256x3_bf16": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                        tp_cfg(PPO_FF256X3_BF16), device=device), {}),
        # the headline on two data ranks: each replays its fixed share of
        # every global minibatch, from the window rows the ranks gather
        "dp2_ppo_ff256x3_bf16": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                        copy.deepcopy(PPO_FF256X3_BF16), device=device), {}),
        "tp2_recurrent_gru256": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                        tp_cfg(RECURRENT_GRU256), device=device), replicated),
        # the same trained with SGD (SGD_RUNS)
        "dp2_recurrent_gru256_sgd": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                            sgd(RECURRENT_GRU256), device=device), per_rank),
        "dp2_recurrent_gru256_host_sgd": (lambda: OnPolicyRunner(HostNLink(host, env_offset=rank * host, seed=1),
                                                                 sgd(RECURRENT_GRU256), device=device), per_rank),
        "tp2_ppo_ff256x3_bf16_sgd": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                            tp_cfg(sgd(PPO_FF256X3_BF16)), device=device), {}),
    }


#: the parallel runs trained with SGD and their one-process runs: SGD's step
#: is linear in the gradient, so the ranks' summation order cannot steer
#: them as it steers Adam's (PERF.md, PR 14): held at the issue's bars
SGD_RUNS = {"dp2_recurrent_gru256_sgd": "recurrent_gru256_sgd",
            "dp2_recurrent_gru256_host_sgd": "recurrent_gru256_host_sgd",
            "tp2_ppo_ff256x3_bf16_sgd": "ppo_ff256x3_bf16_sgd"}


def sgd(cfg) -> dict:
    """``cfg`` trained with SGD (the same-window updates)."""
    cfg = copy.deepcopy(cfg)
    cfg["algorithm"]["optimizer"] = "sgd"
    return cfg


def window_runner(window, teacher_path, device, num_envs, rank, model_parallel=False):
    """The runner of a same-window update, SGD: the GRU flagship or the
    headline on the global device env (on two data ranks, or two model
    ranks with ``model_parallel``), or the GRU student on this rank's host
    shard."""
    if window.startswith("distill"):
        host = num_envs // PARALLEL_WORLD if torch.distributed.is_initialized() else num_envs
        runner = DistillationRunner(HostDRNLink(host, env_offset=rank * host, seed=1), sgd(DISTILL_GRU256_BF16),
                                    device=device)
        runner.load(teacher_path)
        return runner
    cfg = sgd({"recurrent_gru256": RECURRENT_GRU256, "ppo_ff256x3_bf16": PPO_FF256X3_BF16}[window])
    return OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device), tp_cfg(cfg) if model_parallel else cfg,
                          device=device)


#: the same-window updates: (the window's one-process run, model-parallel)
WINDOW_UPDATES = {"dp2_update_on_window": ("recurrent_gru256", False),
                  "tp2_update_on_window": ("recurrent_gru256", True),
                  "tp2_headline_update_on_window": ("ppo_ff256x3_bf16", True),
                  "dp2_distill_update_on_window": ("distill_gru256_bf16_host", False)}


def save_window(name, runner, out) -> dict:
    """Collect the one-process run's first window, save it and the policy
    (as a checkpoint) as the update finds them, update; returns the full
    state before and after the update."""
    if runner.is_jax_env:
        cs, rollout, _ = runner.alg.collect(runner.env, runner.collect_state, runner.num_steps_per_env)
    else:
        cs, rollout, _ = runner.host_collect(runner.collect_state)
    runner.save(os.path.join(out, f"{name}.window.ckpt"))
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    torch.save({"fields": {f: cpu(getattr(rollout, f)) for f in WINDOW_FIELDS if getattr(rollout, f) is not None},
                "obs": {k: cpu(v) for k, v in rollout.obs.items()}, "carry0": tree_map(cpu, rollout.carry0),
                "cs_obs": {k: cpu(v) for k, v in cs.obs.items()}, "cs_carry": tree_map(cpu, cs.carry)},
               os.path.join(out, f"{name}.window.pt"))
    before = full_state(runner.alg)
    runner.alg.update(cs, rollout, **window_perm(runner, rollout, out, name))
    return before, full_state(runner.alg)


def window_perm(runner, rollout, out, name) -> dict:
    """A feedforward update's permutation of the window's rows: drawn and
    saved beside the window (``{"perm": ...}``) where the file is missing,
    read from it where present; a recurrent update or distillation draws
    none (``{}``)."""
    if not isinstance(runner.alg, PPO) or runner.alg.policy.is_recurrent:
        return {}
    path = os.path.join(out, f"{name}.window.perm.pt")
    if not os.path.exists(path):
        rows = runner.alg._row_count(rollout)[1]
        torch.save(torch.randperm(rows, generator=runner.alg.generator, device=runner.alg.device).cpu(), path)
    return {"perm": torch.load(path).to(runner.alg.device)}


def update_on_window(runner, name, out, device):
    """This rank's update of the saved window: the checkpoint loaded (sliced
    under tensor parallelism), the window cut to this data rank's envs."""
    runner.load(os.path.join(out, f"{name}.window.ckpt"))
    w = torch.load(os.path.join(out, f"{name}.window.pt"), weights_only=False)
    n_global = next(iter(w["cs_obs"].values())).shape[0]
    offset, n = (0, n_global) if runner.mesh is None else local_slice(runner.mesh, n_global)
    cut = lambda axis: lambda t: t.narrow(axis, offset, n).to(device).contiguous()  # noqa: E731
    rollout = Rollout(obs=tree_map(cut(1), w["obs"]), **tree_map(cut(1), w["fields"]),
                      carry0=tree_map(cut(0), w["carry0"]))
    cs = CollectState(env_state=(), obs=tree_map(cut(0), w["cs_obs"]), carry=tree_map(cut(0), w["cs_carry"]),
                      stats=None)
    runner.alg.update(cs, rollout, **window_perm(runner, rollout, out, name))
    return full_state(runner.alg)


def trace_lr(alg) -> list:
    """Record ``(kl, lr before, lr after)`` at every step of a PPO
    algorithm's adaptive-KL rule (distillation has none: an empty list)."""
    rows = []
    if not hasattr(alg, "_adapt_lr"):
        return rows
    adapt = alg._adapt_lr

    def traced(kl):
        before = float(alg.lr)
        adapt(kl)
        rows.append((float(kl), before, float(alg.lr)))

    alg._adapt_lr = traced
    return rows


def first_flip(got: list, want: list, desired_kl: float = 0.01) -> dict | None:
    """The first minibatch whose learning rate after the adaptive-KL rule
    differs between two traces of :func:`trace_lr`: its index, both KLs and
    rates, the one-process (``want``) KL's relative distance to the rule's
    nearest threshold (``2 * desired_kl`` or ``desired_kl / 2``) and the
    largest relative difference of the KLs before it."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g[2] != w[2]:
            threshold = min((2.0 * desired_kl, desired_kl / 2.0), key=lambda t: abs(w[0] - t))
            return {"minibatch": i, "kl": w[0], "kl_other": g[0], "lr": w[2], "lr_other": g[2],
                    "threshold": threshold, "kl_margin": abs(w[0] - threshold) / threshold,
                    "kl_rel_diff_before": max([abs(a[0] - b[0]) / max(abs(b[0]), 1e-12)
                                               for a, b in zip(got[:i], want[:i])], default=0.0)}
    return None


def time_collectives(mesh, device) -> dict:
    """Time every sum over ``mesh``'s groups, wall clock, from a drained
    card to a drained card (the card synchronized before and after each, so
    a sum's time is its copies, the exchange and the wait for the other
    rank, and none of the work queued before it): ``{"s": seconds,
    "calls": count}``, growing as the sums run. Delete the instance's
    ``data_sum_`` / ``model_sum_`` to stop."""
    spent = {"s": 0.0, "calls": 0}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(fn):
        def call(t):
            sync()
            start = time.perf_counter()
            out = fn(t)
            sync()
            spent["s"] += time.perf_counter() - start
            spent["calls"] += 1
            return out
        return call

    mesh.data_sum_, mesh.model_sum_ = timed(mesh.data_sum_), timed(mesh.model_sum_)
    return spent


def trunk_grads(alg, obs) -> dict:
    """The gradients of one backward through the actor trunk on the policy
    obs, ``sum(actor(obs) * c)`` with ``c`` drawn from seed 3, gathered
    whole under tensor parallelism, on the CPU."""
    actor, x = alg.policy.actor, obs["policy"]
    out = actor(x)
    c = torch.randn(out.shape, generator=torch.Generator(device=x.device).manual_seed(3), device=x.device)
    grads = torch.autograd.grad((out * c).sum(), list(actor.parameters()))
    grads = {f"actor.{n}": g for (n, _), g in zip(actor.named_parameters(), grads)}
    if alg.tp_specs is not None:
        grads = gather_tree_tp(grads, alg.mesh, alg.tp_specs)
    return {k: v.cpu() for k, v in grads.items()}


def record_shares() -> dict:
    """Record this rank's rows of each minibatch of each update
    (``dp_minibatches``' ``n_local``) until the returned dict's ``wrapped``
    function is put back: ``{"updates": [[rows, ...], ...]}``."""
    wrapped = ppo_module.dp_minibatches
    shares = {"updates": [], "wrapped": wrapped}

    def recorded(*args, **kwargs):
        rows = []
        shares["updates"].append(rows)
        for batch in wrapped(*args, **kwargs):
            rows.append(batch[2])
            yield batch

    ppo_module.dp_minibatches = recorded
    return shares


def check_fused_on_gloo(teacher_path, device, num_envs, rank) -> None:
    """On the card a fused runner over this Gloo group raises
    ``ValueError`` naming the backend, and a fused host-env runner on it
    trains split, as the JAX runner does: one iteration with no graph, this
    rank's launches of the split iteration (10 of each ``gru_x_*``: two of
    the four minibatches, 5 epochs) and finite metrics. Prints a ``phase7``
    line, exits non-zero otherwise. On the CPU the Gloo group captures
    nothing, so nothing is refused."""
    if device != "cuda":
        return
    cases = {"fused device env": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                         {**copy.deepcopy(PPO_FF256X3_BF16), "fuse_iteration": True},
                                                         device=device)),
             "k2 device env": (lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                      {**copy.deepcopy(RECURRENT_GRU256), "iterations_per_dispatch": 2},
                                                      device=device))}
    messages = {}
    for case, make in cases.items():
        try:
            make()
        except ValueError as e:
            messages[case] = str(e)
            if "gloo" not in str(e):
                fail(f"rank {rank}: {case} raised without naming 'gloo': {e}")
            continue
        fail(f"rank {rank}: a {case} runner over a Gloo group on the card did not raise")
    host = num_envs // PARALLEL_WORLD
    runner = OnPolicyRunner(HostNLink(host, env_offset=rank * host, seed=1),
                            {**copy.deepcopy(RECURRENT_GRU256), "fuse_iteration": True}, device=device)
    reset_counts()
    runner.learn(1)
    torch.cuda.synchronize()
    alg = RECURRENT_GRU256["algorithm"]
    split = check_launches(f"fused host env rank {rank}", all_counts(),
                           {k: alg["num_learning_epochs"] * alg["num_mini_batches"] // PARALLEL_WORLD
                            for k in FAMILIES["gru"]["kernels"]})
    finite = all(np.isfinite(v).all() for v in runner.history[0]["metrics"].values())
    if runner.fuse_iteration or runner.iteration_graph is not None or not finite:
        fail(f"rank {rank}: a fused host-env runner over a Gloo group did not train split with finite metrics"
             f" (fuse_iteration {runner.fuse_iteration}, graph {runner.iteration_graph}, finite {finite})")
    print("phase7 " + json.dumps({"rank": rank, "refused": messages,
                                  "fused host env": {"trains_split": True, "launches": split,
                                                     "finite_metrics": finite}}), flush=True)


def parallel_rank(rank, init_file, out_dir, teacher_path, device, num_envs) -> None:
    """One rank of 7b/7c (``chip_smoke.py --parallel-rank``): join the Gloo
    group, run each scenario with the counters zeroed just before and read
    just after, save its result for the launching process to hold, print one
    ``phase7`` JSON line a scenario (launches, minibatch shares, seconds);
    time the collectives of one more iteration of the data-parallel
    flagship (:func:`time_collectives`); save the gradients of one backward
    through the tensor-parallel headline's trunk and the tensor-parallel
    flagship's checkpoint (rank 0 writes the gathered state); then update
    the one-process runs' first windows (``WINDOW_UPDATES``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed_init(backend="gloo", init_method=f"file://{init_file}", rank=rank, world_size=PARALLEL_WORLD)
    check_fused_on_gloo(teacher_path, device, num_envs, rank)
    runners = {}
    scenarios = parallel_scenarios(teacher_path, device, num_envs, rank)
    for name, (make, expected) in scenarios.items():
        runner = runners[name] = make()
        trace = trace_lr(runner.alg)
        shares = record_shares() if name == "dp2_ppo_ff256x3_bf16" else None
        reset_counts()
        runner.learn(PARALLEL_ITERATIONS)
        if shares is not None:
            ppo_module.dp_minibatches = shares.pop("wrapped")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = check_launches(f"{name} rank {rank}", all_counts(), expected if device == "cuda" else {})
        result = parallel_result(runner)
        result["launches"], result["trace"] = launches, trace
        torch.save(result, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        row = {"slice": name, "rank": rank, "launches": launches,
               "learn_s": [r["learn_s"] for r in runner.history],
               "collection_s": [r["collection_s"] for r in runner.history],
               "local_env_steps_per_s": [runner.num_steps_per_env * runner.collect_state.stats.cur_reward_sum.numel()
                                         / (r["collection_s"] + r["learn_s"]) for r in runner.history]}
        if runner.alg.policy.is_recurrent and not name.startswith("dp2_distill"):
            row["local_minibatch_envs"] = local_minibatch_sizes(runner)
        if shares is not None:
            # each update's rows of every minibatch of every epoch
            result["local_minibatch_rows"] = row["local_minibatch_rows"] = shares["updates"]
            torch.save(result, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        print("phase7 " + json.dumps(row), flush=True)
    # the collectives' share of one more iteration of the data-parallel flagship
    runner = runners["dp2_recurrent_gru256"]
    spent = time_collectives(runner.mesh, device)
    start = time.perf_counter()
    runner.learn(1)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    del runner.mesh.data_sum_, runner.mesh.model_sum_
    print("phase7 " + json.dumps({"slice": "dp2_recurrent_gru256", "rank": rank, "timed_iteration_s": wall,
                                  "collective_wall_s": spent["s"], "collective_calls": spent["calls"],
                                  "collective_share": spent["s"] / wall}), flush=True)
    # one backward through the tensor-parallel headline's bf16 actor trunk
    headline = runners["tp2_ppo_ff256x3_bf16"]
    torch.save(trunk_grads(headline.alg, headline.collect_state.obs), os.path.join(out_dir, f"tp2_grads.rank{rank}.pt"))
    runners["tp2_recurrent_gru256"].save(os.path.join(out_dir, "tp2.pt"))
    for name, (window, model_parallel) in WINDOW_UPDATES.items():
        runner = window_runner(window, teacher_path, device, num_envs, rank, model_parallel)
        torch.save(update_on_window(runner, window, out_dir, device), os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def hold(name, got, want, tol, what) -> float:
    """Fail unless ``got`` is within ``tol`` of ``want``; returns the largest
    absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.allclose(got, want, **tol):
        fail(f"{name}: {what} beyond rtol {tol['rtol']:g} / atol {tol['atol']:g}: max |got - want|"
             f" {np.max(np.abs(got - want)):.3e}")
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def hold_run(name, got, want, first_tol, norm_tol, global_episodes=True, exact_tol=None) -> None:
    """Hold a parallel run against the one-process run: the first
    iteration's metrics at ``first_tol``, the normalizer moments at
    ``norm_tol``, the parameters' difference below ``UPDATE_SHARE`` of the
    one-process update; print the later metrics' largest relative
    difference, the parameters' largest difference and whether they are
    within ``PARALLEL_TOL`` too. With ``exact_tol`` (an SGD run) every
    iteration's metrics are held at ``first_tol`` and the parameters at
    ``exact_tol``."""
    later = 0.0
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        for k, v in w["metrics"].items():
            if not (k.startswith("Loss/") or (global_episodes and not k.startswith("extras/"))):
                continue
            if i == 0 or exact_tol is not None:
                hold(name, g["metrics"][k], v, first_tol, f"iteration {i} {k}")
            else:
                later = max(later, abs(g["metrics"][k] - v) / max(abs(v), 1e-12))
    norm_err = param_err = 0.0
    within = True
    diff_sq = update_sq = 0.0
    for k, w in want["state"].items():
        g = got["state"][k].float()
        if k.startswith("norm_"):
            norm_err = max(norm_err, hold(name, g, w, norm_tol, f"normalizer {k}"))
            continue
        param_err = max(param_err, float((g - w.float()).abs().max()))
        within &= bool(np.allclose(g.numpy(), w.float().numpy(), **PARALLEL_TOL))
        if exact_tol is not None:
            hold(name, g, w.float(), exact_tol, f"parameter {k}")
        diff_sq += float(torch.sum((g - w.float()) ** 2))
        update_sq += float(torch.sum((w.float() - want["state0"][k].float()) ** 2))
    share = math.sqrt(diff_sq / update_sq)
    print(f"{name}: {'every iteration' if exact_tol else 'iteration 0'} within rtol {first_tol['rtol']:g} / atol {first_tol['atol']:g}; later metrics'"
          f" largest relative difference {later:.3e}; normalizer moments {norm_err:.3e}; parameters max |diff|"
          f" {param_err:.3e} (within rtol {PARALLEL_TOL['rtol']:g} / atol {PARALLEL_TOL['atol']:g}: {within}),"
          f" |diff| / |one-process update| {share:.3e}; the learning rate's first flip:"
          f" {json.dumps(first_flip(got['trace'], want['trace']))}")
    if exact_tol is None and share > UPDATE_SHARE:
        fail(f"{name}: the parameters left the one-process run by {share:.3e} of its update (> {UPDATE_SHARE})")


#: phase 7d: graphed iterations on the mesh path in the NCCL group of one,
#: each mode held bit for bit against the plain fused run (no process
#: group) over ``GRAPHED_ITERATIONS``, then ``GRAPHED_STEADY`` more replays
#: of each timed
GRAPHED_ITERATIONS, GRAPHED_STEADY = 2, 4
GRAPHED_MODES = {"fused": {"fuse_iteration": True}, "k2": {"iterations_per_dispatch": 2}}


def graphed_slices(teacher_path, device, num_envs) -> dict:
    """7d's slices: ``{name: (make_runner(runner keys), expected launches
    over GRAPHED_ITERATIONS)}``."""
    iters = GRAPHED_ITERATIONS

    def ppo(cfg):
        return lambda keys: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                           {**copy.deepcopy(cfg), **keys}, device=device)

    def student(keys):
        runner = DistillationRunner(DomainRandomizedNLink(num_envs, NUM_LINKS, device=device),
                                    {**copy.deepcopy(DISTILL_GRU256_BF16), **keys}, device=device)
        runner.load(teacher_path)
        return runner

    return {"recurrent_gru256": (ppo(RECURRENT_GRU256), ppo_launches("gru", RECURRENT_GRU256, iters)),
            "recurrent_lstm256_bf16": (ppo(RECURRENT_LSTM256_BF16),
                                       ppo_launches("lstm", RECURRENT_LSTM256_BF16, iters)),
            "ppo_ff256x3_bf16": (ppo(PPO_FF256X3_BF16), {}),
            "distill_gru256_bf16": (student, distill_launches("gru", DISTILL_GRU256_BF16, iters))}


def count_collectives(mesh) -> dict:
    """Count the calls of ``mesh``'s collectives (the data group's sums and
    gathers, the model group's sums) as they are issued from Python: in a
    graphed run the warm-up's and the capture's, none of the replays'.
    Delete the instance's attributes to stop."""
    calls = {"n": 0}

    def counted(fn):
        def call(*args, **kwargs):
            calls["n"] += 1
            return fn(*args, **kwargs)
        return call

    mesh.data_sum_, mesh.data_gather, mesh.model_sum_ = (counted(mesh.data_sum_), counted(mesh.data_gather),
                                                         counted(mesh.model_sum_))
    return calls


def graphed_run(name, make, keys, expected, device) -> dict:
    """One graphed run of 7d: ``GRAPHED_ITERATIONS`` with the counters zeroed
    just before and read just after (the launches checked against
    ``expected`` on the card), the state and metrics then, and after
    ``GRAPHED_STEADY`` more replays; their env-steps/s, the capture's
    seconds, the graph pool's bytes and, on a mesh, the collectives the
    capture holds an iteration."""
    runner = make(keys)
    calls = None if runner.mesh is None else count_collectives(runner.mesh)
    reset_counts()
    runner.learn(GRAPHED_ITERATIONS)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = check_launches(name, all_counts(), expected if device == "cuda" else {})
    graph = runner.iteration_graph
    if graph is None or (device == "cuda" and graph.capture_s is None):
        fail(f"{name}: the run captured no graph")
    first = {"state": run_state(runner), "metrics": [row["metrics"] for row in runner.history]}
    # the collectives issued in the first two iterations (on the card the
    # warm-up's and the capture's)
    issued = None if calls is None else calls["n"] / GRAPHED_ITERATIONS
    runner.learn(GRAPHED_STEADY)
    if device == "cuda":
        torch.cuda.synchronize()
    out = {"first": first, "state": run_state(runner), "metrics": [row["metrics"] for row in runner.history],
           "launches": launches, "capture_s": graph.capture_s, "pool_bytes": graph.pool_bytes,
           "steps_per_s": float(np.mean([row["steps_per_s"] for row in runner.history[GRAPHED_ITERATIONS:]])),
           "distributed": runner.mesh is not None and runner.mesh.distributed}
    if calls is not None:
        out["collectives_an_iteration"] = issued
        del runner.mesh.data_sum_, runner.mesh.data_gather, runner.mesh.model_sum_
    graph.release()
    del runner, graph
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def same_run(a, b) -> bool:
    """Two runs' states and metrics equal bit for bit."""
    same_state = len(a["state"]) == len(b["state"]) and all(torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
    same_metrics = all(x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
                       for x, y in zip(a["metrics"], b["metrics"]))
    return same_state and same_metrics and len(a["metrics"]) == len(b["metrics"])


#: the sums timed inside a graph in 7d: elements of each, sums a graph
GRAPHED_SUM_SIZES, GRAPHED_SUMS = (1, 1 << 20), 100


def time_graphed_sums(smi, reps=20) -> None:
    """Capture ``GRAPHED_SUMS`` all-reduces over the initialized group (the
    NCCL group of one) of a tensor of each of ``GRAPHED_SUM_SIZES`` fp32
    elements (a scalar statistic; a million, above the GRU flagship's
    683,019 gradient elements a minibatch) in one CUDA graph, replay it ``reps`` times
    between CUDA events and print the time a sum (``phase7d`` line)."""
    times = {}
    for n in GRAPHED_SUM_SIZES:
        t = torch.ones(n, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.distributed.all_reduce(t)  # the warm-up, outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPHED_SUMS):
                torch.distributed.all_reduce(t)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times[n] = 1e3 * start.elapsed_time(end) / (reps * GRAPHED_SUMS)
        graph.reset()
    print("phase7d " + json.dumps({"graphed_sum_us_by_elements": times, "sums_a_graph": GRAPHED_SUMS, "card": smi}),
          flush=True)


def check_graphed_mesh(plain, teacher_path, smi, device, num_envs) -> dict:
    """7d in the initialized process group of one: each slice through the
    mesh path fused and at K=2, bit for bit its plain fused run (``plain``)
    after ``GRAPHED_ITERATIONS`` and after the steady replays; prints a
    ``phase7d {...}`` line a slice. Returns ``{slice: {kernel: launches}}``."""
    launches = {}
    for name, (make, expected) in graphed_slices(teacher_path, device, num_envs).items():
        row = {"slice": name, "plain_fused_env_steps_per_s": plain[name]["steps_per_s"],
               "plain_capture_s": plain[name]["capture_s"], "plain_pool_bytes": plain[name]["pool_bytes"]}
        for mode, keys in GRAPHED_MODES.items():
            label = f"nccl1_{name}_{mode}"
            run = graphed_run(label, make, keys, expected, device)
            if not run["distributed"]:
                fail(f"{label}: the runner did not take the process group")
            for stage in ("first", None):
                got, want = (run[stage], plain[name][stage]) if stage else (run, plain[name])
                if not same_run(got, want):
                    fail(f"{label}: state or metrics differ from the plain fused run"
                         f" {'after ' + str(GRAPHED_ITERATIONS) + ' iterations' if stage else 'after the replays'}")
            if run["launches"] != plain[name]["launches"]:
                fail(f"{label}: launched {run['launches']}, the plain fused run {plain[name]['launches']}")
            steps = num_envs * RECURRENT_GRU256["num_steps_per_env"]
            row[mode] = {"env_steps_per_s": run["steps_per_s"], "capture_s": run["capture_s"],
                         "pool_bytes": run["pool_bytes"], "launches": run["launches"],
                         "collectives_an_iteration": run["collectives_an_iteration"],
                         "iteration_s_over_plain": steps / run["steps_per_s"] - steps / plain[name]["steps_per_s"]}
            launches[label] = run["launches"]
        row["bit_for_bit"] = True
        row["card"] = smi
        print("phase7d " + json.dumps(row), flush=True)
    if device == "cuda":
        time_graphed_sums(smi)
    return launches


def parallel_slices(smi, teacher_path, tmp, device="cuda", num_envs=NUM_ENVS) -> dict:
    """Phase 7; returns ``{slice: {kernel: launches}}``."""
    iters = PARALLEL_ITERATIONS
    out = os.path.join(tmp, "parallel")
    os.makedirs(out)

    def student():
        runner = DistillationRunner(HostDRNLink(num_envs, seed=1), copy.deepcopy(DISTILL_GRU256_BF16), device=device)
        runner.load(teacher_path)
        return runner

    # the one-process runs of the same global configurations (no process
    # group), their initial state, and the first windows of two
    makers = {
        "recurrent_gru256": lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                   copy.deepcopy(RECURRENT_GRU256), device=device),
        "recurrent_gru256_host": lambda: OnPolicyRunner(HostNLink(num_envs, seed=1),
                                                        copy.deepcopy(RECURRENT_GRU256), device=device),
        "ppo_ff256x3_bf16": lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                   copy.deepcopy(PPO_FF256X3_BF16), device=device),
        "distill_gru256_bf16_host": student,
        "recurrent_gru256_sgd": lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                       sgd(RECURRENT_GRU256), device=device),
        "recurrent_gru256_host_sgd": lambda: OnPolicyRunner(HostNLink(num_envs, seed=1), sgd(RECURRENT_GRU256),
                                                            device=device),
        "ppo_ff256x3_bf16_sgd": lambda: OnPolicyRunner(NLinkPendulum(num_envs, NUM_LINKS, device=device),
                                                       sgd(PPO_FF256X3_BF16), device=device),
    }
    refs = {}
    for name, make in makers.items():
        runner = make()
        state0, trace = full_state(runner.alg), trace_lr(runner.alg)
        runner.learn(iters)
        refs[name] = {**parallel_result(runner), "state0": state0, "trace": trace}
    windows = {w: save_window(w, window_runner(w, teacher_path, device, num_envs, 0), out)
               for w in sorted({w for w, _ in WINDOW_UPDATES.values()})}
    # the sensitivity of the flagship and the headline: their initial
    # weights perturbed by one part in 1e7
    moved = {}
    for name in ("recurrent_gru256", "ppo_ff256x3_bf16"):
        runner = makers[name]()
        gen = torch.Generator(device=device).manual_seed(7)
        with torch.no_grad():
            for p in runner.alg.policy.parameters():
                p.mul_(1.0 + 1e-7 * torch.randn(p.shape, generator=gen, device=device))
        runner.learn(iters)
        moved[name] = parallel_result(runner)
        params = max(float((moved[name]["state"][k] - v).abs().max()) for k, v in refs[name]["state"].items())
        outputs = float((moved[name]["outputs"] - refs[name]["outputs"]).abs().max())
        print(f"{name}: initial weights perturbed by one part in 1e7 move the parameters by max {params:.3e}"
              f" and the policy outputs by max {outputs:.3e} after {iters} iterations")

    # 7d's references: each slice's plain fused run, no process group
    graphed_plain = {name: graphed_run(f"{name}_plain_fused", make, {"fuse_iteration": True}, expected, device)
                     for name, (make, expected) in graphed_slices(teacher_path, device, num_envs).items()}

    # 7a: the data-parallel code in a process group of one (NCCL on the card)
    distributed_init(backend="nccl" if device == "cuda" else "gloo", init_method=f"file://{tmp}/group_of_one",
                     rank=0, world_size=1, device_id=torch.device(device, 0) if device == "cuda" else None)
    runner = makers["recurrent_gru256"]()
    if runner.mesh is None or not runner.mesh.distributed:
        fail("7a: the runner did not take the process group")
    reset_counts()
    runner.learn(iters)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {"nccl1_recurrent_gru256": check_launches(
        "nccl1_recurrent_gru256", all_counts(), ppo_launches("gru", RECURRENT_GRU256, iters) if device == "cuda" else {})}
    print_history("nccl1_recurrent_gru256", runner)
    got, want = parallel_result(runner), refs["recurrent_gru256"]
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        for k, v in w["metrics"].items():
            hold("nccl1_recurrent_gru256", g["metrics"][k], v, PARALLEL_TOL, f"iteration {i} {k}")
    for k, v in want["state"].items():
        hold("nccl1_recurrent_gru256", got["state"][k], v, PARALLEL_TOL, k)
    same = all(torch.equal(got["state"][k], v) for k, v in want["state"].items())
    print(f"nccl1_recurrent_gru256: metrics, parameters and moments within rtol 1e-5 / atol 1e-6 of the plain"
          f" runner's; bit for bit: {same}")
    del runner
    # 7d: graphed iterations on the mesh path, the collectives in the graph
    launches.update(check_graphed_mesh(graphed_plain, teacher_path, smi, device, num_envs))
    torch.distributed.destroy_process_group()

    # 7b, 7c: two Gloo ranks on the one card, each its own process
    cmd = [sys.executable, os.path.abspath(__file__), "--parallel-rank", "{rank}", "--init", f"{tmp}/two_ranks",
           "--out", out, "--teacher", teacher_path, "--device", device, "--num-envs", str(num_envs)]
    procs = [subprocess.Popen([c.format(rank=r) for c in cmd], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(PARALLEL_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        for line in o.splitlines():
            if line.startswith("phase7 ") or "launches:" in line:
                print(line)
        if p.returncode != 0:
            fail(f"phase 7 rank {r} exited {p.returncode}:\n{o[-6000:]}")
    load = lambda name, r: torch.load(os.path.join(out, f"{name}.rank{r}.pt"), weights_only=False)  # noqa: E731
    # the ranks' update of the one-process runs' first windows
    for name, (window, _) in WINDOW_UPDATES.items():
        bf16 = "bf16" in window
        tol, before, after = BF16_TOL if bf16 else PARALLEL_TOL, *windows[window]
        for r in range(PARALLEL_WORLD):
            got = load(name, r)
            err = max(hold(name, got[k], v, tol, f"rank {r} {k}") for k, v in after.items())
            # the update itself, against its largest entry
            diff = max(float(((got[k] - before[k]) - (v - before[k])).float().abs().max()) for k, v in after.items())
            scale = max(float((v - before[k]).float().abs().max()) for k, v in after.items())
            print(f"{name} rank {r}: the one-process run's first window updated on the ranks (SGD): parameters max"
                  f" |diff| {err:.3e} (rtol {tol['rtol']:g} / atol {tol['atol']:g}); the update's max |diff|"
                  f" {diff:.3e} of its max |entry| {scale:.3e}")
            if diff > WINDOW_SHARE["bf16" if bf16 else "fp32"] * scale:
                fail(f"{name} rank {r}: the ranks' update of the window leaves the one process's by {diff:.3e} of"
                     f" {scale:.3e}")
    ranks = {name: [load(name, r) for r in range(PARALLEL_WORLD)]
             for name in parallel_scenarios(teacher_path, device, num_envs, 0)}
    for name, want in (("dp2_recurrent_gru256", "recurrent_gru256"),
                       ("dp2_recurrent_gru256_host", "recurrent_gru256_host"),
                       ("dp2_distill_gru256_bf16_host", "distill_gru256_bf16_host"),
                       ("tp2_recurrent_gru256", "recurrent_gru256")):
        host = name.endswith("_host")
        # a bf16 student's actions move its env, and so its obs moments
        tols = (BF16_FIRST_TOL, BF16_TOL) if "bf16" in name else (PARALLEL_TOL, PARALLEL_TOL)
        for r in range(PARALLEL_WORLD):
            # through the bridge the episode statistics stay each rank's
            hold_run(f"{name} rank {r}", ranks[name][r], refs[want], *tols, global_episodes=not host)
        if host:
            for i, w in enumerate(refs[want]["history"]):
                for k in ("ep_count", "ep_length_sum"):
                    hold(name, sum(ranks[name][r]["history"][i]["metrics"][k] for r in range(PARALLEL_WORLD)),
                         w["metrics"][k], PARALLEL_TOL, f"iteration {i}: the ranks' {k}")
    # the headline on two data ranks: every update's share of every
    # minibatch the same, on both ranks (the layout's, not the draw's);
    # the losses at the bf16 bars
    name = "dp2_ppo_ff256x3_bf16"
    alg = PPO_FF256X3_BF16["algorithm"]
    mb = num_envs * PPO_FF256X3_BF16["num_steps_per_env"] // alg["num_mini_batches"]
    want_rows = [-(-mb // PARALLEL_WORLD)] * (alg["num_mini_batches"] * alg["num_learning_epochs"])
    for r in range(PARALLEL_WORLD):
        rows = ranks[name][r]["local_minibatch_rows"]
        if len(rows) != iters or any(u != want_rows for u in rows):
            fail(f"{name} rank {r}: minibatch shares {rows}, expected {want_rows} in each of {iters} updates")
        for i, (g, w) in enumerate(zip(ranks[name][r]["history"], refs["ppo_ff256x3_bf16"]["history"])):
            for k, v in w["metrics"].items():
                if k.startswith("Loss/"):
                    err = hold(name, g["metrics"][k], v, BF16_FIRST_TOL if i == 0 else BF16_TOL,
                               f"rank {r} iteration {i} {k}")
                    print(f"{name} rank {r} iteration {i} {k}: max |diff| {err:.3e}")
    print(f"{name}: minibatch shares {want_rows[0]} rows a rank in every minibatch of both updates")
    name = "tp2_ppo_ff256x3_bf16"
    for r in range(PARALLEL_WORLD):
        want = refs["ppo_ff256x3_bf16"]
        for i, (g, w) in enumerate(zip(ranks[name][r]["history"], want["history"])):
            for k, v in w["metrics"].items():
                if k.startswith("Loss/"):
                    err = hold(name, g["metrics"][k], v, BF16_FIRST_TOL if i == 0 else BF16_TOL,
                               f"rank {r} iteration {i} {k}")
                    print(f"{name} rank {r} iteration {i} {k}: max |diff| {err:.3e}")
        # the trained policies' outputs, beside how far the replicated run's
        # own outputs move from weights perturbed by one part in 1e7 (held
        # in the SGD run below)
        err = float((ranks[name][r]["outputs"] - want["outputs"]).abs().max())
        base = float((moved["ppo_ff256x3_bf16"]["outputs"] - want["outputs"]).abs().max())
        print(f"{name} rank {r}: outputs after {iters} iterations against the replicated run's: max |diff| {err:.3e}"
              f" (the replicated run perturbed by 1e-7: {base:.3e}); the learning rate's first flip:"
              f" {json.dumps(first_flip(ranks[name][r]['trace'], want['trace']))}")
    # the sharded forward against the unsharded one on the same weights: the
    # row-parallel products summed in fp32 and rounded once
    one = makers["ppo_ff256x3_bf16"]()
    got = ranks[name][0]
    one.alg.policy.load_state_dict(got["state"])
    with torch.no_grad():
        plain = one.alg.policy.act_inference({k: v.to(device) for k, v in got["obs"].items()})[0].cpu()
    err = hold(name, got["outputs"], plain, BF16_TOL, "outputs against the unsharded forward on its weights")
    print(f"{name}: the sharded forward against the unsharded one on the same weights: max |diff| {err:.3e}")
    # and one backward through its actor trunk: the partial sums that cross
    # ranks are fp32 and rounded to bf16 once, as the unsharded layer rounds
    # its fp32 accumulation once (cuBLAS's reduced-precision split-K
    # reductions off for the reference)
    matmul = torch.backends.cuda.matmul
    reduced, matmul.allow_bf16_reduced_precision_reduction = matmul.allow_bf16_reduced_precision_reduction, False
    try:
        want = trunk_grads(one.alg, {k: v.to(device) for k, v in got["obs"].items()})
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    for r in range(PARALLEL_WORLD):
        grads = torch.load(os.path.join(out, f"tp2_grads.rank{r}.pt"), weights_only=False)
        shares = {k: float((grads[k] - w).norm() / w.norm()) for k, w in want.items()}
        print(f"{name} rank {r}: one backward through the actor trunk against the unsharded one on the same"
              f" weights and obs, |grad diff| / |grad| a parameter: {json.dumps(shares)}")
        if max(shares.values()) > TP_GRAD_SHARE:
            fail(f"{name} rank {r}: the sharded trunk's gradients leave the unsharded ones by"
                 f" {max(shares.values()):.3e} of their norm (> {TP_GRAD_SHARE})")
    # the runs trained with SGD: every iteration's metrics, the moments and
    # the parameters at the issue's bars, the headline's outputs too
    for name, want in SGD_RUNS.items():
        bf16 = "bf16" in name
        tols = (BF16_FIRST_TOL, BF16_TOL, BF16_TOL) if bf16 else (PARALLEL_TOL, PARALLEL_TOL, PARALLEL_TOL)
        for r in range(PARALLEL_WORLD):
            hold_run(f"{name} rank {r}", ranks[name][r], refs[want], tols[0], tols[1],
                     global_episodes=not name.endswith("_host_sgd"), exact_tol=tols[2])
            if bf16:
                err = hold(name, ranks[name][r]["outputs"], refs[want]["outputs"], BF16_TOL,
                           f"rank {r} outputs after {iters} iterations against the replicated run's")
                print(f"{name} rank {r}: outputs after {iters} iterations against the replicated run's: max |diff|"
                      f" {err:.3e} (rtol {BF16_TOL['rtol']:g} / atol {BF16_TOL['atol']:g})")
    # a checkpoint saved under tensor parallelism loads into one process
    one = makers["recurrent_gru256"]()
    one.load(os.path.join(out, "tp2.pt"))
    saved = ranks["tp2_recurrent_gru256"][0]["state"]
    if not all(torch.equal(v.cpu(), saved[k]) for k, v in one.alg.policy.state_dict().items()):
        fail("the checkpoint saved under tensor parallelism does not load into one process as trained")
    print("tp2_recurrent_gru256: its checkpoint (gathered by rank 0) loads into one process bit for bit")
    for name, results in ranks.items():
        for r, res in enumerate(results):
            if res["launches"]:
                launches[f"{name}_rank{r}"] = res["launches"]
    print(f"phase 7 on {smi}: passed")
    return launches


# ---- phase 8: the simulator adapters (MJXEnv, BraxVecEnv) on the card
#: the chain doubles: masses a chain, the spring between neighbours (the
#: ends tied to fixed walls), the damping, the time step, the control bound,
#: the terminal |x| and the reset draws' scale
CHAIN_SIZE, CHAIN_SPRING, CHAIN_DAMPING, CHAIN_DT = 5, 2.0, 0.2, 0.05
CHAIN_CTRL, CHAIN_BOUND, CHAIN_NOISE = 5.0, 1.0, 0.1
#: 8a and 8b: iterations with the counters zeroed, then steady ones timed;
#: the episode length of the slices and of the card-against-CPU check
SIM_ITERATIONS, SIM_STEADY = 2, 2
SIM_EPISODE, SIM_CHECK_EPISODE, SIM_CHECK_STEPS = 400, 16, 24
#: 8c: seeds x envs a seed
SIM_SEEDS, SIM_ENVS_PER_SEED = 2, 512
#: the kernel shapes of phase 8's slices, held in phase 3: (family, streams,
#: B, bf16) at T=24, H=256 and D=10 (the chain's [x, v])
SIM_SHAPES = {"mjx_recurrent_gru256": ("gru", 2, 1024, False),
              "brax_recurrent_lstm256_bf16": ("lstm", 2, 1024, True),
              "multiseed2_mjx_recurrent_gru256": ("gru_xp", 2 * SIM_SEEDS, SIM_ENVS_PER_SEED // 4, False)}
#: the card's states against the CPU's after SIM_CHECK_STEPS steps of the
#: same actions: the chain's ops are elementwise (one IEEE rounding each on
#: both devices), the reward's sum over the chain may add in another order
SIM_TOL = {"rtol": 1e-5, "atol": 1e-6}


@dataclasses.dataclass
class ChainData:
    """One env's state of the MJX-shaped chain double."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor


def chain_accel(x, v, u):
    """A damped chain of point masses tied by springs to its neighbours and,
    at its ends, to fixed walls, under the clipped controls ``u``: one env."""
    left = torch.nn.functional.pad(x[:-1], (1, 0))
    right = torch.nn.functional.pad(x[1:], (0, 1))
    spring = CHAIN_SPRING * (left + right - 2.0 * x)
    return torch.clamp(u, -CHAIN_CTRL, CHAIN_CTRL) + spring - CHAIN_DAMPING * v


class ChainMJX:
    """Smoke-test scaffolding, not a package feature: an MJX-shaped
    simulator on torch tensors (``put_model``, ``make_data``, ``forward``,
    ``step`` of one env, which ``MJXEnv`` maps over the envs), the chain of
    ``CHAIN_SIZE`` masses, one degree of freedom and one motor each. The
    card's machine has no MuJoCo, MJX or JAX."""

    @staticmethod
    def put_model(m, device=None):
        return types.SimpleNamespace(nq=m.nq, nv=m.nv, nu=m.nu, opt=m.opt, device=device)

    @staticmethod
    def make_data(model) -> ChainData:
        zeros = torch.zeros(model.nq, device=model.device)
        return ChainData(qpos=zeros, qvel=zeros.clone(), ctrl=zeros.clone())

    @staticmethod
    def forward(model, data: ChainData) -> ChainData:
        return data

    @staticmethod
    def step(model, data: ChainData) -> ChainData:
        qvel = data.qvel + model.opt.timestep * chain_accel(data.qpos, data.qvel, data.ctrl)
        return dataclasses.replace(data, qpos=data.qpos + model.opt.timestep * qvel, qvel=qvel)


def chain_model():
    """The host model's fields as ``MJXEnv`` reads them."""
    return types.SimpleNamespace(nq=CHAIN_SIZE, nv=CHAIN_SIZE, nu=CHAIN_SIZE,
                                 opt=types.SimpleNamespace(timestep=CHAIN_DT))


def chain_reward(x, v, u):
    return -(torch.sum(x * x) + 0.1 * torch.sum(v * v) + 0.01 * torch.sum(u * u))


def make_mjx_chain(num_envs, device, episode_length=SIM_EPISODE) -> MJXEnv:
    """``MJXEnv`` over :class:`ChainMJX`: obs ``[x, v]``, terminal when any
    ``|x|`` leaves ``CHAIN_BOUND``."""
    return MJXEnv(chain_model(), num_envs, episode_length,
                  obs_fn=lambda mx, d: {"policy": torch.cat([d.qpos, d.qvel])},
                  reward_fn=lambda mx, d, a: chain_reward(d.qpos, d.qvel, a),
                  done_fn=lambda mx, d: (torch.abs(d.qpos) > CHAIN_BOUND).any(),
                  reset_noise_scale=CHAIN_NOISE, sim=ChainMJX, device=device)


@dataclasses.dataclass
class ChainBraxState:
    pipeline: dict
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: dict


class ChainBrax:
    """Smoke-test scaffolding, not a package feature: a Brax-shaped single
    env on torch tensors of the same chain, ``obs = [x, v]``, terminal (a
    float ``done``, as Brax's) when any ``|x|`` leaves ``CHAIN_BOUND``,
    ``metrics`` the largest ``|x|``; a reset draws ``x`` in ``[-CHAIN_NOISE,
    CHAIN_NOISE)`` from its key."""

    action_size, dt = CHAIN_SIZE, CHAIN_DT

    @staticmethod
    def _state(x, v, reward, done):
        return ChainBraxState(pipeline={"x": x, "v": v}, obs=torch.cat([x, v]), reward=reward, done=done,
                              metrics={"max_abs_x": torch.abs(x).max()})

    def reset(self, key):
        _, bits = hash_draws(key.reshape(1), CHAIN_SIZE)
        x = uniform_draws(bits[0], -CHAIN_NOISE, 2 * CHAIN_NOISE)
        zero = torch.zeros_like(x)
        return self._state(x, zero, zero.sum(), zero.sum())

    def step(self, state, action):
        x, v = state.pipeline["x"], state.pipeline["v"]
        v = v + CHAIN_DT * chain_accel(x, v, action)
        x = x + CHAIN_DT * v
        done = (torch.abs(x) > CHAIN_BOUND).any().to(torch.float32)
        return self._state(x, v, chain_reward(x, v, action), done)


def make_brax_chain(num_envs, device, episode_length=SIM_EPISODE) -> BraxVecEnv:
    return BraxVecEnv(ChainBrax(), num_envs, episode_length, device=device)


SIM_ENVS = {"MJXEnv": make_mjx_chain, "BraxVecEnv": make_brax_chain}


def sim_trace(make_env, device) -> list:
    """The adapter's reset and SIM_CHECK_STEPS steps of NUM_ENVS envs under
    a fixed action sequence (episodes end by time-out and by terminal): each
    step's keys, episode counters and dones, and the sim
    state (the reset's: the draws), on the CPU."""
    env = make_env(NUM_ENVS, device, SIM_CHECK_EPISODE)
    state, _ = env.reset(3)
    rng = np.random.default_rng(5)  # a steady push an env (some chains leave the bound), and noise
    shape = (SIM_CHECK_STEPS, NUM_ENVS, env.num_actions)
    actions = torch.from_numpy((rng.uniform(-6.0, 6.0, shape[1:]) + rng.normal(0.0, 0.5, shape)).astype(np.float32))
    rows = []
    for a in [None, *actions]:
        if a is not None:
            state, _, _, done, extras = env.step(state, a.to(device))
        leaves = flatten(state.data if isinstance(state, MJXState) else state.brax)[0]
        rows.append({"rng": state.rng.cpu(), "episode_length": state.episode_length.cpu(),
                     "done": None if a is None else done.cpu(),
                     "time_outs": None if a is None else extras["time_outs"].cpu(),
                     "sim": [t.cpu() for t in leaves]})
    return rows


def check_sim_draws(device="cuda") -> None:
    """Each adapter's reset draws and steps on the card against the CPU's:
    the keys, the reset's draws, the dones and time-outs and the episode
    counters bit for bit, the sim state after each step at SIM_TOL."""
    for name, make_env in SIM_ENVS.items():
        cpu, card = sim_trace(make_env, "cpu"), sim_trace(make_env, device)
        exact = all(torch.equal(a[k], b[k]) for a, b in zip(cpu, card) for k in ("rng", "episode_length")
                    if a[k] is not None)
        exact &= all(torch.equal(a[k], b[k]) for a, b in zip(cpu[1:], card[1:]) for k in ("done", "time_outs"))
        draws = all(torch.equal(a, b) for a, b in zip(cpu[0]["sim"], card[0]["sim"]))
        worst = max(float((a - b).abs().max()) for x, y in zip(cpu, card) for a, b in zip(x["sim"], y["sim"]))
        close = all(torch.allclose(a, b, **SIM_TOL) for x, y in zip(cpu, card) for a, b in zip(x["sim"], y["sim"]))
        dones = torch.stack([r["done"] for r in cpu[1:]])
        time_outs = torch.stack([r["time_outs"] for r in cpu[1:]])
        print(f"{name} on the card against the CPU over a reset and {SIM_CHECK_STEPS} steps of {NUM_ENVS} envs:"
              f" keys, episode counters, dones and time-outs bit for bit: {exact}; the reset's draws bit for bit:"
              f" {draws}; states max_abs_err {worst:.3e} (rtol {SIM_TOL['rtol']:g} atol {SIM_TOL['atol']:g}):"
              f" {close}; {int(time_outs.sum())} time-outs, {int((dones & ~time_outs).sum())} terminals")
        if not (exact and draws and close) or not time_outs.any() or not (dones & ~time_outs).any():
            fail(f"{name}: its draws or steps on the card differ from the CPU's, or the check saw no time-out"
                 " or no terminal")


def sim_slices(smi, flagship_rates, device="cuda", num_envs=NUM_ENVS, envs_per_seed=SIM_ENVS_PER_SEED) -> dict:
    """Phase 8; returns ``{slice: {kernel: launches}}``. A CPU rehearsal
    passes ``device="cpu"`` and small counts."""
    start = time.perf_counter()
    check_sim_draws(device)
    by_slice = {}

    def ppo(make_env, cfg):
        return lambda keys: OnPolicyRunner(make_env(num_envs, device), {**copy.deepcopy(cfg), **keys}, device=device)

    # 8a, 8b: (the env, the flagship, the extras/ metric logged as Episode/*)
    for name, (make_env, flagship, logged) in {
            "mjx_recurrent_gru256": (make_mjx_chain, "recurrent_gru256", None),
            "brax_recurrent_lstm256_bf16": (make_brax_chain, "recurrent_lstm256_bf16", "extras/max_abs_x")}.items():
        (family, cfg), report = SLICES[flagship], {}
        by_slice[name] = dispatch_runs(name, ppo(make_env, cfg), smi, iterations=SIM_ITERATIONS,
                                       expected=ppo_launches(family, cfg, SIM_ITERATIONS), steady=SIM_STEADY,
                                       report=report)
        print("phase8 " + json.dumps({"slice": name, **report, "phase4b": {flagship: flagship_rates[flagship]},
                                      "launches": by_slice[name]}), flush=True)
        if device == "cuda" and None in (report["fused_capture_s"], report["k2_capture_s"]):
            fail(f"{name}: a graphed run captured no graph")
        if logged is not None and logged not in report["extras"]:
            fail(f"{name}: the env's metrics did not reach the iteration's scalars ({logged})")

    # 8c: the GRU flagship's policy on 2 seeds x 512 envs (gru_xp_* at G=4)
    name = "multiseed2_mjx_recurrent_gru256"
    runner = MultiSeedRunner(make_mjx_chain(envs_per_seed, device), copy.deepcopy(RECURRENT_GRU256), SIM_SEEDS,
                             device=device)
    reset_counts()
    runner.learn(SIM_ITERATIONS)
    torch.cuda.synchronize()
    by_slice[name] = check_launches(name, all_counts(), ppo_launches("gru_xp", RECURRENT_GRU256, SIM_ITERATIONS))
    print_history(name, runner)
    print("phase8 " + json.dumps({"slice": name, "eager_env_steps_per_s": [r["steps_per_s"] for r in runner.history],
                                  "launches": by_slice[name], "card": smi}), flush=True)
    print(f"phase 8: {time.perf_counter() - start:.1f} s")
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
    if "--parallel-rank" in sys.argv:
        # one rank of phase 7's two (the smoke launches them itself)
        import argparse

        parser = argparse.ArgumentParser()
        for arg in ("--parallel-rank", "--num-envs"):
            parser.add_argument(arg, type=int, required=True)
        for arg in ("--init", "--out", "--teacher", "--device"):
            parser.add_argument(arg, required=True)
        a = parser.parse_args()
        parallel_rank(a.parallel_rank, a.init, a.out, a.teacher, a.device, a.num_envs)
        return
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
    # phase 8's shapes: the chain doubles' 10-wide obs, in the slices' operand modes
    for i, (label, (family, S, b, bf16)) in enumerate(SIM_SHAPES.items()):
        res, repeat = check_kernels(family, S, T, b, 2 * CHAIN_SIZE, H, bf16, seed=700 + i)
        for name, checks in res.items():
            passed[name] = passed[name] and all(o for _, _, o in checks)
            if name in repeat:
                repeatable[name] = repeatable[name] and repeat[name]
        print(f"check {label} S={S} T={T} B={b} D={2 * CHAIN_SIZE} H={H} {'bf16' if bf16 else 'fp32'}: "
              + "; ".join(f"{name} max_abs_err={max(e for e, _, _ in c):.3e} (max |plain| {max(m for _, m, _ in c):.3g})"
                          f" {'ok' if all(o for _, _, o in c) else 'FAIL'}" for name, c in res.items()))
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
        flagship_rates = {name: {} for name in SLICES}
        for name, make_runner in dispatch_slices(teacher_path).items():
            dispatch_runs(name, make_runner, smi, report=flagship_rates.get(name))
        # ---- 4c. RND, symmetry, the 40-seed study, the optimizers
        by_slice.update(path_slices(smi))
        # ---- 4d. RND, symmetry, PBT and students in the study; evaluation; save_seed
        by_slice.update(study_slices(smi, teacher_path, tmp))
        # ---- 6. the host-env path, the remaining envs, export
        by_slice.update(host_slices(smi, teacher_path, tmp, T, B))
        # ---- 8. the simulator adapters
        by_slice.update(sim_slices(smi, flagship_rates))
        # ---- 7. data and tensor parallelism on torch.distributed
        by_slice.update(parallel_slices(smi, teacher_path, tmp))
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
