"""The yardstick's arithmetic against hand computations at one shape."""

import json
from pathlib import Path

import pytest

from portbench import trace, work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_gru_replay_bounds_match_the_hand_count():
    # T=24, B=1024, D=15, H=256, S=2 (the actor and critic memories), fp32
    T, B, D, H, S = 24, 1024, 15, 256, 2
    rows = T * B
    fwd_ops = S * 2 * rows * (H + D) * 3 * H  # 2 FLOPs a multiply-add over [h; x] x [Wh; Wx]
    assert fwd_ops == 20_459_814_912
    works = work.kernel_work("gru", S, T, B, D, H)
    assert works["gru_fwd"][0] == fwd_ops
    fwd_bound = work.bound_ms(*works["gru_fwd"], work.PEAKS["SXM"], bf16=False)
    assert fwd_bound == pytest.approx(0.3054, abs=5e-5)  # ops-bound: 20.46 GFLOP at 67 TFLOP/s
    assert work.bound_ms(*works["gru_bwd"], work.PEAKS["SXM"], False) == pytest.approx(0.6107, abs=5e-5)
    assert work.bound_ms(*works["gru_wgrad"], work.PEAKS["SXM"], False) == pytest.approx(0.3061, abs=5e-5)
    # 5 epochs x 4 minibatches of each
    per_iteration = work.replay_bound_ms(_config("gru256_fp32"), 4096, 15, work.PEAKS["SXM"])
    assert per_iteration == pytest.approx(20 * (0.30537 + 0.61075 + 0.30609), rel=1e-3)


def test_iteration_flops_match_the_hand_count():
    # GRU-256 at D=15: input and recurrent products, then [256, 256, 256] trunks
    gru = 2 * 15 * 768 + 2 * 256 * 768
    actor = gru + 2 * (256 * 256 + 256 * 256 + 256 * 256 + 256 * 5)
    critic = gru + 2 * (256 * 256 + 256 * 256 + 256 * 256 + 256 * 1)
    assert actor + critic == 1_622_016
    rows = 24 * 4096
    expected = rows * (actor + critic) + 4096 * critic + 3 * 5 * rows * (actor + critic)
    assert work.iteration_flops(_config("gru256_fp32"), 4096, 15, 5) == expected
    ff_actor = 2 * (15 * 256 + 256 * 256 + 256 * 256 + 256 * 5)
    ff_critic = 2 * (15 * 256 + 256 * 256 + 256 * 256 + 256 * 1)
    assert work.sample_flops(_config("ff256x3_bf16"), 15, 5) == (ff_actor, ff_critic)
    assert work.replay_bound_ms(_config("ff256x3_bf16"), 4096, 15, work.PEAKS["SXM"]) is None


def test_peaks_by_part():
    assert work.peaks_of("NVIDIA H100 80GB HBM3") is work.PEAKS["SXM"]
    assert work.peaks_of("NVIDIA H100 PCIe") is work.PEAKS["PCIe"]


def test_interval_arithmetic():
    intervals = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    assert trace.union_s(intervals, 0.0, 50.0) == pytest.approx(30e-6)
    assert trace.union_s(intervals, 15.0, 35.0) == pytest.approx(10e-6)
    assert trace.gaps(intervals, 0.0, 50.0) == [(20.0, 30.0), (40.0, 50.0)]
    assert trace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_port_kernel_names_are_read_from_the_sources():
    names = trace.port_kernel_names(Path(__file__).resolve().parents[2] / "rsl_rl_tpu_torch" / "csrc")
    assert {"rnn_chain_kernel", "rnn_wgrad_kernel", "rnn_gates_kernel"} <= names
