// GRU window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming GRU kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   gru_x_fwd    <- _fwd_kernel_x_pair (S=2) and _fwd_kernel_x (S=1): the
//                   cluster forward of rnn_fwd.cuh with the GRU cell
//   gru_x_bwd    <- _bwd_kernel_x_pair / _bwd_kernel_x: the BPTT chain, in
//                   the three phases of rnn_bwd.cuh with the GRU cell
//   gru_x_wgrad  <- the weight-gradient accumulation of the same backward
// Layouts, math and the design note are in rsl_rl_tpu_torch/ops/gru_rnn.py.
//
// All tensors are contiguous fp32:
//   xs [S,T,B,D], resets [T,B] (1 = zero the carry before step t),
//   carry0 [S,B,H], wx [S,D,3H], bx [S,3H], wh [S,H,3H], whT [S,3H,H],
//   bhn [S,H], hs / ghs [S,T,B,H], dx [S,T,B,D], dcarry0 [S,B,H],
//   gs [S,T,B,4H] (per-step dr|dz|dn|du), C [S,H+D+1,4H] and its split-K
//   partial sums W [S,P,H+D+1,4H].
// With bf16 != 0 every matmul operand is rounded to bf16 (round to nearest
// even) and the product accumulates in fp32, like the JAX package's _mm; the
// state, gate math and bias sums stay fp32. Otherwise all math is IEEE fp32
// on the CUDA cores; bf16-mode products run on the tensor cores
// (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (gru_x_fwd one,
// gru_x_bwd T+3, gru_x_wgrad one or two: the split-K products, then their
// fixed-order sum), allocates nothing, and returns the cudaError_t of the
// launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_fwd.cuh"
#include "rnn_wgrad.cuh"

extern "C" int gru_x_fwd(const float* xs, const float* resets, const float* carry0,
                         const float* wx, const float* bx, const float* wh, const float* bhn,
                         float* hs, int S, int T, int B, int D, int H, int bf16, void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const RnnFwdArgs a{xs, resets, nullptr, carry0, wx, wh, bx, bhn, hs, nullptr, T, B, D, H, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_x_fwd_launch<GruFwdCell, true>(a, S, st) : rnn_x_fwd_launch<GruFwdCell, false>(a, S, st));
}

// The forward's grid for these shapes on the current card: seven ints, as
// rnn_x_fwd_plan (rnn_fwd.cuh) gives them.
extern "C" int gru_x_fwd_plan(int S, int B, int D, int H, int bf16, int* out) {
  return bf16 ? rnn_x_fwd_plan<GruFwdCell, true>(S, B, D, H, out) : rnn_x_fwd_plan<GruFwdCell, false>(S, B, D, H, out);
}

// phase_ms: nullptr, or three floats that receive the milliseconds of the
// three phases (the call then waits for the stream).
extern "C" int gru_x_bwd(const float* xs, const float* resets, const float* carry0,
                         const float* wx, const float* bx, const float* wh, const float* whT,
                         const float* bhn, const float* hs, const float* ghs, float* dx,
                         float* dcarry0, float* gs, int S, int T, int B, int D, int H, int bf16,
                         void* stream, float* phase_ms) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const RnnBwdArgs a{xs, resets, nullptr, carry0, wx, wh, whT, bx, bhn, hs, nullptr, ghs, dx, dcarry0, nullptr,
                     gs, T, B, D, H, 0, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_bwd_launch<GruCell, true>(a, S, st, phase_ms)
                    : rnn_bwd_launch<GruCell, false>(a, S, st, phase_ms));
}

// The weight-gradient reduction of rnn_wgrad.cuh: C = Σ_rows [h_masked | x | 1]ᵀ
// [dr|dz|dn|du]. W is the caller's scratch of [S,P,M,N] partial sums, P >= 1
// the number of row splits; C [S,M,N] receives their sum.
extern "C" int gru_x_wgrad(const float* xs, const float* resets, const float* carry0,
                           const float* hs, const float* gs, float* W, float* C, int S, int T,
                           int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, carry0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, 1, stream);
}
