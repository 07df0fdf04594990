// LSTM window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_x_fwd    <- _lstm_fwd_kernel_x_pair (S=2) and _lstm_fwd_kernel_x (S=1):
//                    the cluster forward of rnn_fwd.cuh with the LSTM cell
//   lstm_x_bwd    <- _lstm_bwd_kernel_x_pair / _lstm_bwd_kernel_x: the BPTT chain,
//                    in the three phases of rnn_bwd.cuh with the LSTM cell
//   lstm_x_wgrad  <- the weight-gradient accumulation of the same backward
//                    (the shared reduction of rnn_wgrad.cuh)
// Layouts, math and the design note are in rsl_rl_tpu_torch/ops/lstm_rnn.py.
//
// All tensors are contiguous fp32:
//   xs [S,T,B,D], resets [T,B] (1 = zero the carry before step t),
//   c0 / h0 [S,B,H], wx [S,D,4H], wh [S,H,4H], whT [S,4H,H], bh [S,4H]
//   (gates i|f|g|o), hs / cs / ghs [S,T,B,H], dx [S,T,B,D], dc0 / dh0
//   [S,B,H], gs [S,T,B,4H] (per-step di|df|dg|do), C [S,H+D+1,4H] and its
//   split-K partial sums W [S,P,H+D+1,4H].
// With bf16 != 0 every matmul operand is rounded to bf16 (round to nearest
// even) and the product accumulates in fp32, like the JAX package's _mm; the
// cell and hidden state, gate math and bias sums stay fp32. Otherwise all
// math is IEEE fp32 on the CUDA cores; bf16-mode products run on the tensor
// cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (lstm_x_fwd one,
// lstm_x_bwd T+3, lstm_x_wgrad one or two), allocates nothing, and returns the
// cudaError_t of the launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_fwd.cuh"
#include "rnn_wgrad.cuh"

extern "C" int lstm_x_fwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* bh,
                          float* hs, float* cs, int S, int T, int B, int D, int H, int bf16,
                          void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const RnnFwdArgs a{xs, resets, c0, h0, wx, wh, bh, nullptr, hs, cs, T, B, D, H, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_x_fwd_launch<LstmFwdCell, true>(a, S, st) : rnn_x_fwd_launch<LstmFwdCell, false>(a, S, st));
}

// The forward's grid for these shapes on the current card: seven ints, as
// rnn_x_fwd_plan (rnn_fwd.cuh) gives them.
extern "C" int lstm_x_fwd_plan(int S, int B, int D, int H, int bf16, int* out) {
  return bf16 ? rnn_x_fwd_plan<LstmFwdCell, true>(S, B, D, H, out) : rnn_x_fwd_plan<LstmFwdCell, false>(S, B, D, H, out);
}

// phase_ms: nullptr, or three floats that receive the milliseconds of the
// three phases (the call then waits for the stream).
extern "C" int lstm_x_bwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* whT,
                          const float* bh, const float* hs, const float* cs, const float* ghs,
                          float* dx, float* dc0, float* dh0, float* gs, int S, int T, int B,
                          int D, int H, int bf16, void* stream, float* phase_ms) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const RnnBwdArgs a{xs, resets, c0, h0, wx, wh, whT, bh, nullptr, hs, cs, ghs, dx, dc0, dh0, gs, T, B, D, H,
                     0, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_bwd_launch<LstmCell, true>(a, S, st, phase_ms)
                    : rnn_bwd_launch<LstmCell, false>(a, S, st, phase_ms));
}

// The weight-gradient reduction of rnn_wgrad.cuh with the LSTM's gate
// gradients: C = Σ_rows [h_masked | x | 1]ᵀ [di|df|dg|do] = dWh | dWx | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_x_wgrad(const float* xs, const float* resets, const float* h0,
                            const float* hs, const float* gs, float* W, float* C, int S, int T,
                            int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, h0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, 0, stream);
}
