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

namespace {

// ------------------------------------------------------------------ forward
//
// The LSTM cell of rnn_fwd.cuh's cluster forward: a tile's 128 product
// columns are the four gates of 32 hidden columns, interleaved (n = jj*4 +
// q), over [Wh; Wx] with x right after h.

// Cell c of a thread's part of the gate tile: its tile row and hidden column
// (of the tile's 32). fp32: rows gate_row_of(ty, c/2), hidden columns tx and
// 16 + tx, gates acc[c/2][4*(c%2) + q]; bf16: of n8 tile c%4 of m16 tile c/4,
// row g (even lanes) or g + 8 (odd lanes), gates acc[c/4][c%4][q] once the
// lane pairs have swapped halves (fwd_gather_gates).
template <int kTM, bool BF16>
__device__ __forceinline__ void fwd_cell(int c, int& row, int& jj) {
  const int tid = threadIdx.x;
  if constexpr (BF16) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
    row = (warp >> 2) * (kTM / 2) + 16 * (c >> 2) + g + 8 * (q & 1);
    jj = (warp & 3) * 8 + 2 * (c & 3) + (q >> 1);
  } else {
    row = gate_row_of<kTM>(tid >> 4, c >> 1);
    jj = (c & 1) * 16 + (tid & 15);
  }
}

// bf16: lane pairs (q, q^1) hold gates 0,1 and 2,3 of the same hidden column
// for rows g and g + 8; they swap halves so that each holds all four gates of
// one row.
template <int kTM>
__device__ __forceinline__ void fwd_gather_gates(GateAcc<kTM, true>& acc) {
  const bool odd = threadIdx.x & 1;
#pragma unroll
  for (int i = 0; i < kTM / 32; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* v = acc[i][j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      if (odd) {
        v[0] = r0;
        v[1] = r1;
      } else {
        v[2] = r0;
        v[3] = r1;
      }
    }
}

template <int kTM, bool BF16>
__device__ __forceinline__ float fwd_gate(const GateAcc<kTM, BF16>& acc, int c, int q) {
  if constexpr (BF16) {
    return acc[c >> 2][c & 3][q];
  } else {
    return acc[c >> 1][4 * (c & 1) + q];
  }
}

struct LstmFwdCell {
  static constexpr int kTileCols = kGateCols;
  static constexpr bool kOneTile = false;  // 128-row tiles and one tail size (its kernels spill at 255 registers)

  __host__ __device__ static int x_start(int H) { return H; }

  // Operand row k of [Wh; Wx] at gate column n of the CTA whose hidden columns
  // start at j0 (gate q = n % 4 of hidden column j0 + n / 4), or nullptr where
  // the value is zero (past the CTA's columns or the operand rows).
  __device__ __forceinline__ static const float* weight(const RnnFwdArgs& a, int s, int j0, int hc, int k, int n) {
    const int jj = n >> 2, H = a.H;
    if (jj >= hc || k >= H + a.D) return nullptr;
    const int col = (n & 3) * H + j0 + jj;
    return k < H ? a.wh + ((size_t)s * H + k) * 4 * H + col : a.wx + ((size_t)s * a.D + k - H) * 4 * H + col;
  }

  // bh at gate column n
  __device__ __forceinline__ static float bias(const RnnFwdArgs& a, int s, int j0, int hc, int n) {
    return (n >> 2) < hc ? a.bias[(size_t)s * 4 * a.H + (n & 3) * a.H + j0 + (n >> 2)] : 0.0f;
  }

  template <int kTM, bool BF16>
  struct Tile {
    GateAcc<kTM, BF16> acc;

    __device__ __forceinline__ void at_x() {}

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      gate_tile_step<kTM, BF16>(acc, As, bt);
    }

    // the cell update at the thread's cells, written to hs[t] and cs[t]: the
    // carried c and keep are loaded here, not ahead of the product, where
    // they would hold registers through it
    __device__ __forceinline__ void epilogue(const RnnFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      constexpr int kCells = kTM / 8;
      const int H = a.H, B = a.B;
      float c_prev[kCells], keep[kCells];
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        fwd_cell<kTM, BF16>(e, row, jj);
        const int b = m0 + row, j = c.j0 + nt * 32 + jj;
        const bool on = b < c.rb1 && nt * 32 + jj < c.hc;
        keep[e] = on ? 1.0f - a.resets[(size_t)t * B + b] : 0.0f;
        c_prev[e] = !on ? 0.0f
                        : t == 0 ? a.c0[((size_t)c.s * B + b) * H + j]
                                 : a.cs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j];
      }
      if constexpr (BF16) fwd_gather_gates<kTM>(acc);
      const float* bias = c.bias + nt * kGateCols;
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        fwd_cell<kTM, BF16>(e, row, jj);
        const int b = m0 + row;
        if (b >= c.rb1 || nt * 32 + jj >= c.hc) continue;
        const float i = sigmoid(fwd_gate<kTM, BF16>(acc, e, 0) + bias[jj * 4]);
        const float f = sigmoid(fwd_gate<kTM, BF16>(acc, e, 1) + bias[jj * 4 + 1]);
        const float g = tanhf(fwd_gate<kTM, BF16>(acc, e, 2) + bias[jj * 4 + 2]);
        const float o = sigmoid(fwd_gate<kTM, BF16>(acc, e, 3) + bias[jj * 4 + 3]);
        const float cell = f * (c_prev[e] * keep[e]) + i * g;
        const size_t out = (((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * 32 + jj;
        a.cs[out] = cell;
        a.hs[out] = o * tanhf(cell);
      }
    }
  };
};

}  // namespace

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

// The forward's grid for these shapes on the current card: out[0] clusters
// the card runs at once, out[1] batch rows a cluster owns, out[2] clusters
// launched, out[3] 1 where the weight slices stay in shared memory, out[4]
// the rows of the tiles past a cluster's full 128-row ones.
extern "C" int lstm_x_fwd_plan(int S, int B, int D, int H, int bf16, int* out) {
  return rnn_x_fwd_plan<LstmFwdCell>(S, B, D, H, bf16, out);
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
