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

namespace {

// ------------------------------------------------------------------ forward
//
// The GRU cell of rnn_fwd.cuh's cluster forward. Each hidden column has
// three product columns, r | z | n, over [Wh; Wx] as they are (no zero
// block): a tile's 96 columns hold 32 hidden columns in blocks of 8, column
// blk*24 + q*8 + c being quantity q of hidden column blk*8 + c, so that an
// fp32 thread's three float2 loads of a weight row and a bf16 warp's three n8
// tiles each take one quantity of the same hidden columns, and every thread
// ends with all three of its cells. The n column must give u = h Wh_n + bhn
// and a_n = x Wx_n + bx_n apart (n = tanh(a_n + r*u)): x starts at the
// k-tile after h (H rounded up to 16), and at the first x k-tile the tile
// stashes the n column's sum over h (u) and restarts it, so it ends with the
// sum over x (a_n). Against interleaving four quantities with zero blocks
// (u has no x rows, a_n no h rows), that saves the quarter of the h-product
// that would multiply zeros. The epilogue re-reads the h it wrote a step
// earlier: h' = (1 - z) * n + z * h * keep.
struct GruFwdCell {
  static constexpr int kTileCols = 3 * kFwdTileHidden;
  static constexpr bool kOneTile = true;  // a cluster's rows in one 96- or 160-row tile where they fit
  static constexpr bool kXproj = false;
  using Args = RnnFwdArgs;

  __host__ __device__ static int x_start(int H) { return (H + kGateK - 1) / kGateK * kGateK; }

  // Operand row k (h rows, then x rows from x_start) at product column n of
  // the CTA whose hidden columns start at j0, or nullptr where the value is
  // zero (past the CTA's columns, between h and x, past the operand rows).
  __device__ __forceinline__ static const float* weight(const RnnFwdArgs& a, int s, int j0, int hc, int k, int n) {
    const int nt = n / kTileCols, nl = n - nt * kTileCols, blk = nl / 24;
    const int jj = nt * kFwdTileHidden + blk * 8 + (nl & 7), q = (nl - blk * 24) >> 3;
    const int H = a.H, x0 = x_start(H);
    if (jj >= hc) return nullptr;
    const int col = q * H + j0 + jj;
    if (k < H) return a.wh + ((size_t)s * H + k) * 3 * H + col;
    if (k < x0 || k >= x0 + a.D) return nullptr;
    return a.wx + ((size_t)s * a.D + k - x0) * 3 * H + col;
  }

  // The bias a tile stages (128 floats): bx_r | bx_z | bhn | bx_n of its 32
  // hidden columns.
  __device__ __forceinline__ static float bias(const RnnFwdArgs& a, int s, int j0, int hc, int n) {
    const int q = (n >> 5) & 3, jj = (n >> 7) * kFwdTileHidden + (n & 31), H = a.H;
    if (jj >= hc) return 0.0f;
    const int j = j0 + jj;
    return q == 2 ? a.bias2[(size_t)s * H + j] : a.bias[(size_t)s * 3 * H + (q == 3 ? 2 : q) * H + j];
  }

  // fp32: thread (ty, tx) owns the rows gate_row_of(ty, i) and hidden columns
  // cb + e (cb = (tx/4)*8 + (tx%4)*2, e = 0, 1): acc[i][2q + e] is quantity q,
  // u[i][e] the stash. A cell c is (i, e) = (c/2, c%2).
  template <int kTM>
  struct TileF32 {
    float acc[kTM / 16][6];
    float u[kTM / 16][2];

    __device__ __forceinline__ void at_x() {
#pragma unroll
      for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u[i][e] = acc[i][4 + e];
          acc[i][4 + e] = 0.0f;
        }
    }

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      constexpr int kLdA = gate_lda<false>();
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
      const int cb = (tx >> 2) * 24 + (tx & 3) * 2;
#pragma unroll
      for (int kk = 0; kk < kGateK; ++kk) {
        float av[kTM / 16];
#pragma unroll
        for (int i = 0; i < kTM / 16; ++i) av[i] = As[gate_row_of<kTM>(ty, i) * kLdA + kk];
        const float* br = bt.row(kk) + cb;
        const float2 b0 = *reinterpret_cast<const float2*>(br);
        const float2 b1 = *reinterpret_cast<const float2*>(br + 8);
        const float2 b2 = *reinterpret_cast<const float2*>(br + 16);
        const float bv[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
#pragma unroll
        for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    __device__ __forceinline__ void cell(int c, int& row, int& jj) const {
      const int tx = threadIdx.x & 15;
      row = gate_row_of<kTM>(threadIdx.x >> 4, c >> 1);
      jj = (tx >> 2) * 8 + (tx & 3) * 2 + (c & 1);
    }
    __device__ __forceinline__ float quantity(int c, int q) const { return acc[c >> 1][2 * q + (c & 1)]; }
    __device__ __forceinline__ float stashed(int c) const { return u[c >> 1][c & 1]; }
  };

  // bf16: warp (wm, wn) owns rows wm*kTM/2.. (kTM/32 m16 tiles) and hidden
  // columns wn*8..wn*8+7, its n8 tile q being quantity q of them (mma's C
  // layout: lane (g, l) holds rows g, g+8 x hidden columns 2l, 2l+1):
  // acc[i][q][v], u[i][v] the stash. A cell c is (i, v) = (c/4, c%4).
  template <int kTM>
  struct TileB16 {
    float acc[kTM / 32][3][4];
    float u[kTM / 32][4];

    __device__ __forceinline__ void at_x() {
#pragma unroll
      for (int i = 0; i < kTM / 32; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          u[i][v] = acc[i][2][v];
          acc[i][2][v] = 0.0f;
        }
    }

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      constexpr int kLdA = gate_lda<true>();
      const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, l = threadIdx.x & 3;
      const int wm = warp >> 2, wn = warp & 3;
      uint32_t b[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) bt.frag(l, wn * 24 + 8 * q + g, b[q][0], b[q][1]);
#pragma unroll
      for (int i = 0; i < kTM / 32; ++i) {
        const float* ar0 = As + (wm * (kTM / 2) + 16 * i + g) * kLdA + 2 * l;
        const float2 x0 = *reinterpret_cast<const float2*>(ar0);
        const float2 x1 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA);
        const float2 x2 = *reinterpret_cast<const float2*>(ar0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA + 8);
        const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                                pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int q = 0; q < 3; ++q) mma_bf16(acc[i][q], af, b[q][0], b[q][1]);
      }
    }

    __device__ __forceinline__ void cell(int c, int& row, int& jj) const {
      const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, l = threadIdx.x & 3;
      row = (warp >> 2) * (kTM / 2) + 16 * (c >> 2) + g + 8 * ((c & 3) >> 1);
      jj = (warp & 3) * 8 + 2 * l + (c & 1);
    }
    __device__ __forceinline__ float quantity(int c, int q) const { return acc[c >> 2][q][c & 3]; }
    __device__ __forceinline__ float stashed(int c) const { return u[c >> 2][c & 3]; }
  };

  template <int kTM, bool BF16>
  struct Tile : std::conditional<BF16, TileB16<kTM>, TileF32<kTM>>::type {
    // the cell update at the thread's cells, written to hs[t]: the carried h
    // and keep are loaded here, not ahead of the product
    __device__ __forceinline__ void epilogue(const RnnFwdArgs& a, const FwdCta& c, int t, int m0, int nt) const {
      constexpr int kCells = kTM / 8;
      const int H = a.H, B = a.B;
      float h_prev[kCells];
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row, j = c.j0 + nt * kFwdTileHidden + jj;
        const bool on = b < c.rb1 && nt * kFwdTileHidden + jj < c.hc;
        const float keep = on ? 1.0f - a.resets[(size_t)t * B + b] : 0.0f;
        h_prev[e] = !on ? 0.0f
                        : keep * (t == 0 ? a.h0[((size_t)c.s * B + b) * H + j]
                                         : a.hs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j]);
      }
      const float* bias = c.bias + nt * kGateCols;
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row;
        if (b >= c.rb1 || nt * kFwdTileHidden + jj >= c.hc) continue;
        const float r = sigmoid(this->quantity(e, 0) + bias[jj]);
        const float z = sigmoid(this->quantity(e, 1) + bias[32 + jj]);
        const float u = this->stashed(e) + bias[64 + jj];
        const float n = tanhf(this->quantity(e, 2) + bias[96 + jj] + r * u);
        a.hs[(((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * kFwdTileHidden + jj] = (1.0f - z) * n + z * h_prev[e];
      }
    }
  };
};

}  // namespace

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
