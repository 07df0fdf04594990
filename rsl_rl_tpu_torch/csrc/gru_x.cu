// GRU window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming GRU kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   gru_x_fwd    <- _fwd_kernel_x_pair (S=2) and _fwd_kernel_x (S=1)
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
// on the CUDA cores; the backward's bf16-mode products run on the tensor
// cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (gru_x_fwd one,
// gru_x_bwd T+3, gru_x_wgrad one or two: the split-K products, then their
// fixed-order sum), allocates nothing, and returns the cudaError_t of the
// launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 16;  // batch rows per forward block (H <= 256)

// The six gate projections of BB rows for hidden column j: a* = x_t Wx
// (without bias), c* = h Wh (without bias). hT [H][BB] and xT [D][BB] hold
// the operands in shared memory; the weights are read from global memory
// (L2), one coalesced row of Wx / Wh per k across the block's threads.
template <int BB, bool BF16>
__device__ __forceinline__ void gate_projections(
    const float* __restrict__ wx_s, const float* __restrict__ wh_s,
    const float* hT, const float* xT, int D, int H, int j,
    float (&ar)[BB], float (&az)[BB], float (&an)[BB],
    float (&cr)[BB], float (&cz)[BB], float (&cn)[BB]) {
  const int G3 = 3 * H;
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    ar[b] = az[b] = an[b] = 0.0f;
    cr[b] = cz[b] = cn[b] = 0.0f;
  }
  for (int k = 0; k < D; ++k) {
    const float* w = wx_s + (size_t)k * G3;
    const float wr = op<BF16>(__ldg(w + j));
    const float wz = op<BF16>(__ldg(w + H + j));
    const float wn = op<BF16>(__ldg(w + 2 * H + j));
    float v[BB];
    load_rows<BB>(xT + k * BB, v);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      ar[b] = fmaf(v[b], wr, ar[b]);
      az[b] = fmaf(v[b], wz, az[b]);
      an[b] = fmaf(v[b], wn, an[b]);
    }
  }
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    const float* w = wh_s + (size_t)k * G3;
    const float wr = op<BF16>(__ldg(w + j));
    const float wz = op<BF16>(__ldg(w + H + j));
    const float wn = op<BF16>(__ldg(w + 2 * H + j));
    float v[BB];
    load_rows<BB>(hT + k * BB, v);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      cr[b] = fmaf(v[b], wr, cr[b]);
      cz[b] = fmaf(v[b], wz, cz[b]);
      cn[b] = fmaf(v[b], wn, cn[b]);
    }
  }
}


// Grid (ceil(B/BB), S), one thread per hidden column j (blockDim.x == H).
// The block runs the whole window for its BB rows of stream s; thread j keeps
// h[:, j] in registers and publishes the (rounded) operand tile in shared.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) gru_x_fwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wx,
    const float* __restrict__ bx, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;           // [H][BB]
  float* xT = smem + H * BB;  // [D][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wx_s = wx + (size_t)s * D * G3;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float bxr = bx[(size_t)s * G3 + j];
  const float bxz = bx[(size_t)s * G3 + H + j];
  const float bxn = bx[(size_t)s * G3 + 2 * H + j];
  const float bn = bhn[(size_t)s * H + j];

  float h[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const int row = b0 + b;
    h[b] = row < B ? carry0[((size_t)s * B + row) * H + j] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float keep = row < B ? 1.0f - resets[(size_t)t * B + row] : 0.0f;
      h[b] *= keep;
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    load_x<BB, BF16>(xs + ((size_t)s * T + t) * B * D, xT, b0, B, D);
    __syncthreads();

    float ar[BB], az[BB], an[BB], cr[BB], cz[BB], cn[BB];
    gate_projections<BB, BF16>(wx_s, wh_s, hT, xT, D, H, j, ar, az, an, cr, cz, cn);

    float* hs_t = hs + ((size_t)s * T + t) * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float r = sigmoid(ar[b] + bxr + cr[b]);
      const float z = sigmoid(az[b] + bxz + cz[b]);
      const float u = cn[b] + bn;
      const float n = tanhf(an[b] + bxn + r * u);
      h[b] = (1.0f - z) * n + z * h[b];
      if (b0 + b < B) hs_t[(size_t)(b0 + b) * H + j] = h[b];
    }
    __syncthreads();  // hT / xT are rewritten next step
  }
}

// The six gate projections of BB rows for the thread's kWideCols hidden
// columns j:
// a* = x_t Wx (without bias), c* = h Wh (without bias). hT [H][BB] and xT
// [D][BB] hold the operands in shared memory; the weights are read from
// global memory (L2), one coalesced row of Wx / Wh per k across the block's
// threads.
template <int BB, bool BF16>
__device__ __forceinline__ void gate_projections_wide(
    const float* __restrict__ wx_s, const float* __restrict__ wh_s,
    const float* hT, const float* xT, int D, int H, const int (&j)[kWideCols],
    float (&ar)[kWideCols][BB], float (&az)[kWideCols][BB], float (&an)[kWideCols][BB],
    float (&cr)[kWideCols][BB], float (&cz)[kWideCols][BB], float (&cn)[kWideCols][BB]) {
  const int G3 = 3 * H;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      ar[c][b] = az[c][b] = an[c][b] = 0.0f;
      cr[c][b] = cz[c][b] = cn[c][b] = 0.0f;
    }
  for (int k = 0; k < D; ++k) {
    const float* w = wx_s + (size_t)k * G3;
    float wq[kWideCols][3];
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int q = 0; q < 3; ++q) wq[c][q] = op<BF16>(__ldg(w + q * H + j[c]));
    float v[BB];
    load_rows<BB>(xT + k * BB, v);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        ar[c][b] = fmaf(v[b], wq[c][0], ar[c][b]);
        az[c][b] = fmaf(v[b], wq[c][1], az[c][b]);
        an[c][b] = fmaf(v[b], wq[c][2], an[c][b]);
      }
  }
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    const float* w = wh_s + (size_t)k * G3;
    float wq[kWideCols][3];
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int q = 0; q < 3; ++q) wq[c][q] = op<BF16>(__ldg(w + q * H + j[c]));
    float v[BB];
    load_rows<BB>(hT + k * BB, v);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        cr[c][b] = fmaf(v[b], wq[c][0], cr[c][b]);
        cz[c][b] = fmaf(v[b], wq[c][1], cz[c][b]);
        cn[c][b] = fmaf(v[b], wq[c][2], cn[c][b]);
      }
  }
}

// H > 256: the kernel above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) gru_x_fwd_wide_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wx,
    const float* __restrict__ bx, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;           // [H][BB]
  float* xT = smem + H * BB;  // [D][BB]
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wx_s = wx + (size_t)s * D * G3;
  const float* wh_s = wh + (size_t)s * H * G3;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bxr[kWideCols], bxz[kWideCols], bxn[kWideCols], bn[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    bxr[c] = bx[(size_t)s * G3 + j[c]];
    bxz[c] = bx[(size_t)s * G3 + H + j[c]];
    bxn[c] = bx[(size_t)s * G3 + 2 * H + j[c]];
    bn[c] = bhn[(size_t)s * H + j[c]];
  }

  float h[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      h[c][b] = row < B ? carry0[((size_t)s * B + row) * H + j[c]] : 0.0f;
    }
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float keep = row < B ? 1.0f - resets[(size_t)t * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        h[c][b] *= keep;
        if (on[c]) hT[j[c] * BB + b] = op<BF16>(h[c][b]);
      }
    }
    load_x<BB, BF16>(xs + ((size_t)s * T + t) * B * D, xT, b0, B, D);
    __syncthreads();

    float ar[kWideCols][BB], az[kWideCols][BB], an[kWideCols][BB], cr[kWideCols][BB], cz[kWideCols][BB], cn[kWideCols][BB];
    gate_projections_wide<BB, BF16>(wx_s, wh_s, hT, xT, D, H, j, ar, az, an, cr, cz, cn);

    float* hs_t = hs + ((size_t)s * T + t) * B * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float r = sigmoid(ar[c][b] + bxr[c] + cr[c][b]);
        const float z = sigmoid(az[c][b] + bxz[c] + cz[c][b]);
        const float u = cn[c][b] + bn[c];
        const float n = tanhf(an[c][b] + bxn[c] + r * u);
        h[c][b] = (1.0f - z) * n + z * h[c][b];
        if (on[c] && b0 + b < B) hs_t[(size_t)(b0 + b) * H + j[c]] = h[c][b];
      }
    __syncthreads();  // hT / xT are rewritten next step
  }
}

// ------------------------------------------------------------------ backward
//
// The GRU cell of rnn_bwd.cuh's three phases. Phase 1 writes r|z|a_n|u into
// gs: r and z activated, a_n = x Wx_n + bx_n and u = h Wh_n + bhn as they
// are; the chain's epilogue finishes n = tanh(a_n + r*u) at its cell and
// writes dr|dz|dn|du over them. The carry is g*z.
struct GruCell {
  static constexpr int kGates = 3;  // gate blocks of Wx (dx takes dr|dz|dn)

  __device__ __forceinline__ static int chain_k(int H) { return 3 * H; }
  // the chain's k-th column is gs column k of dr|dz, then du (dn is skipped)
  __device__ __forceinline__ static int chain_col(int c, int H) { return c < 2 * H ? c : c + H; }
  // four gs columns from a multiple of 4 lie in one gate block, 16-byte aligned
  __device__ __forceinline__ static bool vec4(int H) { return (H & 3) == 0; }
  // a tile of a_n columns needs only the x rows, one of u columns only the h rows
  __device__ __forceinline__ static void k_range(int n0, int n_end, int H, int D, int& lo, int& hi) {
    const int q0 = n0 / H, q1 = (n_end - 1) / H;
    lo = q0 == 2 && q1 == 2 ? H : 0;
    hi = q0 == 3 && q1 == 3 ? H : H + D;
  }
  // W[k][col] of phase 1: h rows [Wh_r | Wh_z | 0 | Wh_n], x rows [Wx_r | Wx_z | Wx_n | 0]
  __device__ __forceinline__ static const float* gate_weight(const RnnBwdArgs& a, int s, int k, int col) {
    const int H = a.H, G3 = 3 * H, q = col / H, jj = col - q * H;
    if (k < H) return q == 2 ? nullptr : a.wh + ((size_t)s * H + k) * G3 + (q == 3 ? 2 * H : q * H) + jj;
    return q == 3 ? nullptr : a.wx + ((size_t)s * a.D + k - H) * G3 + q * H + jj;
  }
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int s, int col, float v) {
    const int H = a.H, q = col / H;
    if (q == 3) return v + a.bias2[(size_t)s * H + col - 3 * H];
    v += a.bias[(size_t)s * 3 * H + col];
    return q < 2 ? sigmoid(v) : v;
  }

  // The cell's gradient at step t, row b, hidden columns j..j+3: the load
  // half (r|z|a_n|u from gs, the masked h entering step t, ghs) and the
  // compute-and-store half (dr|dz|dn|du over them, and g*z into the carry).
  struct State4 {
    float r[4], z[4], an[4], u[4], h[4], gh[4];
  };

  __device__ __forceinline__ static State4 load4(const RnnBwdArgs& a, int s, int t, int b, int j) {
    const int H = a.H;
    const int n = min(4, H - j);
    const bool vec = n == 4 && (H & 3) == 0;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    const float* g = a.gs + row * 4 * H + j;
    State4 x;
    load_cols4(g, vec, n, x.r);
    load_cols4(g + H, vec, n, x.z);
    load_cols4(g + 2 * H, vec, n, x.an);
    load_cols4(g + 3 * H, vec, n, x.u);
    load_cols4(t == 0 ? a.h0 + ((size_t)s * a.B + b) * H + j : a.hs + (row - a.B) * H + j, vec, n, x.h);
    load_cols4(a.ghs + row * H + j, vec, n, x.gh);
    const float keep = 1.0f - a.resets[(size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) x.h[e] *= keep;
    return x;
  }

  __device__ __forceinline__ static void no_carry(State4&) {}

  __device__ __forceinline__ static void store4(const RnnBwdArgs& a, int s, int t, int b, int j,
                                                const State4& x, const float (&dh)[4]) {
    const int H = a.H;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    float* g = a.gs + row * 4 * H + j;
    float* gz = a.carry + ((size_t)s * a.B + b) * H + j;
    for (int e = 0; e < min(4, H - j); ++e) {
      const float r = x.r[e], z = x.z[e], u = x.u[e];
      const float n = tanhf(x.an[e] + r * u);
      const float gg = x.gh[e] + dh[e];
      const float dn = gg * (1.0f - z) * (1.0f - n * n);
      g[e] = dn * u * r * (1.0f - r);
      g[H + e] = gg * (x.h[e] - n) * z * (1.0f - z);
      g[2 * H + e] = dn;
      g[3 * H + e] = dn * r;
      gz[e] = gg * z;
    }
  }

  // dh_prev = (g*z + [dr|dz|du]_t Whᵀ) * keep_t
  __device__ __forceinline__ static void dh_prev(const RnnBwdArgs& a, int s, int t, int b, int j,
                                                 const float (&prod)[4], float (&dh)[4]) {
    const int n = min(4, a.H - j);
    float gz[4];
    load_cols4(a.carry + ((size_t)s * a.B + b) * a.H + j, n == 4 && (a.H & 3) == 0, n, gz);
    const float keep = 1.0f - a.resets[(size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = (gz[e] + prod[e]) * keep;
  }

  // t = 0: dcarry0, over the carry buffer
  __device__ __forceinline__ static void finish(const RnnBwdArgs& a, int s, int b, int j, const float (&dh)[4]) {
    for (int e = 0; e < min(4, a.H - j); ++e) a.carry[((size_t)s * a.B + b) * a.H + j + e] = dh[e];
  }
};

}  // namespace

extern "C" int gru_x_fwd(const float* xs, const float* resets, const float* carry0,
                         const float* wx, const float* bx, const float* wh, const float* bhn,
                         float* hs, int S, int T, int B, int D, int H, int bf16, void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_columns(gru_x_fwd_kernel<kFwdRows, true>, gru_x_fwd_wide_kernel<kFwdRows / 2, true>,
                               kFwdRows, S, B, H, H + D, st, xs, resets, carry0, wx, bx, wh, bhn, hs, T, B,
                               D, H);
  }
  return (int)launch_columns(gru_x_fwd_kernel<kFwdRows, false>, gru_x_fwd_wide_kernel<kFwdRows / 2, false>,
                             kFwdRows, S, B, H, H + D, st, xs, resets, carry0, wx, bx, wh, bhn, hs, T, B, D,
                             H);
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
                     gs, T, B, D, H};
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
