// GRU window replay over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the Pallas xproj-streaming GRU kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   gru_xp_fwd    <- _fwd_kernel / _gru_core_fwd_impl
//   gru_xp_bwd    <- _bwd_kernel / _gru_core_bwd_impl: the BPTT chain
//   gru_xp_wgrad  <- the dWh / dbhn accumulation of the same backward (the
//                    shared reduction of rnn_wgrad.cuh, with no x columns)
// The input projection xproj = x Wx + bx is one bulk product outside the
// kernels, as in the JAX package; its gradients follow by autograd through
// that product. Layouts, math and the design note are in
// rsl_rl_tpu_torch/ops/gru_rnn.py.
//
// All tensors are contiguous fp32, with a leading stream axis G (independent
// recurrences: the seeds of a multi-seed study, times the actor and critic
// memories):
//   xproj [G,T,B,3H], resets [G,T,B] (1 = zero the carry before step t),
//   carry0 [G,B,H], wh [G,H,3H], whT [G,3H,H], bhn [G,H], hs / ghs
//   [G,T,B,H], dcarry0 [G,B,H], gs [G,T,B,4H] (per-step dr|dz|dn|du; the
//   gradient of xproj is its first 3H columns), C [G,H+1,4H] and its split-K
//   partial sums W [G,P,H+1,4H].
// With bf16 != 0 the operands of h Wh and dgates Whᵀ are rounded to bf16
// (round to nearest even) and the products accumulate in fp32, like the JAX
// package's _mm; xproj, the state and the gate math stay fp32. Otherwise all
// math is IEEE fp32 on the CUDA cores.
//
// Each entry point launches its kernel on the given stream (gru_xp_wgrad two:
// the split-K products, then their fixed-order sum), allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 16;  // batch rows per forward block (H <= 256)
constexpr int kBwdRows = 8;   // batch rows per backward block (H <= 256)

// Grid (ceil(B/BB), G), one thread per hidden column j (blockDim.x == H).
// The block runs the whole window for its BB rows of stream s; thread j keeps
// h[:, j] in registers and publishes the (rounded) operand tile in shared
// memory; the gates add the streamed xproj row to h Wh.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) gru_xp_fwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float bn = bhn[(size_t)s * H + j];

  float h[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const int row = b0 + b;
    h[b] = row < B ? carry0[((size_t)s * B + row) * H + j] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G3;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float xr[BB], xz[BB], xn[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G3;
      xr[b] = in ? __ldg(xp + j) : 0.0f;
      xz[b] = in ? __ldg(xp + H + j) : 0.0f;
      xn[b] = in ? __ldg(xp + 2 * H + j) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
      h[b] *= keep;
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    __syncthreads();

    float c[3][BB];  // h Wh for r, z, n
    gate_matvec<3, BB, BF16>(wh_s, hT, H, H, j, c);

    float* hs_t = hs + st * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float r = sigmoid(xr[b] + c[0][b]);
      const float z = sigmoid(xz[b] + c[1][b]);
      const float u = c[2][b] + bn;
      const float n = tanhf(xn[b] + r * u);
      h[b] = (1.0f - z) * n + z * h[b];
      if (b0 + b < B) hs_t[(size_t)(b0 + b) * H + j] = h[b];
    }
    __syncthreads();  // hT is rewritten next step
  }
}

// Reverse-time BPTT. Same grid and thread mapping as the forward; thread j
// carries dh[:, j] in registers. Each step recomputes the gates from
// h = (t == 0 ? carry0 : hs[t-1]) * (1 - reset) and xproj[t], writes
// dr|dz|dn|du to gs, and forms dh_prev = (g*z + [dr|dz|du] Whᵀ) * keep
// (whT is Wh transposed so that thread j reads a coalesced row per c).
// At most 128 registers a thread, so two blocks share an SM and the 256
// blocks of the multi-seed shape (G=16, B=128) run in one wave. The
// gate loads stay after the h Wh chain here: what bounds this kernel is
// each SM's shared and L2 load throughput, not their latency.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256, 2) gru_xp_bwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ whT, const float* __restrict__ bhn,
    const float* __restrict__ hs, const float* __restrict__ ghs,
    float* __restrict__ dcarry0, float* __restrict__ gs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;          // [H][BB]  h operand
  float* dgT = hT + H * BB;  // [3H][BB] dr | dz | du operands
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float* whT_s = whT + (size_t)s * G3 * H;
  const float bn = bhn[(size_t)s * H + j];

  float dh[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) dh[b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = (size_t)s * T + t;
    float h[BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float hp = 0.0f;
      keep[b] = 0.0f;
      if (row < B) {
        keep[b] = 1.0f - resets[st * B + row];
        hp = t == 0 ? carry0[((size_t)s * B + row) * H + j] : hs[((st - 1) * B + row) * H + j];
      }
      h[b] = hp * keep[b];
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    __syncthreads();

    float c[3][BB];
    gate_matvec<3, BB, BF16>(wh_s, hT, H, H, j, c);

    const float* xp_t = xproj + st * B * G3;
    const float* g_t = ghs + st * B * H;
    float* gs_t = gs + st * B * 4 * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float dr = 0.0f, dz = 0.0f, dn = 0.0f, du = 0.0f;
      if (row < B) {
        const float* xp = xp_t + (size_t)row * G3;
        const float r = sigmoid(xp[j] + c[0][b]);
        const float z = sigmoid(xp[H + j] + c[1][b]);
        const float u = c[2][b] + bn;
        const float n = tanhf(xp[2 * H + j] + r * u);
        const float g = g_t[(size_t)row * H + j] + dh[b];
        dz = g * (h[b] - n) * z * (1.0f - z);
        dn = g * (1.0f - z) * (1.0f - n * n);
        du = dn * r;
        dr = dn * u * r * (1.0f - r);
        dh[b] = g * z;
        float* grow = gs_t + (size_t)row * 4 * H;
        grow[j] = dr;
        grow[H + j] = dz;
        grow[2 * H + j] = dn;
        grow[3 * H + j] = du;
      }
      dgT[j * BB + b] = op<BF16>(dr);
      dgT[(H + j) * BB + b] = op<BF16>(dz);
      dgT[(2 * H + j) * BB + b] = op<BF16>(du);
    }
    __syncthreads();

    // dh_prev[:, j] = (g*z + Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc[1][BB];
    gate_matvec<1, BB, BF16>(whT_s, dgT, G3, H, j, acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      dh[b] = (dh[b] + acc[0][b]) * keep[b];
      if (t == 0 && b0 + b < B) dcarry0[((size_t)s * B + b0 + b) * H + j] = dh[b];
    }
    __syncthreads();  // hT / dgT are rewritten next step
  }
}

// H > 256: the forward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) gru_xp_fwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bn[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) bn[c] = bhn[(size_t)s * H + j[c]];

  float h[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      h[c][b] = row < B ? carry0[((size_t)s * B + row) * H + j[c]] : 0.0f;
    }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G3;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float xr[kWideCols][BB], xz[kWideCols][BB], xn[kWideCols][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G3;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        xr[c][b] = in ? __ldg(xp + j[c]) : 0.0f;
        xz[c][b] = in ? __ldg(xp + H + j[c]) : 0.0f;
        xn[c][b] = in ? __ldg(xp + 2 * H + j[c]) : 0.0f;
      }
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        h[c][b] *= keep;
        if (on[c]) hT[j[c] * BB + b] = op<BF16>(h[c][b]);
      }
    }
    __syncthreads();

    float acc[kWideCols][3][BB];  // h Wh for r, z, n
    gate_matvec_wide<3, BB, BF16>(wh_s, hT, H, H, j, acc);

    float* hs_t = hs + st * B * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float r = sigmoid(xr[c][b] + acc[c][0][b]);
        const float z = sigmoid(xz[c][b] + acc[c][1][b]);
        const float u = acc[c][2][b] + bn[c];
        const float n = tanhf(xn[c][b] + r * u);
        h[c][b] = (1.0f - z) * n + z * h[c][b];
        if (on[c] && b0 + b < B) hs_t[(size_t)(b0 + b) * H + j[c]] = h[c][b];
      }
    __syncthreads();  // hT is rewritten next step
  }
}

// H > 256: the backward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256, 2) gru_xp_bwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ whT, const float* __restrict__ bhn,
    const float* __restrict__ hs, const float* __restrict__ ghs,
    float* __restrict__ dcarry0, float* __restrict__ gs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;          // [H][BB]  h operand
  float* dgT = hT + H * BB;  // [3H][BB] dr | dz | du operands
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float* whT_s = whT + (size_t)s * G3 * H;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bn[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) bn[c] = bhn[(size_t)s * H + j[c]];

  float dh[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) dh[c][b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = (size_t)s * T + t;
    float h[kWideCols][BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      keep[b] = row < B ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        const float hp = row >= B ? 0.0f
                         : t == 0 ? carry0[((size_t)s * B + row) * H + j[c]]
                                  : hs[((st - 1) * B + row) * H + j[c]];
        h[c][b] = hp * keep[b];
        if (on[c]) hT[j[c] * BB + b] = op<BF16>(h[c][b]);
      }
    }
    __syncthreads();

    float acc[kWideCols][3][BB];
    gate_matvec_wide<3, BB, BF16>(wh_s, hT, H, H, j, acc);

    const float* xp_t = xproj + st * B * G3;
    const float* g_t = ghs + st * B * H;
    float* gs_t = gs + st * B * 4 * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const int row = b0 + b;
        float dr = 0.0f, dz = 0.0f, dn = 0.0f, du = 0.0f;
        if (row < B) {
          const float* xp = xp_t + (size_t)row * G3;
          const float r = sigmoid(xp[j[c]] + acc[c][0][b]);
          const float z = sigmoid(xp[H + j[c]] + acc[c][1][b]);
          const float u = acc[c][2][b] + bn[c];
          const float n = tanhf(xp[2 * H + j[c]] + r * u);
          const float g = g_t[(size_t)row * H + j[c]] + dh[c][b];
          dz = g * (h[c][b] - n) * z * (1.0f - z);
          dn = g * (1.0f - z) * (1.0f - n * n);
          du = dn * r;
          dr = dn * u * r * (1.0f - r);
          dh[c][b] = g * z;
          if (on[c]) {
            float* grow = gs_t + (size_t)row * 4 * H;
            grow[j[c]] = dr;
            grow[H + j[c]] = dz;
            grow[2 * H + j[c]] = dn;
            grow[3 * H + j[c]] = du;
          }
        }
        if (on[c]) {
          dgT[j[c] * BB + b] = op<BF16>(dr);
          dgT[(H + j[c]) * BB + b] = op<BF16>(dz);
          dgT[(2 * H + j[c]) * BB + b] = op<BF16>(du);
        }
      }
    __syncthreads();

    // dh_prev[:, j] = (g*z + Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc1[kWideCols][1][BB];
    gate_matvec_wide<1, BB, BF16>(whT_s, dgT, G3, H, j, acc1);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        dh[c][b] = (dh[c][b] + acc1[c][0][b]) * keep[b];
        if (t == 0 && on[c] && b0 + b < B) dcarry0[((size_t)s * B + b0 + b) * H + j[c]] = dh[c][b];
      }
    __syncthreads();  // hT / dgT are rewritten next step
  }
}

}  // namespace

extern "C" int gru_xp_fwd(const float* xproj, const float* resets, const float* carry0,
                          const float* wh, const float* bhn, float* hs, int G, int T, int B,
                          int H, int bf16, void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_columns(gru_xp_fwd_kernel<kFwdRows, true>, gru_xp_fwd_wide_kernel<kFwdRows / 2, true>,
                               kFwdRows, G, B, H, H, st, xproj, resets, carry0, wh, bhn, hs, T, B, H);
  }
  return (int)launch_columns(gru_xp_fwd_kernel<kFwdRows, false>, gru_xp_fwd_wide_kernel<kFwdRows / 2, false>,
                             kFwdRows, G, B, H, H, st, xproj, resets, carry0, wh, bhn, hs, T, B, H);
}

extern "C" int gru_xp_bwd(const float* xproj, const float* resets, const float* carry0,
                          const float* wh, const float* whT, const float* bhn, const float* hs,
                          const float* ghs, float* dcarry0, float* gs, int G, int T, int B,
                          int H, int bf16, void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_columns(gru_xp_bwd_kernel<kBwdRows, true>, gru_xp_bwd_wide_kernel<kBwdRows / 2, true>,
                               kBwdRows, G, B, H, 4 * H, st, xproj, resets, carry0, wh, whT, bhn, hs, ghs,
                               dcarry0, gs, T, B, H);
  }
  return (int)launch_columns(gru_xp_bwd_kernel<kBwdRows, false>, gru_xp_bwd_wide_kernel<kBwdRows / 2, false>,
                             kBwdRows, G, B, H, 4 * H, st, xproj, resets, carry0, wh, whT, bhn, hs, ghs,
                             dcarry0, gs, T, B, H);
}

// The weight-gradient reduction of rnn_wgrad.cuh with no x columns and one
// reset mask per stream: C = Σ_rows [h_masked | 1]ᵀ [dr|dz|dn|du]. W is the
// caller's scratch of [G,P,H+1,4H] partial sums, P >= 1 the number of row
// splits; C [G,H+1,4H] receives their sum.
extern "C" int gru_xp_wgrad(const float* resets, const float* carry0, const float* hs,
                            const float* gs, float* W, float* C, int G, int T, int B, int H,
                            int P, int bf16, void* stream) {
  return rnn_wgrad_launch(nullptr, resets, carry0, hs, gs, W, C, G, T, B, 0, H, P, bf16, 1,
                          1, stream);
}
