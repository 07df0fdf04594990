// LSTM window replay over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the Pallas xproj-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_xp_fwd    <- _lstm_fwd_kernel / _lstm_core_fwd_impl
//   lstm_xp_bwd    <- _lstm_bwd_kernel / _lstm_core_bwd_impl: the BPTT chain
//   lstm_xp_wgrad  <- the dWh / dbh accumulation of the same backward (the
//                     shared reduction of rnn_wgrad.cuh, with no x columns)
// The input projection xproj = x Wx (flax OptimizedLSTMCell has no input
// bias) is one bulk product outside the kernels, as in the JAX package; its
// gradients follow by autograd through that product. Layouts, math and the
// design note are in rsl_rl_tpu_torch/ops/lstm_rnn.py.
//
// All tensors are contiguous fp32, with a leading stream axis G:
//   xproj [G,T,B,4H], resets [G,T,B] (1 = zero the carry before step t),
//   c0 / h0 [G,B,H], wh [G,H,4H], whT [G,4H,H], bh [G,4H] (gates i|f|g|o),
//   hs / cs / ghs [G,T,B,H], dc0 / dh0 [G,B,H], gs [G,T,B,4H] (per-step
//   di|df|dg|do, which is also the gradient of xproj), C [G,H+1,4H] and its
//   split-K partial sums W [G,P,H+1,4H].
// With bf16 != 0 the operands of h Wh and dgates Whᵀ are rounded to bf16
// (round to nearest even) and the products accumulate in fp32, like the JAX
// package's _mm; xproj, the cell and hidden state and the gate math stay
// fp32. Otherwise all math is IEEE fp32 on the CUDA cores.
//
// Each entry point launches its kernel on the given stream (lstm_xp_wgrad
// two), allocates nothing, and returns the cudaError_t of the launch (0 on
// success).

#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 8;  // batch rows per forward block (H <= 256)
constexpr int kBwdRows = 8;  // batch rows per backward block (H <= 256)

// Grid (ceil(B/BB), G), one thread per hidden column j (blockDim.x == H).
// The block runs the whole window for its BB rows of stream s; thread j keeps
// c[:, j] and h[:, j] in registers and publishes the (rounded) h tile in
// shared memory; the gates add the streamed xproj row and the bias to h Wh.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) lstm_xp_fwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ bh, float* __restrict__ hs,
    float* __restrict__ cs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wh_s = wh + (size_t)s * H * G4;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = bh[(size_t)s * G4 + q * H + j];

  float c[BB], h[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const int row = b0 + b;
    c[b] = row < B ? c0[((size_t)s * B + row) * H + j] : 0.0f;
    h[b] = row < B ? h0[((size_t)s * B + row) * H + j] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G4;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float x[4][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q][b] = in ? __ldg(xp + q * H + j) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
      c[b] *= keep;
      h[b] *= keep;
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    __syncthreads();

    float a[4][BB];  // h Wh for i, f, g, o
    gate_matvec<4, BB, BF16>(wh_s, hT, H, H, j, a);

    const size_t out = st * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float i = sigmoid(x[0][b] + a[0][b] + bias[0]);
      const float f = sigmoid(x[1][b] + a[1][b] + bias[1]);
      const float g = tanhf(x[2][b] + a[2][b] + bias[2]);
      const float o = sigmoid(x[3][b] + a[3][b] + bias[3]);
      c[b] = f * c[b] + i * g;
      h[b] = o * tanhf(c[b]);
      if (row < B) {
        hs[out + (size_t)row * H + j] = h[b];
        cs[out + (size_t)row * H + j] = c[b];
      }
    }
    __syncthreads();  // hT is rewritten next step
  }
}

// Reverse-time BPTT. Same grid and thread mapping as the forward; thread j
// carries dh[:, j] and dc[:, j] in registers. Each step recomputes the gates
// from (c, h) = (t == 0 ? (c0, h0) : (cs, hs)[t-1]) * (1 - reset) and
// xproj[t], takes the new cell state from cs[t], writes di|df|dg|do to gs,
// and forms dh_prev = (dgates Whᵀ) * keep and dc_prev = gc * f * keep (whT is
// Wh transposed so that thread j reads a coalesced row per c).
// At most 128 registers a thread, so two blocks share an SM and the 256
// blocks of the multi-seed shape (G=16, B=128) run in one wave. The
// gate loads stay after the h Wh chain here: what bounds this kernel is
// each SM's shared and L2 load throughput, not their latency.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256, 2) lstm_xp_bwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ whT,
    const float* __restrict__ bh, const float* __restrict__ hs,
    const float* __restrict__ cs, const float* __restrict__ ghs, float* __restrict__ dc0,
    float* __restrict__ dh0, float* __restrict__ gs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;          // [H][BB]  h operand
  float* dgT = hT + H * BB;  // [4H][BB] di | df | dg | do operands
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wh_s = wh + (size_t)s * H * G4;
  const float* whT_s = whT + (size_t)s * G4 * H;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = bh[(size_t)s * G4 + q * H + j];

  float dh[BB], dc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) dh[b] = dc[b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = (size_t)s * T + t;
    float cp[BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float hp = 0.0f, cv = 0.0f;
      keep[b] = 0.0f;
      if (row < B) {
        keep[b] = 1.0f - resets[st * B + row];
        const size_t prev = t == 0 ? ((size_t)s * B + row) * H + j : ((st - 1) * B + row) * H + j;
        hp = t == 0 ? h0[prev] : hs[prev];
        cv = t == 0 ? c0[prev] : cs[prev];
      }
      cp[b] = cv * keep[b];
      hT[j * BB + b] = op<BF16>(hp * keep[b]);
    }
    __syncthreads();

    float a[4][BB];
    gate_matvec<4, BB, BF16>(wh_s, hT, H, H, j, a);

    const float* xp_t = xproj + st * B * G4;
    const size_t cur = st * B * H;
    float* gs_t = gs + st * B * G4;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float d_i = 0.0f, d_f = 0.0f, d_g = 0.0f, d_o = 0.0f;
      if (row < B) {
        const float* xp = xp_t + (size_t)row * G4;
        const float i = sigmoid(xp[j] + a[0][b] + bias[0]);
        const float f = sigmoid(xp[H + j] + a[1][b] + bias[1]);
        const float g = tanhf(xp[2 * H + j] + a[2][b] + bias[2]);
        const float o = sigmoid(xp[3 * H + j] + a[3][b] + bias[3]);
        const float tc = tanhf(cs[cur + (size_t)row * H + j]);
        const float gh = ghs[cur + (size_t)row * H + j] + dh[b];
        const float gc = dc[b] + gh * o * (1.0f - tc * tc);
        d_o = gh * tc * o * (1.0f - o);
        d_f = gc * cp[b] * f * (1.0f - f);
        d_i = gc * g * i * (1.0f - i);
        d_g = gc * i * (1.0f - g * g);
        dc[b] = gc * f * keep[b];
        float* grow = gs_t + (size_t)row * G4;
        grow[j] = d_i;
        grow[H + j] = d_f;
        grow[2 * H + j] = d_g;
        grow[3 * H + j] = d_o;
      }
      dgT[j * BB + b] = op<BF16>(d_i);
      dgT[(H + j) * BB + b] = op<BF16>(d_f);
      dgT[(2 * H + j) * BB + b] = op<BF16>(d_g);
      dgT[(3 * H + j) * BB + b] = op<BF16>(d_o);
    }
    __syncthreads();

    // dh_prev[:, j] = (Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc[1][BB];
    gate_matvec<1, BB, BF16>(whT_s, dgT, G4, H, j, acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      dh[b] = acc[0][b] * keep[b];
      if (t == 0 && b0 + b < B) {
        dh0[((size_t)s * B + b0 + b) * H + j] = dh[b];
        dc0[((size_t)s * B + b0 + b) * H + j] = dc[b];
      }
    }
    __syncthreads();  // hT / dgT are rewritten next step
  }
}

// H > 256: the forward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) lstm_xp_fwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ bh, float* __restrict__ hs,
    float* __restrict__ cs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wh_s = wh + (size_t)s * H * G4;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bias[kWideCols][4];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[c][q] = bh[(size_t)s * G4 + q * H + j[c]];

  float cc[kWideCols][BB], h[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      cc[c][b] = row < B ? c0[((size_t)s * B + row) * H + j[c]] : 0.0f;
      h[c][b] = row < B ? h0[((size_t)s * B + row) * H + j[c]] : 0.0f;
    }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G4;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float x[kWideCols][4][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G4;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) x[c][q][b] = in ? __ldg(xp + q * H + j[c]) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        cc[c][b] *= keep;
        h[c][b] *= keep;
        if (on[c]) hT[j[c] * BB + b] = op<BF16>(h[c][b]);
      }
    }
    __syncthreads();

    float a[kWideCols][4][BB];  // h Wh for i, f, g, o
    gate_matvec_wide<4, BB, BF16>(wh_s, hT, H, H, j, a);

    const size_t out = st * B * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const int row = b0 + b;
        const float i = sigmoid(x[c][0][b] + a[c][0][b] + bias[c][0]);
        const float f = sigmoid(x[c][1][b] + a[c][1][b] + bias[c][1]);
        const float g = tanhf(x[c][2][b] + a[c][2][b] + bias[c][2]);
        const float o = sigmoid(x[c][3][b] + a[c][3][b] + bias[c][3]);
        cc[c][b] = f * cc[c][b] + i * g;
        h[c][b] = o * tanhf(cc[c][b]);
        if (on[c] && row < B) {
          hs[out + (size_t)row * H + j[c]] = h[c][b];
          cs[out + (size_t)row * H + j[c]] = cc[c][b];
        }
      }
    __syncthreads();  // hT is rewritten next step
  }
}

// H > 256: the backward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256, 2) lstm_xp_bwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ whT,
    const float* __restrict__ bh, const float* __restrict__ hs,
    const float* __restrict__ cs, const float* __restrict__ ghs, float* __restrict__ dc0,
    float* __restrict__ dh0, float* __restrict__ gs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;          // [H][BB]  h operand
  float* dgT = hT + H * BB;  // [4H][BB] di | df | dg | do operands
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wh_s = wh + (size_t)s * H * G4;
  const float* whT_s = whT + (size_t)s * G4 * H;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bias[kWideCols][4];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[c][q] = bh[(size_t)s * G4 + q * H + j[c]];

  float dh[kWideCols][BB], dc[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) dh[c][b] = dc[c][b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = (size_t)s * T + t;
    float cp[kWideCols][BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      keep[b] = row < B ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        float hp = 0.0f, cv = 0.0f;
        if (row < B) {
          const size_t prev = t == 0 ? ((size_t)s * B + row) * H + j[c] : ((st - 1) * B + row) * H + j[c];
          hp = t == 0 ? h0[prev] : hs[prev];
          cv = t == 0 ? c0[prev] : cs[prev];
        }
        cp[c][b] = cv * keep[b];
        if (on[c]) hT[j[c] * BB + b] = op<BF16>(hp * keep[b]);
      }
    }
    __syncthreads();

    float a[kWideCols][4][BB];
    gate_matvec_wide<4, BB, BF16>(wh_s, hT, H, H, j, a);

    const float* xp_t = xproj + st * B * G4;
    const size_t cur = st * B * H;
    float* gs_t = gs + st * B * G4;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const int row = b0 + b;
        float d_i = 0.0f, d_f = 0.0f, d_g = 0.0f, d_o = 0.0f;
        if (row < B) {
          const float* xp = xp_t + (size_t)row * G4;
          const float i = sigmoid(xp[j[c]] + a[c][0][b] + bias[c][0]);
          const float f = sigmoid(xp[H + j[c]] + a[c][1][b] + bias[c][1]);
          const float g = tanhf(xp[2 * H + j[c]] + a[c][2][b] + bias[c][2]);
          const float o = sigmoid(xp[3 * H + j[c]] + a[c][3][b] + bias[c][3]);
          const float tc = tanhf(cs[cur + (size_t)row * H + j[c]]);
          const float gh = ghs[cur + (size_t)row * H + j[c]] + dh[c][b];
          const float gc = dc[c][b] + gh * o * (1.0f - tc * tc);
          d_o = gh * tc * o * (1.0f - o);
          d_f = gc * cp[c][b] * f * (1.0f - f);
          d_i = gc * g * i * (1.0f - i);
          d_g = gc * i * (1.0f - g * g);
          dc[c][b] = gc * f * keep[b];
          if (on[c]) {
            float* grow = gs_t + (size_t)row * G4;
            grow[j[c]] = d_i;
            grow[H + j[c]] = d_f;
            grow[2 * H + j[c]] = d_g;
            grow[3 * H + j[c]] = d_o;
          }
        }
        if (on[c]) {
          dgT[j[c] * BB + b] = op<BF16>(d_i);
          dgT[(H + j[c]) * BB + b] = op<BF16>(d_f);
          dgT[(2 * H + j[c]) * BB + b] = op<BF16>(d_g);
          dgT[(3 * H + j[c]) * BB + b] = op<BF16>(d_o);
        }
      }
    __syncthreads();

    // dh_prev[:, j] = (Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc[kWideCols][1][BB];
    gate_matvec_wide<1, BB, BF16>(whT_s, dgT, G4, H, j, acc);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        dh[c][b] = acc[c][0][b] * keep[b];
        if (t == 0 && on[c] && b0 + b < B) {
          dh0[((size_t)s * B + b0 + b) * H + j[c]] = dh[c][b];
          dc0[((size_t)s * B + b0 + b) * H + j[c]] = dc[c][b];
        }
      }
    __syncthreads();  // hT / dgT are rewritten next step
  }
}

}  // namespace

extern "C" int lstm_xp_fwd(const float* xproj, const float* resets, const float* c0,
                           const float* h0, const float* wh, const float* bh, float* hs,
                           float* cs, int G, int T, int B, int H, int bf16, void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_columns(lstm_xp_fwd_kernel<kFwdRows, true>, lstm_xp_fwd_wide_kernel<kFwdRows / 2, true>,
                               kFwdRows, G, B, H, H, st, xproj, resets, c0, h0, wh, bh, hs, cs, T, B, H);
  }
  return (int)launch_columns(lstm_xp_fwd_kernel<kFwdRows, false>, lstm_xp_fwd_wide_kernel<kFwdRows / 2, false>,
                             kFwdRows, G, B, H, H, st, xproj, resets, c0, h0, wh, bh, hs, cs, T, B, H);
}

extern "C" int lstm_xp_bwd(const float* xproj, const float* resets, const float* c0,
                           const float* h0, const float* wh, const float* whT, const float* bh,
                           const float* hs, const float* cs, const float* ghs, float* dc0,
                           float* dh0, float* gs, int G, int T, int B, int H, int bf16,
                           void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_columns(lstm_xp_bwd_kernel<kBwdRows, true>, lstm_xp_bwd_wide_kernel<kBwdRows / 2, true>,
                               kBwdRows, G, B, H, 5 * H, st, xproj, resets, c0, h0, wh, whT, bh, hs, cs, ghs,
                               dc0, dh0, gs, T, B, H);
  }
  return (int)launch_columns(lstm_xp_bwd_kernel<kBwdRows, false>, lstm_xp_bwd_wide_kernel<kBwdRows / 2, false>,
                             kBwdRows, G, B, H, 5 * H, st, xproj, resets, c0, h0, wh, whT, bh, hs, cs, ghs,
                             dc0, dh0, gs, T, B, H);
}

// The weight-gradient reduction of rnn_wgrad.cuh with no x columns and one
// reset mask per stream: C = Σ_rows [h_masked | 1]ᵀ [di|df|dg|do] = dWh | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_xp_wgrad(const float* resets, const float* h0, const float* hs,
                             const float* gs, float* W, float* C, int G, int T, int B, int H,
                             int P, int bf16, void* stream) {
  return rnn_wgrad_launch(nullptr, resets, h0, hs, gs, W, C, G, T, B, 0, H, P, bf16, 1, 0, stream);
}
