// LSTM window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_x_fwd    <- _lstm_fwd_kernel_x_pair (S=2) and _lstm_fwd_kernel_x (S=1)
//   lstm_x_bwd    <- _lstm_bwd_kernel_x_pair / _lstm_bwd_kernel_x: the BPTT chain
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
// math is IEEE fp32 on the CUDA cores.
//
// Each entry point launches its kernel on the given stream (lstm_x_wgrad two),
// allocates nothing, and returns the cudaError_t of the launch (0 on success).

#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 8;  // batch rows per forward block
constexpr int kBwdRows = 8;  // batch rows per backward block

// The four gate pre-activations of BB rows for hidden column j, without the
// bias: a[q] = x_t Wx[:, qH + j] + h Wh[:, qH + j] for q = i, f, g, o. hT
// [H][BB] and xT [D][BB] hold the operands in shared memory; the weights are
// read from global memory (L2), one coalesced row of Wx / Wh per k across
// the block's threads.
template <int BB, bool BF16>
__device__ __forceinline__ void gate_sums(const float* __restrict__ wx_s,
                                          const float* __restrict__ wh_s, const float* hT,
                                          const float* xT, int D, int H, int j,
                                          float (&a)[4][BB]) {
  const int G4 = 4 * H;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < BB; ++b) a[q][b] = 0.0f;
  for (int k = 0; k < D; ++k) {
    const float* w = wx_s + (size_t)k * G4 + j;
    float wq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wq[q] = op<BF16>(__ldg(w + q * H));
    float v[BB];
    load_rows<BB>(xT + k * BB, v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < BB; ++b) a[q][b] = fmaf(v[b], wq[q], a[q][b]);
  }
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    const float* w = wh_s + (size_t)k * G4 + j;
    float wq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wq[q] = op<BF16>(__ldg(w + q * H));
    float v[BB];
    load_rows<BB>(hT + k * BB, v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < BB; ++b) a[q][b] = fmaf(v[b], wq[q], a[q][b]);
  }
}

// Grid (ceil(B/BB), S), one thread per hidden column j (blockDim.x == H).
// The block runs the whole window for its BB rows of stream s; thread j keeps
// c[:, j] and h[:, j] in registers and publishes the (rounded) h tile in
// shared memory.
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) lstm_x_fwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wx, const float* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ hs, float* __restrict__ cs,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;           // [H][BB]
  float* xT = smem + H * BB;  // [D][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wx_s = wx + (size_t)s * D * G4;
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
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float keep = row < B ? 1.0f - resets[(size_t)t * B + row] : 0.0f;
      c[b] *= keep;
      h[b] *= keep;
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    load_x<BB, BF16>(xs + ((size_t)s * T + t) * B * D, xT, b0, B, D);
    __syncthreads();

    float a[4][BB];
    gate_sums<BB, BF16>(wx_s, wh_s, hT, xT, D, H, j, a);

    const size_t out = ((size_t)s * T + t) * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float i = sigmoid(a[0][b] + bias[0]);
      const float f = sigmoid(a[1][b] + bias[1]);
      const float g = tanhf(a[2][b] + bias[2]);
      const float o = sigmoid(a[3][b] + bias[3]);
      c[b] = f * c[b] + i * g;
      h[b] = o * tanhf(c[b]);
      if (b0 + b < B) {
        hs[out + (size_t)(b0 + b) * H + j] = h[b];
        cs[out + (size_t)(b0 + b) * H + j] = c[b];
      }
    }
    __syncthreads();  // hT / xT are rewritten next step
  }
}

// Reverse-time BPTT. Same grid and thread mapping as the forward; thread j
// carries dh[:, j] and dc[:, j] in registers. Each step recomputes the gates
// from (c, h) = (t == 0 ? (c0, h0) : (cs, hs)[t-1]) * (1 - reset), takes the
// new cell state from cs[t], writes di|df|dg|do to gs, and forms
// dx_t = dgates Wxᵀ, dh_prev = (dgates Whᵀ) * keep and dc_prev = gc * f * keep
// (whT is Wh transposed so that thread j reads a coalesced row per c).
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) lstm_x_bwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wx, const float* __restrict__ wh,
    const float* __restrict__ whT, const float* __restrict__ bh,
    const float* __restrict__ hs, const float* __restrict__ cs,
    const float* __restrict__ ghs, float* __restrict__ dx, float* __restrict__ dc0,
    float* __restrict__ dh0, float* __restrict__ gs, int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;          // [H][BB]  h operand
  float* xT = hT + H * BB;   // [D][BB]  x operand
  float* dgT = xT + D * BB;  // [4H][BB] di | df | dg | do operands
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wx_s = wx + (size_t)s * D * G4;
  const float* wh_s = wh + (size_t)s * H * G4;
  const float* whT_s = whT + (size_t)s * G4 * H;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = bh[(size_t)s * G4 + q * H + j];

  float dh[BB], dc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) dh[b] = dc[b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    float cp[BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float hp = 0.0f, cv = 0.0f;
      keep[b] = 0.0f;
      if (row < B) {
        keep[b] = 1.0f - resets[(size_t)t * B + row];
        const size_t prev = t == 0 ? ((size_t)s * B + row) * H + j
                                   : (((size_t)s * T + t - 1) * B + row) * H + j;
        hp = t == 0 ? h0[prev] : hs[prev];
        cv = t == 0 ? c0[prev] : cs[prev];
      }
      cp[b] = cv * keep[b];
      hT[j * BB + b] = op<BF16>(hp * keep[b]);
    }
    load_x<BB, BF16>(xs + ((size_t)s * T + t) * B * D, xT, b0, B, D);
    __syncthreads();

    float a[4][BB];
    gate_sums<BB, BF16>(wx_s, wh_s, hT, xT, D, H, j, a);

    const size_t cur = ((size_t)s * T + t) * B * H;
    float* gs_t = gs + ((size_t)s * T + t) * B * G4;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float i = sigmoid(a[0][b] + bias[0]);
      const float f = sigmoid(a[1][b] + bias[1]);
      const float g = tanhf(a[2][b] + bias[2]);
      const float o = sigmoid(a[3][b] + bias[3]);
      const float tc = tanhf(row < B ? cs[cur + (size_t)row * H + j] : 0.0f);
      const float gh = (row < B ? ghs[cur + (size_t)row * H + j] : 0.0f) + dh[b];
      const float gc = dc[b] + gh * o * (1.0f - tc * tc);
      const float d_o = gh * tc * o * (1.0f - o);
      const float d_f = gc * cp[b] * f * (1.0f - f);
      const float d_i = gc * g * i * (1.0f - i);
      const float d_g = gc * i * (1.0f - g * g);
      dc[b] = gc * f * keep[b];
      dgT[j * BB + b] = op<BF16>(d_i);
      dgT[(H + j) * BB + b] = op<BF16>(d_f);
      dgT[(2 * H + j) * BB + b] = op<BF16>(d_g);
      dgT[(3 * H + j) * BB + b] = op<BF16>(d_o);
      if (row < B) {
        float* grow = gs_t + (size_t)row * G4;
        grow[j] = d_i;
        grow[H + j] = d_f;
        grow[2 * H + j] = d_g;
        grow[3 * H + j] = d_o;
      }
    }
    __syncthreads();

    // dh_prev[:, j] = (Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[b] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < G4; ++c) {
      const float w = op<BF16>(__ldg(whT_s + (size_t)c * H + j));
      float v[BB];
      load_rows<BB>(dgT + c * BB, v);
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = fmaf(v[b], w, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      dh[b] = acc[b] * keep[b];
      if (t == 0 && b0 + b < B) {
        dh0[((size_t)s * B + b0 + b) * H + j] = dh[b];
        dc0[((size_t)s * B + b0 + b) * H + j] = dc[b];
      }
    }

    // dx_t[b, d] = Σ_c dgates[b, c] Wx[d, c]
    float* dx_t = dx + ((size_t)s * T + t) * B * D;
    for (int e = j; e < BB * D; e += blockDim.x) {
      const int b = e / D, d = e % D, row = b0 + b;
      const float* w = wx_s + (size_t)d * G4;
      float v = 0.0f;
      for (int c = 0; c < G4; ++c) v = fmaf(dgT[c * BB + b], op<BF16>(__ldg(w + c)), v);
      if (row < B) dx_t[(size_t)row * D + d] = v;
    }
    __syncthreads();  // all smem tiles are rewritten next step
  }
}

}  // namespace

extern "C" int lstm_x_fwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* bh,
                          float* hs, float* cs, int S, int T, int B, int D, int H, int bf16,
                          void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const dim3 grid((B + kFwdRows - 1) / kFwdRows, S);
  const size_t smem = (size_t)(H + D) * kFwdRows * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto kernel = lstm_x_fwd_kernel<kFwdRows, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, c0, h0, wx, wh, bh, hs, cs, T, B, D, H);
  } else {
    auto kernel = lstm_x_fwd_kernel<kFwdRows, false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, c0, h0, wx, wh, bh, hs, cs, T, B, D, H);
  }
  return (int)cudaGetLastError();
}

extern "C" int lstm_x_bwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* whT,
                          const float* bh, const float* hs, const float* cs, const float* ghs,
                          float* dx, float* dc0, float* dh0, float* gs, int S, int T, int B,
                          int D, int H, int bf16, void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const dim3 grid((B + kBwdRows - 1) / kBwdRows, S);
  const size_t smem = (size_t)(5 * H + D) * kBwdRows * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto kernel = lstm_x_bwd_kernel<kBwdRows, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, c0, h0, wx, wh, whT, bh, hs, cs, ghs, dx, dc0,
                                  dh0, gs, T, B, D, H);
  } else {
    auto kernel = lstm_x_bwd_kernel<kBwdRows, false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, c0, h0, wx, wh, whT, bh, hs, cs, ghs, dx, dc0,
                                  dh0, gs, T, B, D, H);
  }
  return (int)cudaGetLastError();
}

// The weight-gradient reduction of rnn_wgrad.cuh with the LSTM's gate
// gradients: C = Σ_rows [h_masked | x | 1]ᵀ [di|df|dg|do] = dWh | dWx | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_x_wgrad(const float* xs, const float* resets, const float* h0,
                            const float* hs, const float* gs, float* W, float* C, int S, int T,
                            int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, h0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, stream);
}
