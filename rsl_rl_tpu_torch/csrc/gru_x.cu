// GRU window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming GRU kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   gru_x_fwd    <- _fwd_kernel_x_pair (S=2) and _fwd_kernel_x (S=1)
//   gru_x_bwd    <- _bwd_kernel_x_pair / _bwd_kernel_x: the BPTT chain
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
// on the CUDA cores.
//
// Each entry point launches its kernel on the given stream (gru_x_wgrad two:
// the split-K products, then their fixed-order sum), allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 16;  // batch rows per forward block
constexpr int kBwdRows = 8;   // batch rows per backward block

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

// Reverse-time BPTT. Same grid and thread mapping as the forward; thread j
// carries dh[:, j] in registers. Each step recomputes the gates from
// h = (t == 0 ? carry0 : hs[t-1]) * (1 - reset), writes dr|dz|dn|du to gs,
// and forms dx_t = [dr|dz|dn] Wxᵀ and dh_prev = (g*z + [dr|dz|du] Whᵀ) * keep
// (whT is Wh transposed so that thread j reads a coalesced row per c).
template <int BB, bool BF16>
__global__ void __launch_bounds__(256) gru_x_bwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wx,
    const float* __restrict__ bx, const float* __restrict__ wh,
    const float* __restrict__ whT, const float* __restrict__ bhn,
    const float* __restrict__ hs, const float* __restrict__ ghs,
    float* __restrict__ dx, float* __restrict__ dcarry0, float* __restrict__ gs,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;              // [H][BB]  h operand
  float* xT = hT + H * BB;       // [D][BB]  x operand
  float* dgT = xT + D * BB;      // [3H][BB] dr | dz | du operands
  float* dnT = dgT + 3 * H * BB; // [H][BB]  dn operand
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wx_s = wx + (size_t)s * D * G3;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float* whT_s = whT + (size_t)s * G3 * H;
  const float bxr = bx[(size_t)s * G3 + j];
  const float bxz = bx[(size_t)s * G3 + H + j];
  const float bxn = bx[(size_t)s * G3 + 2 * H + j];
  const float bn = bhn[(size_t)s * H + j];

  float dh[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) dh[b] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    float h[BB], keep[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      float hp = 0.0f;
      keep[b] = 0.0f;
      if (row < B) {
        keep[b] = 1.0f - resets[(size_t)t * B + row];
        hp = t == 0 ? carry0[((size_t)s * B + row) * H + j]
                    : hs[(((size_t)s * T + t - 1) * B + row) * H + j];
      }
      h[b] = hp * keep[b];
      hT[j * BB + b] = op<BF16>(h[b]);
    }
    load_x<BB, BF16>(xs + ((size_t)s * T + t) * B * D, xT, b0, B, D);
    __syncthreads();

    float ar[BB], az[BB], an[BB], cr[BB], cz[BB], cn[BB];
    gate_projections<BB, BF16>(wx_s, wh_s, hT, xT, D, H, j, ar, az, an, cr, cz, cn);

    const float* g_t = ghs + ((size_t)s * T + t) * B * H;
    float* gs_t = gs + ((size_t)s * T + t) * B * 4 * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float r = sigmoid(ar[b] + bxr + cr[b]);
      const float z = sigmoid(az[b] + bxz + cz[b]);
      const float u = cn[b] + bn;
      const float n = tanhf(an[b] + bxn + r * u);
      const float g = (row < B ? g_t[(size_t)row * H + j] : 0.0f) + dh[b];
      const float dz = g * (h[b] - n) * z * (1.0f - z);
      const float dn = g * (1.0f - z) * (1.0f - n * n);
      const float du = dn * r;
      const float dr = dn * u * r * (1.0f - r);
      dh[b] = g * z;
      dgT[j * BB + b] = op<BF16>(dr);
      dgT[(H + j) * BB + b] = op<BF16>(dz);
      dgT[(2 * H + j) * BB + b] = op<BF16>(du);
      dnT[j * BB + b] = op<BF16>(dn);
      if (row < B) {
        float* grow = gs_t + (size_t)row * 4 * H;
        grow[j] = dr;
        grow[H + j] = dz;
        grow[2 * H + j] = dn;
        grow[3 * H + j] = du;
      }
    }
    __syncthreads();

    // dh_prev[:, j] = (g*z + Σ_c dgates[:, c] Wh[j, c]) * keep
    float acc[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[b] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < G3; ++c) {
      const float w = op<BF16>(__ldg(whT_s + (size_t)c * H + j));
      float v[BB];
      load_rows<BB>(dgT + c * BB, v);
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = fmaf(v[b], w, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      dh[b] = (dh[b] + acc[b]) * keep[b];
      if (t == 0 && b0 + b < B) dcarry0[((size_t)s * B + b0 + b) * H + j] = dh[b];
    }

    // dx_t[b, d] = Σ_c [dr|dz|dn][b, c] Wx[d, c]
    float* dx_t = dx + ((size_t)s * T + t) * B * D;
    for (int e = j; e < BB * D; e += blockDim.x) {
      const int b = e / D, d = e % D, row = b0 + b;
      const float* w = wx_s + (size_t)d * G3;
      float a = 0.0f;
      for (int c = 0; c < 2 * H; ++c) a = fmaf(dgT[c * BB + b], op<BF16>(__ldg(w + c)), a);
      for (int c = 0; c < H; ++c) a = fmaf(dnT[c * BB + b], op<BF16>(__ldg(w + 2 * H + c)), a);
      if (row < B) dx_t[(size_t)row * D + d] = a;
    }
    __syncthreads();  // all smem tiles are rewritten next step
  }
}

}  // namespace

extern "C" int gru_x_fwd(const float* xs, const float* resets, const float* carry0,
                         const float* wx, const float* bx, const float* wh, const float* bhn,
                         float* hs, int S, int T, int B, int D, int H, int bf16, void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const dim3 grid((B + kFwdRows - 1) / kFwdRows, S);
  const size_t smem = (size_t)(H + D) * kFwdRows * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto kernel = gru_x_fwd_kernel<kFwdRows, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, carry0, wx, bx, wh, bhn, hs, T, B, D, H);
  } else {
    auto kernel = gru_x_fwd_kernel<kFwdRows, false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, carry0, wx, bx, wh, bhn, hs, T, B, D, H);
  }
  return (int)cudaGetLastError();
}

extern "C" int gru_x_bwd(const float* xs, const float* resets, const float* carry0,
                         const float* wx, const float* bx, const float* wh, const float* whT,
                         const float* bhn, const float* hs, const float* ghs, float* dx,
                         float* dcarry0, float* gs, int S, int T, int B, int D, int H, int bf16,
                         void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const dim3 grid((B + kBwdRows - 1) / kBwdRows, S);
  const size_t smem = (size_t)(5 * H + D) * kBwdRows * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto kernel = gru_x_bwd_kernel<kBwdRows, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, carry0, wx, bx, wh, whT, bhn, hs, ghs, dx,
                                  dcarry0, gs, T, B, D, H);
  } else {
    auto kernel = gru_x_bwd_kernel<kBwdRows, false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, H, smem, st>>>(xs, resets, carry0, wx, bx, wh, whT, bhn, hs, ghs, dx,
                                  dcarry0, gs, T, B, D, H);
  }
  return (int)cudaGetLastError();
}

// The weight-gradient reduction of rnn_wgrad.cuh: C = Σ_rows [h_masked | x | 1]ᵀ
// [dr|dz|dn|du]. W is the caller's scratch of [S,P,M,N] partial sums, P >= 1
// the number of row splits; C [S,M,N] receives their sum.
extern "C" int gru_x_wgrad(const float* xs, const float* resets, const float* carry0,
                           const float* hs, const float* gs, float* W, float* C, int S, int T,
                           int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, carry0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, 1, stream);
}
