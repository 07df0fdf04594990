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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdRows = 16;  // batch rows per forward block
constexpr int kBwdRows = 8;   // batch rows per backward block
constexpr int kTileM = 64, kTileN = 64, kTileK = 16;  // weight-gradient tile
constexpr int kWgradThreads = 256;

template <bool BF16>
__device__ __forceinline__ float op(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// BB consecutive floats of shared memory (16-byte aligned) into registers.
template <int BB>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[BB]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < BB / 4; ++q) {
    const float4 f = p4[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

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

// x_t of the block's BB rows into xT [D][BB] (operand-rounded, zero past B).
template <int BB, bool BF16>
__device__ __forceinline__ void load_x(const float* __restrict__ x_t, float* xT,
                                       int b0, int B, int D) {
  for (int e = threadIdx.x; e < D * BB; e += blockDim.x) {
    const int d = e / BB, b = e % BB, row = b0 + b;
    xT[e] = row < B ? op<BF16>(x_t[(size_t)row * D + d]) : 0.0f;
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

// Split-K partial products W[s,p] = Σ_k A[s,k,:]ᵀ gs[s,k,:] over the rows k of
// split p of the K = T*B rows k = t*B + b, with A = [h_masked (H) | x (D) | 1].
// Grid (N/64, M/64, S*P): one block per 64x64 output tile and split walks its
// rows in order; 256 threads, 4x4 outputs each. In bf16 mode the h and x rows
// use rounded operands; the ones row (the bias sums) adds the gradients
// unrounded.
template <bool BF16>
__global__ void __launch_bounds__(kWgradThreads) gru_x_wgrad_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ hs,
    const float* __restrict__ gs, float* __restrict__ W,
    int T, int B, int D, int H, int P) {
  __shared__ __align__(16) float As[kTileK][kTileM];
  __shared__ __align__(16) float Gs[kTileK][kTileN];
  const int s = blockIdx.z / P;
  const int p = blockIdx.z % P;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int M = H + D + 1;
  const int N = 4 * H;
  const int K = T * B;  // the launcher checks that T*B fits an int
  const int chunk = ((K + P - 1) / P + kTileK - 1) / kTileK * kTileK;
  const int k_begin = p * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* gs_s = gs + (size_t)s * K * N;
  float* part = W + (size_t)blockIdx.z * M * N;  // this split's [M,N] partial

  bool ones_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ones_row[i] = (m0 + ty * 4 + i) == H + D;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < kTileK * kTileM / kWgradThreads; ++q) {
      const int e = tid + q * kWgradThreads;
      const int kk = e / kTileM, mm = e % kTileM;
      const int k = k0 + kk;
      const int m = m0 + mm;
      float a = 0.0f;
      if (k < k_end && m < M) {
        const int t = k / B, b = k - t * B;
        if (m < H) {
          const float hp = t == 0 ? carry0[((size_t)s * B + b) * H + m]
                                  : hs[(((size_t)s * T + t - 1) * B + b) * H + m];
          a = op<BF16>(hp * (1.0f - resets[k]));
        } else if (m < H + D) {
          a = op<BF16>(xs[(((size_t)s * T + t) * B + b) * D + (m - H)]);
        } else {
          a = 1.0f;
        }
      }
      As[kk][mm] = a;
      const int n = n0 + mm;  // kTileN == kTileM
      Gs[kk][mm] = (k < k_end && n < N) ? gs_s[(size_t)k * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      float gr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) gr[q] = op<BF16>(g[q]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][q] = fmaf(a[i], ones_row[i] ? g[q] : gr[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (m < M && n < N) part[(size_t)m * N + n] = acc[i][q];
    }
  }
}

// C[s] = Σ_p W[s,p] in split order 0..P-1: the second, fixed-order pass of the
// split-K reduction, so the weight gradients are the same on every run.
__global__ void gru_x_wgrad_sum_kernel(const float* __restrict__ W, float* __restrict__ C,
                                       int S, int P, int MN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * MN) return;
  const int s = (int)(i / MN), e = (int)(i % MN);
  const float* w = W + (size_t)s * P * MN + e;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += w[(size_t)p * MN];
  C[i] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_dims(int S, int T, int B, int D, int H) {
  return S < 0 || T < 0 || B < 0 || D < 1 || H < 1 || H > 256 ||
         (long long)T * B > 0x7fffffffLL;
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

// W is the caller's scratch of [S,P,M,N] partial sums, P >= 1 the number of
// row splits; C [S,M,N] receives their sum.
extern "C" int gru_x_wgrad(const float* xs, const float* resets, const float* carry0,
                           const float* hs, const float* gs, float* W, float* C, int S, int T,
                           int B, int D, int H, int P, int bf16, void* stream) {
  if (bad_dims(S, T, B, D, H) || P < 1 || (long long)S * P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const int M = H + D + 1, N = 4 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, S * P);
  if (bf16) {
    gru_x_wgrad_kernel<true><<<grid, kWgradThreads, 0, st>>>(xs, resets, carry0, hs, gs, W,
                                                             T, B, D, H, P);
  } else {
    gru_x_wgrad_kernel<false><<<grid, kWgradThreads, 0, st>>>(xs, resets, carry0, hs, gs, W,
                                                              T, B, D, H, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)S * M * N;
  gru_x_wgrad_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(W, C, S, P, M * N);
  return (int)cudaGetLastError();
}
