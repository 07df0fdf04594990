// Weight-gradient reduction shared by the GRU and LSTM replays (sm_90a).
//
//   C[s] = Σ_k A[s,k,:]ᵀ gs[s,k,:],   A = [h_masked (H) | x (D) | 1],
//
// over the K = T*B rows k = t*B + b, with h_masked = (t == 0 ? carry0 :
// hs[t-1]) * (1 - resets[t]) and gs [S,T,B,4H] the per-step gate gradients
// that the BPTT kernel wrote. C [S,H+D+1,4H] holds dWh | dWx | the bias sums:
// for the GRU, gs = dr|dz|dn|du; for the LSTM, gs = di|df|dg|do and C is
// dWh | dWx | dbh directly. In bf16 mode the h and x rows use rounded
// operands and the gradients are rounded too; the ones row (the bias sums)
// adds the gradients unrounded, like the JAX package's jnp.sum(dgates).
// resets is [T,B], shared by the streams (the x kernels), or [S,T,B], one
// mask per stream (the xproj kernels, whose streams are seeds). D = 0 (no
// x columns, xs unused): the xproj kernels' C = dWh | the bias sums.
//
// Split-K: the rows are cut into P splits; each block owns one 64x64 output
// tile of one split and walks its rows in order into its own partial tile of
// W [S,P,H+D+1,4H]; a second kernel adds the partials in split order. No
// atomics, so the gradients are the same on every run.
#pragma once

#include "rnn_common.cuh"

namespace {

constexpr int kTileM = 64, kTileN = 64, kTileK = 16;  // weight-gradient tile
constexpr int kWgradThreads = 256;

// Grid (N/64, M/64, S*P): one block per 64x64 output tile and split walks its
// rows in order; 256 threads, 4x4 outputs each.
template <bool BF16>
__global__ void __launch_bounds__(kWgradThreads) rnn_wgrad_kernel(
    const float* __restrict__ xs, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ hs,
    const float* __restrict__ gs, float* __restrict__ W,
    int T, int B, int D, int H, int P, int per_stream_resets) {
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
  const float* resets_s = resets + (per_stream_resets ? (size_t)s * K : 0);
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
          a = op<BF16>(hp * (1.0f - resets_s[k]));
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
__global__ void rnn_wgrad_sum_kernel(const float* __restrict__ W, float* __restrict__ C,
                                     int S, int P, int MN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * MN) return;
  const int s = (int)(i / MN), e = (int)(i % MN);
  const float* w = W + (size_t)s * P * MN + e;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += w[(size_t)p * MN];
  C[i] = acc;
}

// Launches both passes on the stream. W is the caller's scratch of [S,P,M,N]
// partial sums, P >= 1 the number of row splits; C [S,M,N] receives their sum.
int rnn_wgrad_launch(const float* xs, const float* resets, const float* carry0,
                     const float* hs, const float* gs, float* W, float* C, int S, int T,
                     int B, int D, int H, int P, int bf16, int per_stream_resets,
                     void* stream) {
  if (bad_dims(S, T, B, D, H) || P < 1 || (long long)S * P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const int M = H + D + 1, N = 4 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, S * P);
  if (bf16) {
    rnn_wgrad_kernel<true><<<grid, kWgradThreads, 0, st>>>(xs, resets, carry0, hs, gs, W,
                                                           T, B, D, H, P, per_stream_resets);
  } else {
    rnn_wgrad_kernel<false><<<grid, kWgradThreads, 0, st>>>(xs, resets, carry0, hs, gs, W,
                                                            T, B, D, H, P, per_stream_resets);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)S * M * N;
  rnn_wgrad_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(W, C, S, P, M * N);
  return (int)cudaGetLastError();
}

}  // namespace
