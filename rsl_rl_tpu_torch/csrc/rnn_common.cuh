// Device helpers shared by the recurrent replay kernels (gru_x.cu, lstm_x.cu,
// gru_xp.cu, lstm_xp.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// A matmul operand: rounded to bf16 (round to nearest even) in bf16 mode.
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

// x_t of the block's BB rows into xT [D][BB] (operand-rounded, zero past B).
template <int BB, bool BF16>
__device__ __forceinline__ void load_x(const float* __restrict__ x_t, float* xT,
                                       int b0, int B, int D) {
  for (int e = threadIdx.x; e < D * BB; e += blockDim.x) {
    const int d = e / BB, b = e % BB, row = b0 + b;
    xT[e] = row < B ? op<BF16>(x_t[(size_t)row * D + d]) : 0.0f;
  }
}

// acc[q][b] = Σ_k vT[k][b] W[k, q*H + j] for the NG column blocks q of
// thread j: vT [K][BB] in shared memory holds (rounded) operands of BB rows,
// W [K, NG*H] row-major in global memory (L2), one coalesced row per k
// across the block's threads.
template <int NG, int BB, bool BF16>
__device__ __forceinline__ void gate_matvec(const float* __restrict__ w, const float* vT,
                                            int K, int H, int j, float (&acc)[NG][BB]) {
  const int N = NG * H;
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[q][b] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* wk = w + (size_t)k * N + j;
    float wq[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) wq[q] = op<BF16>(__ldg(wk + q * H));
    float v[BB];
    load_rows<BB>(vT + k * BB, v);
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[q][b] = fmaf(v[b], wq[q], acc[q][b]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// D = 0: no input columns (the xproj kernels and their weight gradients).
bool bad_dims(int S, int T, int B, int D, int H) {
  return S < 0 || T < 0 || B < 0 || D < 0 || H < 1 || H > 256 ||
         (long long)T * B > 0x7fffffffLL;
}

}  // namespace
