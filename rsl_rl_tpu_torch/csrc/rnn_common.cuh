// Device helpers shared by the recurrent replay kernels (gru_x.cu, lstm_x.cu).
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
