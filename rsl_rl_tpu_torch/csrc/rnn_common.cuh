// Device helpers shared by the recurrent replay kernels (gru_x.cu, lstm_x.cu,
// gru_xp.cu, lstm_xp.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Four floats at p (16-byte aligned), or zeros where !ok.
__device__ __forceinline__ void load4(const float* p, bool ok, float (&v)[4]) {
  if (ok) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
  }
}

// Asynchronous copies global -> shared (sm_80+): 16 or 4 bytes, zero-filled
// where !ok (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ---------------------------------------------------------------- tile GEMM steps
// The tiled kernels (rnn_wgrad.cuh, lstm_x.cu's backward) stream fp32 tiles
// into shared memory with cp.async and multiply them on the CUDA cores (fp32
// mode) or on the tensor cores (bf16 mode), rounding and packing each mma
// fragment register from two fp32 values as they read it.

// Two operands rounded to bf16 (round to nearest even), packed low | high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d fp32.
// For lane (g = lane/4, q = lane%4): a holds rows g, g+8 x k-pairs (2q, 2q+1),
// (2q+8, 2q+9) as {(g, 2q), (g+8, 2q), (g, 2q+8), (g+8, 2q+8)}; b holds
// column g x k-pairs (2q, 2q+1), (2q+8, 2q+9); d rows g (elements 0, 1) and
// g+8 (2, 3), columns 2q, 2q+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k of an 8x8 fp32 register tile in a 128x128 block of 16x16 threads:
// thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} (index
// i < 4 and i >= 4 of acc), columns likewise with tx. The split halves keep
// the 16 column loads of a quarter warp on distinct banks. b returns the
// column operands.
__device__ __forceinline__ void fma_step_8x8(float (&acc)[8][8], const float* a_row,
                                             const float* b_row, int ty, int tx, float (&b)[8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(a_row + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(a_row + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(b_row + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(b_row + 64 + tx * 4);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Row (or column) of an 8x8 tile's index i: see fma_step_8x8.
__device__ __forceinline__ int tile8_index(int t, int i) { return (i < 4 ? 0 : 60) + t * 4 + i; }

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
