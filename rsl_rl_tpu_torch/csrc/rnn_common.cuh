// Device helpers shared by the recurrent replay kernels (gru_x.cu, lstm_x.cu,
// gru_xp.cu, lstm_xp.cu): operand rounding, cp.async and mma steps, the gate
// tile of the backwards' phase 1 and of the cluster forward, the launch of the
// kernels that keep one thread per hidden column, and the shape checks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// The kernels that keep one thread per hidden column (the GRU forward, the
// xproj kernels) take H <= 256 that way, in blocks of H threads. Above, a
// second kernel of each gives a thread kWideCols columns, j and j +
// blockDim.x, in blocks of half the rows. The one-column kernels are not
// instances of the wide ones: compiled as such, they took other registers
// and times at H <= 256, slower for some. Thread x's columns, each clamped
// into range (on[c] says which are).
constexpr int kWideCols = 2;
__device__ __forceinline__ void wide_columns(int H, int (&j)[kWideCols], bool (&on)[kWideCols]) {
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    const int jc = threadIdx.x + c * blockDim.x;
    on[c] = jc < H;
    j[c] = on[c] ? jc : 0;
  }
}

// gate_matvec for the thread's kWideCols columns j: acc[c][q][b].
template <int NG, int BB, bool BF16>
__device__ __forceinline__ void gate_matvec_wide(const float* __restrict__ w, const float* vT, int K, int H,
                                                 const int (&j)[kWideCols],
                                                 float (&acc)[kWideCols][NG][BB]) {
  const int N = NG * H;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[c][q][b] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* wk = w + (size_t)k * N;
    float wq[kWideCols][NG];
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int q = 0; q < NG; ++q) wq[c][q] = op<BF16>(__ldg(wk + q * H + j[c]));
    float v[BB];
    load_rows<BB>(vT + k * BB, v);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int b = 0; b < BB; ++b) acc[c][q][b] = fmaf(v[b], wq[c][q], acc[c][q][b]);
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
// The tiled kernels (rnn_wgrad.cuh, rnn_bwd.cuh, lstm_x_fwd) stream fp32 tiles
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

// ------------------------------------------------------------- the gate tile
// act([h_masked | x] @ W + b) over kTM rows x 128 gate columns, 256 threads:
// the gate recompute of the backwards (rnn_bwd.cuh, phase 1) and each step of
// lstm_x_fwd. The rows of [h_masked | x] stream through a ring of k-tiles of
// kGateK operand columns in shared memory by cp.async, as fp32 ([row][k],
// gate_lda() floats a row): the h of row (t, b) is hs[t-1] (h0 at t = 0), masked
// by keep_t after it lands, then x_t. W comes as a GateB* view of shared
// memory. fp32 mode: thread (ty, tx) = (tid / 16, tid % 16) owns the rows
// gate_row_of(ty, i) and the columns tile8_index(tx, j) (8x8 at kTM = 128,
// 4x8 at 64, 2x8 at 32); bf16 mode: warp (wm, wn) = (warp / 4, warp % 4) owns rows
// wm*kTM/2.. (kTM/32 m16 tiles) x columns wn*32.. (four n8 tiles) of
// mma.m16n8k16, fragments rounded and packed as they are read.

constexpr int kGateK = 16;       // operand columns of a k-tile
constexpr int kGateCols = 128;   // gate columns of a tile
template <bool BF16>
__host__ __device__ constexpr int gate_lda() { return BF16 ? kGateK + 8 : kGateK + 4; }

template <int kTM, bool BF16>
using GateAcc = typename std::conditional<BF16, float[kTM / 32][4][4], float[kTM / 16][8]>::type;

// fp32 mode: the tile row of thread row ty's index i
template <int kTM>
__device__ __forceinline__ int gate_row_of(int ty, int i) {
  return kTM == 128 ? tile8_index(ty, i) : ty * (kTM / 16) + i;
}

// A weight tile of fp32 rows in shared memory: p[k][n], ld floats a row.
struct GateB32 {
  const float* p;
  int ld;
  __device__ __forceinline__ const float* row(int kk) const { return p + kk * ld; }
  __device__ __forceinline__ void frag(int q, int n, uint32_t& b0, uint32_t& b1) const {
    const float* bc = p + 2 * q * ld + n;
    b0 = pack_bf16(bc[0], bc[ld]);
    b1 = pack_bf16(bc[8 * ld], bc[9 * ld]);
  }
};
// A weight tile of bf16 k-pairs in shared memory, packed once: p[kp][n] holds
// rows 2kp (low half) and 2kp + 1 of column n, ld words a row.
struct GateB16 {
  const uint32_t* p;
  int ld;
  __device__ __forceinline__ void frag(int q, int n, uint32_t& b0, uint32_t& b1) const {
    b0 = p[q * ld + n];
    b1 = p[(q + 4) * ld + n];
  }
};

// The [h | x] rows a thread copies into the ring: rows ar + 64*r of the tile
// (ar = tid / 4), operand columns (tid % 4)*4.. of each k-tile. The copies
// fill whole groups of 64 rows of a stage: a 32-row tile's 64 (the last 32
// zeros), a 96-row tile's 128 and a 160-row tile's 192 (kPartial: the rows
// past the tile are none).
template <int kTM>
struct GateRows {
  static constexpr int kN = kTM >= 64 ? (kTM + 63) / 64 : 1;
  static constexpr bool kPartial = kTM > 64 && kTM % 64 != 0;
  const float* hrow[kN];
  const float* xrow[kN];
  float keep[kN];
  bool valid[kN];
  // row r of the tile is (t, b) of stream s, or none (!ok)
  __device__ __forceinline__ void set(int r, bool ok, int s, int t, int b, const float* h0, const float* hs,
                                      const float* xs, const float* resets, int T, int B, int D, int H) {
    valid[r] = ok;
    keep[r] = ok ? 1.0f - resets[(size_t)t * B + b] : 1.0f;
    hrow[r] = t == 0 ? h0 + ((size_t)s * B + b) * H : hs + (((size_t)s * T + t - 1) * B + b) * H;
    xrow[r] = D > 0 ? xs + (((size_t)s * T + t) * B + b) * D : nullptr;
  }
};

// The copies of k-tile kt into As: operand columns [0, H) from the h row and
// [x0, x1) from the x row (x0 >= H), zero between and past them and past the
// rows (dummy is any valid address, never read).
template <int kTM, bool BF16>
__device__ __forceinline__ void gate_issue_a(const GateRows<kTM>& rows, float* As, int kt, int H, int x0,
                                             int x1, const float* dummy) {
  constexpr int kLdA = gate_lda<BF16>();
  const int ar = threadIdx.x >> 2, ak = (threadIdx.x & 3) * 4;
  const int k = kt * kGateK + ak;
  const bool h_vec = (H & 3) == 0;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    float* dst = As + (ar + 64 * r) * kLdA + ak;
    if (h_vec && k + 3 < H) {
      cp_async16(dst, rows.valid[r] ? rows.hrow[r] + k : dummy, rows.valid[r]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k + i;
        const bool is_h = rows.valid[r] && kc < H, is_x = rows.valid[r] && kc >= x0 && kc < x1;
        cp_async4(dst + i, is_h ? rows.hrow[r] + kc : is_x ? rows.xrow[r] + (kc - x0) : dummy, is_h || is_x);
      }
    }
  }
}

// The operand columns [h | x] with x right after h: K = H + D.
template <int kTM, bool BF16>
__device__ __forceinline__ void gate_issue_a(const GateRows<kTM>& rows, float* As, int kt, int H, int K,
                                             const float* dummy) {
  gate_issue_a<kTM, BF16>(rows, As, kt, H, H, K, dummy);
}

// The h this thread copied into k-tile kt, times its row's keep (after the
// copies landed, before the tile's barrier).
template <int kTM, bool BF16>
__device__ __forceinline__ void gate_fix_keep(const GateRows<kTM>& rows, float* As, int kt, int H) {
  constexpr int kLdA = gate_lda<BF16>();
  const int ar = threadIdx.x >> 2, ak = (threadIdx.x & 3) * 4;
  const int k = kt * kGateK + ak;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    if (rows.keep[r] == 1.0f) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < H) As[(ar + 64 * r) * kLdA + ak + i] *= rows.keep[r];
  }
}

// acc += As (kTM x kGateK) @ Bt (kGateK x 128): one k-tile.
template <int kTM, bool BF16, class Bt>
__device__ __forceinline__ void gate_tile_step(GateAcc<kTM, BF16>& acc, const float* As, const Bt& bt) {
  constexpr int kLdA = gate_lda<BF16>();
  const int tid = threadIdx.x;
  if constexpr (BF16) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
    const int wm = warp >> 2, wn = warp & 3;
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) bt.frag(q, wn * 32 + 8 * j + g, b[j][0], b[j][1]);
#pragma unroll
    for (int i = 0; i < kTM / 32; ++i) {
      const float* ar0 = As + (wm * (kTM / 2) + 16 * i + g) * kLdA + 2 * q;
      const float2 x0 = *reinterpret_cast<const float2*>(ar0);
      const float2 x1 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA);
      const float2 x2 = *reinterpret_cast<const float2*>(ar0 + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA + 8);
      const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                              pack_bf16(x3.x, x3.y)};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
    }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int kk = 0; kk < kGateK; ++kk) {
      float av[kTM / 16];
#pragma unroll
      for (int i = 0; i < kTM / 16; ++i) av[i] = As[gate_row_of<kTM>(ty, i) * kLdA + kk];
      const float* br = bt.row(kk);
      const float4 b0 = *reinterpret_cast<const float4*>(br + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 64 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launches a kernel that keeps one thread per hidden column over ceil(B /
// rows) x S blocks: one (H <= 256: blocks of H threads and BB rows) or two
// (two columns a thread: ceil(H/2) threads, BB/2 rows), with smem_per_row
// floats of shared memory a block row.
template <class K1, class K2, class... Args>
cudaError_t launch_columns(K1 one, K2 two, int BB, int S, int B, int H, int smem_per_row, cudaStream_t st,
                           Args... args) {
  const bool wide = H > 256;
  const int rows = wide ? BB / 2 : BB;
  const size_t smem = (size_t)smem_per_row * rows * sizeof(float);
  const dim3 grid((B + rows - 1) / rows, S);
  cudaError_t err;
  if (wide) {
    if ((err = allow_smem(two, smem)) != cudaSuccess) return err;
    two<<<grid, (H + 1) / 2, smem, st>>>(args...);
  } else {
    if ((err = allow_smem(one, smem)) != cudaSuccess) return err;
    one<<<grid, H, smem, st>>>(args...);
  }
  return cudaGetLastError();
}

// The most hidden columns a kernel takes (the JAX package's single-stream
// kernels take up to 512 within their VMEM budget).
constexpr int kMaxHidden = 512;

// D = 0: no input columns (the xproj kernels and their weight gradients).
bool bad_dims(int S, int T, int B, int D, int H) {
  return S < 0 || T < 0 || B < 0 || D < 0 || H < 1 || H > kMaxHidden ||
         (long long)T * B > 0x7fffffffLL;
}

}  // namespace
