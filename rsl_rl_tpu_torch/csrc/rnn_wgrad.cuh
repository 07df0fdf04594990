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
// Replaces the weight-gradient accumulation of the Pallas backward kernels
// (rsl_rl_tpu/ops/pallas_rnn.py, the dW scratch updates of _bwd_kernel_x,
// _bwd_kernel_x_pair, _lstm_bwd_kernel_x, _lstm_bwd_kernel_x_pair,
// _bwd_kernel and _lstm_bwd_kernel), which carry the sums across the TPU's
// sequential grid.
//
// What bounds it: 2*K*(H+D)*4H operations against reading gs once (27 GFLOP
// and 0.2 GB for the main path's two streams at T=24, B=1024, H=256, D=15):
// fp32 operations on the CUDA cores; in bf16 mode the tensor cores do them
// 15x faster and moving gs through the block bounds it. An H100 SM does 128
// fp32 FMAs a clock but moves 128 bytes a clock out of shared memory, so an
// 8x8 register tile (four 16-byte loads per 64 FMAs) is as much bound by
// shared memory as by FMAs. The design:
// - A block owns a 256x128 tile of C (rows of [h | x], columns of gs) and one
//   split of the rows, one block an SM; a thread owns a 16x8 register tile
//   (six 16-byte shared loads per 128 FMAs) or, in bf16 mode, a warp owns
//   64x64 of mma.m16n8k16 tiles with fp32 accumulators. At H=256 one row
//   tile covers h, so gs is read once.
// - k-tiles of 16 rows, double-buffered in shared memory: each thread loads
//   the next tile's rows into registers (16-byte loads; the t, b, resets and
//   carry row of a row are worked out once per row, not per element) while
//   the current tile computes, then stores them, masked and (bf16) rounded
//   and packed, to the other buffer: one barrier a tile.
// - No wasted tiles: the row tiles cover the H+D operand rows; up to 16 rows
//   beyond the last full tile (the D = 15 x rows of the main path) ride as
//   extra rows on the blocks of the first row tile, which multiply them by
//   the gs columns they already hold, and those blocks take the ones row as
//   a column sum of the staged, unrounded gs. For the GRU, tiles whose
//   products the wrappers drop (h rows x dn, x rows x du) are not computed
//   and are written as zeros: C keeps its layout.
// - Split-K chosen by the caller (ops/rnn_common.py wgrad_plan) from the SM
//   count and the tile grid, so that every main-path shape fills a wave;
//   each split writes its own partial tile of W [S,P,H+D+1,4H], and a second
//   kernel adds the partials in split order (with one split the first kernel
//   writes C). No atomics, so the gradients are the same on every run.
#pragma once

#include <type_traits>

#include "rnn_common.cuh"

namespace {

constexpr int kWgTile = 128;         // gate-gradient columns of a block's tile of C
constexpr int kWgTail = 16;          // most extra rows a first-row-tile block takes
constexpr int kWgLd = kWgTile + 4;   // floats a row of the gs tile
constexpr int kWgLdT = kWgTail + 4;  // floats a row of the extra rows' tile

// The block by mode. fp32: 128 operand rows x 128 columns, 256 threads of
// 8x8 register tiles, two blocks an SM, a ring of six 16-row k-tiles. bf16:
// the tensor cores leave moving the fp32 tiles through L2 as the bound, so a
// block takes 256 operand rows (all of h at H=256: gs is read once) with 512
// threads, 16 warps of 64x32 mma tiles, one block an SM, a ring of two
// 32-row k-tiles (a deeper tile spreads its fixed cost: copies, masking,
// barrier).
template <bool BF16>
struct WgradCfg {
  static constexpr int kTileM = BF16 ? 256 : 128;
  static constexpr int kThreads = BF16 ? 512 : 256;
  static constexpr int kMinBlocks = BF16 ? 1 : 2;
  static constexpr int kK = BF16 ? 32 : 16;
  static constexpr int kStages = BF16 ? 2 : 6;
  static constexpr int kLdA = kTileM + 4;
  static constexpr int kStageFloats = kK * (kLdA + kWgLd + kWgLdT);
  static constexpr int kCopyRows = kThreads / 32;           // k-tile rows one pass of copies covers
  static constexpr int kRowsPer = kK / kCopyRows;           // k-tile rows a thread copies
  static constexpr int kSumParts = kThreads / kWgTile;      // threads a column sum is split over
  static constexpr int kSmemBytes = (kStages * kStageFloats + kSumParts * kWgTile) * 4;
};

// Row tiles of the H+D operand rows: full tiles and a tail of at most kWgTail
// rows, or ceil((H+D)/tile) tiles and no tail (ops/rnn_common.py wgrad_plan
// mirrors this rule).
void wgrad_row_tiles(int M, int tile, int* m_tiles, int* tail) {
  if (M >= tile && M % tile <= kWgTail) {
    *m_tiles = M / tile;
    *tail = M % tile;
  } else {
    *m_tiles = (M + tile - 1) / tile;
    *tail = 0;
  }
}

struct WgradArgs {
  const float* xs;
  const float* resets;
  const float* carry0;
  const float* hs;
  const float* gs;
  float* W;
  int T, B, D, H, P, m_tiles, tail, per_stream_resets, gru;
};

// Copies element m of A in row k (t, b) into dst: the carry row's h (to be
// multiplied by keep in place), x, or zero past the operand rows and K.
__device__ __forceinline__ void wgrad_copy_a(const WgradArgs& a, const float* hrow, const float* xrow,
                                             bool valid, int m, float* dst) {
  const bool is_h = valid && m < a.H, is_x = valid && m >= a.H && m < a.H + a.D;
  cp_async4(dst, is_h ? hrow + m : is_x ? xrow + (m - a.H) : a.gs, is_h || is_x);
}

// Grid (ceil(4H/128), m_tiles, S*P), WgradCfg<BF16>::kThreads threads.
template <bool BF16>
__global__ void __launch_bounds__(WgradCfg<BF16>::kThreads, WgradCfg<BF16>::kMinBlocks)
    rnn_wgrad_kernel(const WgradArgs a) {
  using Cfg = WgradCfg<BF16>;
  constexpr int kTileM = Cfg::kTileM, kK = Cfg::kK, kStages = Cfg::kStages, kLdA = Cfg::kLdA;
  extern __shared__ __align__(16) float wg_smem[];  // [stage][A | gs | extra rows], column sums
  float* const smSum = wg_smem + kStages * Cfg::kStageFloats;  // [kSumParts][128]

  const int tid = threadIdx.x;
  const int s = blockIdx.z / a.P, p = blockIdx.z % a.P;
  const int M = a.H + a.D, N = 4 * a.H, K = a.T * a.B;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kWgTile;
  const int tail0 = a.m_tiles * kTileM;  // the first extra row
  const bool extras = blockIdx.y == 0;   // takes the extra rows and the ones row
  bool main_on = true, tail_on = extras && a.tail > 0;
  if (a.gru) {  // the wrappers drop h rows x dn and x rows x du
    const int m_end = min(m0 + kTileM, M), n_end = min(n0 + kWgTile, N);
    if (n0 >= 2 * a.H && n_end <= 3 * a.H && m_end <= a.H) main_on = false;
    if (n0 >= 3 * a.H && m0 >= a.H) main_on = false;
    if (n0 >= 3 * a.H && tail0 >= a.H) tail_on = false;
  }
  const int chunk = ((K + a.P - 1) / a.P + kK - 1) / kK * kK;
  const int k_begin = min(K, p * chunk);
  const int k_end = min(K, k_begin + chunk);
  const int n_kt = (k_end - k_begin + kK - 1) / kK;
  const float* gs_s = a.gs + (size_t)s * K * N;
  const float* resets_s = a.resets + (a.per_stream_resets ? (size_t)s * K : 0);
  const bool h_vec = (a.H & 3) == 0;

  // copies: rows cr + kCopyRows*r of a k-tile, columns c4..c4+3 (of each 128
  // of the A tile) and column lane of the extra rows' tile; this thread
  // multiplies the h elements it copied by their row's keep once they are in
  const int cr = tid >> 5, lane = tid & 31, c4 = lane * 4;
  auto tiles = [&](int kt) {
    float* As = wg_smem + (kt % kStages) * Cfg::kStageFloats;
    return As;
  };
  auto issue = [&](int kt) {
    float* As = tiles(kt);
    float* Gs = As + kK * kLdA;
    float* Ts = Gs + kK * kWgLd;
#pragma unroll
    for (int r = 0; r < Cfg::kRowsPer; ++r) {
      const int row = cr + Cfg::kCopyRows * r, k = k_begin + kt * kK + row;
      const bool valid = k < k_end;
      const int kk = valid ? k : k_begin;
      const int t = kk / a.B, b = kk - t * a.B;
      const float* hrow = t == 0 ? a.carry0 + ((size_t)s * a.B + b) * a.H
                                 : a.hs + (((size_t)s * a.T + t - 1) * a.B + b) * a.H;
      const float* xrow = a.D > 0 ? a.xs + (((size_t)s * a.T + t) * a.B + b) * a.D : nullptr;
      const bool g_ok = valid && n0 + c4 < N;
      cp_async16(Gs + row * kWgLd + c4, g_ok ? gs_s + (size_t)kk * N + n0 + c4 : a.gs, g_ok);
      if (main_on) {
#pragma unroll
        for (int h = 0; h < kTileM / 128; ++h) {
          const int m = m0 + 128 * h + c4;
          float* dst = As + row * kLdA + 128 * h + c4;
          if (h_vec && m + 3 < a.H) {
            cp_async16(dst, valid ? hrow + m : a.gs, valid);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) wgrad_copy_a(a, hrow, xrow, valid, m + i, dst + i);
          }
        }
      }
      if (tail_on && lane < kWgTail) wgrad_copy_a(a, hrow, xrow, valid, tail0 + lane, Ts + row * kWgLdT + lane);
    }
  };
  auto keep_of = [&](int kt, float (&keep)[Cfg::kRowsPer]) {
#pragma unroll
    for (int r = 0; r < Cfg::kRowsPer; ++r) {
      const int k = k_begin + kt * kK + cr + Cfg::kCopyRows * r;
      keep[r] = k < k_end ? 1.0f - resets_s[k] : 1.0f;
    }
  };
  auto fix_keep = [&](int kt, const float (&keep)[Cfg::kRowsPer]) {
    float* As = tiles(kt);
    float* Ts = As + kK * (kLdA + kWgLd);
#pragma unroll
    for (int r = 0; r < Cfg::kRowsPer; ++r) {
      if (keep[r] == 1.0f) continue;
      const int row = cr + Cfg::kCopyRows * r;
      if (main_on) {
#pragma unroll
        for (int h = 0; h < kTileM / 128; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (m0 + 128 * h + c4 + i < a.H) As[row * kLdA + 128 * h + c4 + i] *= keep[r];
      }
      if (tail_on && lane < kWgTail && tail0 + lane < a.H) Ts[row * kWgLdT + lane] *= keep[r];
    }
  };

  // the ones row: column cs_col of the gs tile, its share of the tile's rows
  constexpr int kSumRows = kK / Cfg::kSumParts;
  const int cs_col = tid & (kWgTile - 1), cs_row0 = (tid >> 7) * kSumRows;
  float colsum = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) issue(st);
    cp_async_commit();
  }
  float keep_next[Cfg::kRowsPer];
  keep_of(0, keep_next);

  float* part = a.W + (size_t)blockIdx.z * (M + 1) * N;  // this split's [M+1, N] partial
  const int warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // bf16: warp tile rows wm*64.., columns wn*32..
  const int ty = tid >> 4, tx = tid & 15;   // fp32: thread tile, see fma_step_8x8
  // accumulators: bf16 acc[m16 tile][n8 tile][4] and tacc[4] (mma's C layout,
  // see mma_bf16); fp32 acc[8][8] and tacc[8] (fma_step_8x8)
  typename std::conditional<BF16, float[4][4][4], float[8][8]>::type acc = {};
  float tacc[BF16 ? 4 : 8] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    float keep[Cfg::kRowsPer];
#pragma unroll
    for (int r = 0; r < Cfg::kRowsPer; ++r) keep[r] = keep_next[r];
    fix_keep(kt, keep);
    __syncthreads();  // tile kt is in and masked; the stage refilled below was read at kt - 1
    if (kt + kStages - 1 < n_kt) issue(kt + kStages - 1);
    cp_async_commit();
    if (kt + 1 < n_kt) keep_of(kt + 1, keep_next);
    const float* As = tiles(kt);
    const float* Gs = As + kK * kLdA;
    const float* Ts = Gs + kK * kWgLd;
    if (extras) {
#pragma unroll
      for (int r = 0; r < kSumRows; ++r) colsum += Gs[(cs_row0 + r) * kWgLd + cs_col];
    }
    if constexpr (BF16) {
      // fragments packed from the fp32 tiles: k-pairs (2q, 2q+1) and (2q+8, 2q+9)
#pragma unroll
      for (int k16 = 0; k16 < kK; k16 += 16) {
        uint32_t b[4][2];
        if (main_on || tail_on) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* gc = Gs + (k16 + 2 * q) * kWgLd + wn * 32 + 8 * j + g;
            b[j][0] = pack_bf16(gc[0], gc[kWgLd]);
            b[j][1] = pack_bf16(gc[8 * kWgLd], gc[9 * kWgLd]);
          }
        }
        if (main_on) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* ac = As + (k16 + 2 * q) * kLdA + wm * 64 + 16 * i + g;
            const uint32_t af[4] = {pack_bf16(ac[0], ac[kLdA]), pack_bf16(ac[8], ac[kLdA + 8]),
                                    pack_bf16(ac[8 * kLdA], ac[9 * kLdA]),
                                    pack_bf16(ac[8 * kLdA + 8], ac[9 * kLdA + 8])};
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
          }
        }
        if (tail_on) {  // the extra rows: warp wm of a warp column takes its n8 tile wm
          const float* tc = Ts + (k16 + 2 * q) * kWgLdT + g;
          const uint32_t af[4] = {pack_bf16(tc[0], tc[kWgLdT]), pack_bf16(tc[8], tc[kWgLdT + 8]),
                                  pack_bf16(tc[8 * kWgLdT], tc[9 * kWgLdT]),
                                  pack_bf16(tc[8 * kWgLdT + 8], tc[9 * kWgLdT + 8])};
          uint32_t b0 = b[0][0], b1 = b[0][1];  // selects, not a runtime index: b stays in registers
#pragma unroll
          for (int j = 1; j < 4; ++j) {
            b0 = wm == j ? b[j][0] : b0;
            b1 = wm == j ? b[j][1] : b1;
          }
          mma_bf16(tacc, af, b0, b1);
        }
      }
    } else if (main_on && !tail_on) {  // the common case, without the per-k tests
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        float b[8];
        fma_step_8x8(acc, As + kk * kLdA, Gs + kk * kWgLd, ty, tx, b);
      }
    } else {
      if (main_on || tail_on) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          float b[8];
          if (main_on) {
            fma_step_8x8(acc, As + kk * kLdA, Gs + kk * kWgLd, ty, tx, b);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) b[j] = Gs[kk * kWgLd + tile8_index(tx, j)];
          }
          if (tail_on) {  // extra row ty, the same columns
            const float tv = Ts[kk * kWgLdT + ty];
#pragma unroll
            for (int j = 0; j < 8; ++j) tacc[j] = fmaf(tv, b[j], tacc[j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm * 64 + 16 * i + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + 8 * j + 2 * q;
        if (col >= N) continue;
        if (row < M) *reinterpret_cast<float2*>(part + (size_t)row * N + col) = make_float2(acc[i][j][0], acc[i][j][1]);
        if (row + 8 < M) {
          *reinterpret_cast<float2*>(part + (size_t)(row + 8) * N + col) = make_float2(acc[i][j][2], acc[i][j][3]);
        }
      }
    }
    const int col = n0 + wn * 32 + 8 * wm + 2 * q;
    if (extras && col < N) {
      if (g < a.tail) *reinterpret_cast<float2*>(part + (size_t)(tail0 + g) * N + col) = make_float2(tacc[0], tacc[1]);
      if (g + 8 < a.tail) {
        *reinterpret_cast<float2*>(part + (size_t)(tail0 + g + 8) * N + col) = make_float2(tacc[2], tacc[3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + tile8_index(ty, i);
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + tile8_index(tx, 4 * h);
        if (col < N) {
          *reinterpret_cast<float4*>(part + (size_t)row * N + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
    }
    if (extras && ty < a.tail) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + tile8_index(tx, 4 * h);
        if (col < N) {
          *reinterpret_cast<float4*>(part + (size_t)(tail0 + ty) * N + col) =
              make_float4(tacc[4 * h], tacc[4 * h + 1], tacc[4 * h + 2], tacc[4 * h + 3]);
        }
      }
    }
  }
  if (extras) {  // the ones row: column sums of the unrounded gs, in a fixed order
    smSum[(tid >> 7) * kWgTile + cs_col] = colsum;
    __syncthreads();
    if (tid < kWgTile && n0 + tid < N) {
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < Cfg::kSumParts; ++r) v += smSum[r * kWgTile + tid];
      part[(size_t)M * N + n0 + tid] = v;
    }
  }
}

template <bool BF16>
cudaError_t rnn_wgrad_run(WgradArgs a, int S, cudaStream_t st) {
  using Cfg = WgradCfg<BF16>;
  wgrad_row_tiles(a.H + a.D, Cfg::kTileM, &a.m_tiles, &a.tail);
  cudaError_t e = allow_smem(rnn_wgrad_kernel<BF16>, Cfg::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((4 * a.H + kWgTile - 1) / kWgTile, a.m_tiles, S * a.P);
  rnn_wgrad_kernel<BF16><<<grid, Cfg::kThreads, Cfg::kSmemBytes, st>>>(a);
  return cudaGetLastError();
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

// Launches the reduction on the stream. W is the caller's scratch of
// [S,P,M,N] partial sums (unused, and may be C, when P == 1), P >= 1 the
// number of row splits; C [S,M,N] receives their sum. gru != 0 skips the
// products the GRU wrappers drop (they read zeros there).
int rnn_wgrad_launch(const float* xs, const float* resets, const float* carry0,
                     const float* hs, const float* gs, float* W, float* C, int S, int T,
                     int B, int D, int H, int P, int bf16, int per_stream_resets, int gru,
                     void* stream) {
  if (bad_dims(S, T, B, D, H) || P < 1 || (long long)S * P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const int M = H + D + 1, N = 4 * H;
  const WgradArgs a{xs, resets, carry0, hs, gs, P == 1 ? C : W, T, B, D, H, P, 0, 0,
                    per_stream_resets, gru};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? rnn_wgrad_run<true>(a, S, st) : rnn_wgrad_run<false>(a, S, st);
  if (err != cudaSuccess || P == 1) return (int)err;
  const long long total = (long long)S * M * N;
  rnn_wgrad_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(W, C, S, P, M * N);
  return (int)cudaGetLastError();
}

}  // namespace
