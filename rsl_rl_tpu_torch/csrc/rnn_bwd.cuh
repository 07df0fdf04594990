// The three-phase BPTT backward shared by the GRU and LSTM replays (sm_90a):
// gru_x_bwd (gru_x.cu), lstm_x_bwd (lstm_x.cu), gru_xp_bwd (gru_xp.cu) and
// lstm_xp_bwd (lstm_xp.cu).
//
// Reverse-time BPTT for the output gradient ghs, in three phases, each kernel
// on the caller's stream:
//
// 1. Gates, all steps at once (rnn_gates_kernel): the gate quantities of
//    every row (t, b) from [h_masked | x] @ W + b, h_masked = hs[t-1] * keep_t
//    (h0 at t = 0), one tiled GEMM over the T*B rows (the gate tile of
//    rnn_common.cuh, B fed through the same ring), written into the gs
//    scratch. They depend only on what the forward saved, not on the carried
//    gradients. Bound: 2*T*B*(H+D)*4H operations (fp32 CUDA cores; tensor
//    cores in bf16 mode, where writing gs bounds it).
// 2. The chain, one launch a step (rnn_chain_kernel), t = T-1 .. 0: the only
//    truly sequential work, dh_prev = (carry + dgates_t Whᵀ) * keep_t, a
//    [B,K] x [K,H] product spread over 64x64 output tiles of all streams (128
//    blocks at S=2, B=1024, H=256), so each Whᵀ element read from L2 serves 64
//    rows. Its epilogue forms the next step's gate gradients at the same (b, j)
//    cells from the gate quantities in gs, the saved states, ghs and the
//    carried dh (just computed) and the cell's carry (a [S,B,H] buffer that is
//    the carry's gradient at step 0 once the chain ends), written over the
//    gate quantities. rnn_dgates_init_kernel does the first step's (t = T-1,
//    zero carries). Bound: the T dependent products, 2*B*K*H operations each
//    (fp32 CUDA cores; tensor cores in bf16 mode), one block an SM, plus the
//    epilogue's loads from device memory and T launch gaps.
// 3. dx for all steps at once (rnn_dx_kernel): the first G*H columns of the
//    gate gradients @ Wxᵀ over the T*B rows, tall and skinny (N = D = 15):
//    bound by reading gs once.
//
// The cell is the template policy (LstmCell, LstmXpCell, GruCell and
// GruXpCell, at the end of this header): the columns of phase 1's W and bias, what it adds
// before the activation and the zero blocks it skips, the chain's K and how
// its columns lie in gs, and the epilogue's cell gradient with its carry.
// - LSTM: gs = i|f|g|o (activated), W = [Wh; Wx], K = 4H (di|df|dg|do),
//   carry dc, dh_prev = (dgates Whᵀ) * keep; dx over all 4H columns.
// - GRU: gs = r|z|a_n|u with r, z activated, a_n = x Wx_n + bx_n and u = h Wh_n
//   + bhn; n = tanh(a_n + r*u) is finished in the epilogue, which reads all
//   four at its cell anyway (a 128-column tile of phase 1 holds one gate, so
//   it cannot form n). W is block-sparse: u has no x rows and a_n no h rows;
//   a tile inside one of those blocks skips the zero k-tiles. The chain's K =
//   3H is dr|dz|du (gs columns 0..2H-1 and 3H..4H-1; dn does not enter), the
//   carry is g*z, dh_prev = (g*z + [dr|dz|du] Whᵀ) * keep; dx over dr|dz|dn.
//
// - xproj (LstmXpCell): G streams, each with its own reset mask (a stride of
//   T*B between streams, 0 for the x kernels, whose streams share one). Phase
//   1 is the GEMM over the G*T*B rows with K = H (no x rows), its
//   accumulators starting at the stored projection row (and bias) in place
//   of x Wx; there is no dx phase: the gate gradients in gs are the gradient
//   of xproj.
#pragma once

#include "rnn_common.cuh"

namespace {

constexpr int kGateStages = 3;   // phase 1's ring of k-tiles in shared memory
constexpr int kChainTile = 64;   // batch rows x hidden columns of a phase-2 block
constexpr int kChainK = 32;      // k-tile of phase 2
constexpr int kChainStages = 4;  // phase 2's ring of k-tiles in shared memory
constexpr int kChainLdA = kChainK + 8;     // dgates tile [64 rows][k], floats a row
constexpr int kChainLdB = kChainTile + 4;  // Whᵀ tile [k][64 columns], floats a row
constexpr int kChainStageFloats = kChainTile * kChainLdA + kChainK * kChainLdB;
static_assert(kChainStages * kChainStageFloats >= 4 * kChainTile * kChainLdB,
              "the ring holds the four partial product tiles of phase 2");
constexpr int kDxRows = 128, kDxCols = 16, kDxK = 16;

// Inputs, outputs and scratch of a backward; a cell reads the fields it has.
struct RnnBwdArgs {
  const float* xs;
  const float* resets;
  const float* c0;     // LSTM: the cell state entering step 0
  const float* h0;     // the hidden state entering step 0 (the GRU's carry0)
  const float* wx;
  const float* wh;
  const float* whT;
  const float* bias;   // LSTM: bh [S,4H]; GRU: bx [S,3H]
  const float* bias2;  // GRU: bhn [S,H]
  const float* hs;
  const float* cs;     // LSTM: the cell states of the forward
  const float* ghs;
  float* dx;
  float* carry;  // the cell's carried gradient, [S,B,H]; at the end the
                 // gradient of the carry entering step 0 (LSTM dc0, GRU dcarry0)
  float* dh0;    // LSTM: the gradient of h0
  float* gs;
  int T, B, D, H;
  int reset_stride;     // floats between the streams' reset masks (0: one shared mask)
  const float* xproj;   // xproj cells: the stored input projection
};

// Four floats of gs-like rows at p: a 16-byte load where vec, else the first
// n of them (zeros past n).
__device__ __forceinline__ void load_cols4(const float* p, bool vec, int n, float (&v)[4]) {
  if (vec) {
    load4(p, true, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.0f;
  }
}

// The xproj cells' phase 1 starts each accumulator at the cell's stored input
// (Cell::input4: the projection row plus the bias, four adjacent columns),
// loaded ahead of the k-loop so that the loads' latency hides behind it; in
// the epilogue, after the product, each load would wait behind the stores
// before it (the compiler may not move a load above a store that may alias).
template <class Cell, bool BF16>
__device__ __forceinline__ void gate_acc_input(const RnnBwdArgs& a, int s, int r0, int n0, int R, int N,
                                               GateAcc<128, BF16>& acc) {
  const int tid = threadIdx.x;
  if constexpr (BF16) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + wm * 64 + 16 * i + g + 8 * h, col = n0 + wn * 32 + 8 * j + 2 * q;
          if (row < R && col < N) {
            const float2 v = Cell::input2(a, s, row, col);
            acc[i][j][2 * h] = v.x;
            acc[i][j][2 * h + 1] = v.y;
          }
        }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + tile8_index(ty, i), col = n0 + 64 * h + tx * 4;
        if (row < R && col < N) {
          const float4 v = Cell::input4(a, s, row, col);
          acc[i][4 * h] = v.x;
          acc[i][4 * h + 1] = v.y;
          acc[i][4 * h + 2] = v.z;
          acc[i][4 * h + 3] = v.w;
        }
      }
  }
}

// Phase 1. Grid (ceil(4H/128), ceil(T*B/128), S), 256 threads, two blocks an
// SM: the block's 128 rows x 128 gs columns of [h_masked | x] @ W, then the
// cell's bias and activation, into gs. W's k-tiles stream through the ring
// beside the [h | x] rows, as fp32 (columns from the cell's weight map).
template <class Cell, bool BF16>
__global__ void __launch_bounds__(256, 2) rnn_gates_kernel(const RnnBwdArgs a) {
  constexpr int kTM = 128;
  constexpr int kLdA = gate_lda<BF16>();
  constexpr int kLdB = kGateCols + 4;
  constexpr int kStageFloats = kTM * kLdA + kGateK * kLdB;
  extern __shared__ __align__(16) float gate_smem[];
  const int tid = threadIdx.x, s = blockIdx.z;
  const int H = a.H, D = a.D, N = 4 * H, K = H + D, R = a.T * a.B;
  const int r0 = blockIdx.y * kTM, n0 = blockIdx.x * kGateCols;

  GateRows<kTM> rows;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    const int row = r0 + (tid >> 2) + 64 * r;
    const int rr = row < R ? row : R - 1;
    const int t = rr / a.B;
    rows.set(r, row < R, s, t, rr - t * a.B, a.h0, a.hs, a.xs, a.resets + (size_t)s * a.reset_stride, a.T, a.B,
             D, H);
  }
  // the k-tiles this tile needs (the GRU skips its zero blocks)
  int k_lo, k_hi;
  Cell::k_range(n0, min(n0 + kGateCols, N), H, D, k_lo, k_hi);
  const int kt_lo = k_lo / kGateK, n_kt = k_hi > k_lo ? (k_hi + kGateK - 1) / kGateK - kt_lo : 0;
  // weight copies: rows pr and pr + 8 of each k-tile, gs columns c4..c4+3
  const int pr = tid >> 5, c4 = (tid & 31) * 4;
  const bool w_vec = Cell::vec4(H);

  auto issue = [&](int i) {
    float* As = gate_smem + (i % kGateStages) * kStageFloats;
    float* Bs = As + kTM * kLdA;
    const int kt = kt_lo + i;
    gate_issue_a<kTM, BF16>(rows, As, kt, H, K, a.gs);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = kt * kGateK + pr + 8 * j, col = n0 + c4;
      float* dst = Bs + (pr + 8 * j) * kLdB + c4;
      if (w_vec) {
        const float* w = k < K && col < N ? Cell::gate_weight(a, s, k, col) : nullptr;
        cp_async16(dst, w ? w : a.gs, w != nullptr);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* w = k < K && col + e < N ? Cell::gate_weight(a, s, k, col + e) : nullptr;
          cp_async4(dst + e, w ? w : a.gs, w != nullptr);
        }
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kGateStages - 1; ++st) {
    if (st < n_kt) issue(st);
    cp_async_commit();
  }
  GateAcc<kTM, BF16> acc = {};
  if constexpr (Cell::kStoredInput) gate_acc_input<Cell, BF16>(a, s, r0, n0, R, N, acc);
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<kGateStages - 2>();
    float* As = gate_smem + (i % kGateStages) * kStageFloats;
    gate_fix_keep<kTM, BF16>(rows, As, kt_lo + i, H);
    __syncthreads();  // tile i is in and masked; the stage refilled below was read at i - 1
    if (i + kGateStages - 1 < n_kt) issue(i + kGateStages - 1);
    cp_async_commit();
    gate_tile_step<kTM, BF16>(acc, As, GateB32{As + kTM * kLdA, kLdB});
  }
  cp_async_wait<0>();

  float* out = a.gs + (size_t)s * R * N;
  if constexpr (BF16) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + wm * 64 + 16 * i + g + (e >= 2 ? 8 : 0);
          const int col = n0 + wn * 32 + 8 * j + 2 * q + (e & 1);
          if (row < R && col < N) out[(size_t)row * N + col] = Cell::gate_out(a, s, row, col, acc[i][j][e]);
        }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + tile8_index(ty, i);
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tile8_index(tx, j);
        if (col < N) out[(size_t)row * N + col] = Cell::gate_out(a, s, row, col, acc[i][j]);
      }
    }
  }
}

// The chain's first step (t = T-1, zero carries): grid-stride over (s, b,
// four hidden columns).
template <class Cell>
__global__ void rnn_dgates_init_kernel(const RnnBwdArgs a, int S) {
  const int J = (a.H + 3) / 4;
  const long long n = (long long)S * a.B * J;
  const float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % J) * 4;
    const int b = (int)((e / J) % a.B);
    const int s = (int)(e / ((long long)J * a.B));
    typename Cell::State4 x = Cell::load4(a, s, a.T - 1, b, j);
    Cell::no_carry(x);  // nothing is carried into the last step
    Cell::store4(a, s, a.T - 1, b, j, x, dh);
  }
}

// Phase 2, step t. Grid (ceil(H/64), ceil(B/64), S), 256 threads: the
// block's 64 rows x 64 hidden columns of the product dgates_t Whᵀ over the
// chain's K columns, then dh_prev and the epilogue at its cells: dgates_{t-1}
// and the carry there, or the carries' gradients at t = 0. A step has few
// blocks (128 at S=2: one an SM), each a 64 x 64 x K product. The k-tiles
// stream through a ring of kChainStages stages in shared memory, filled by
// cp.async kChainStages - 1 tiles ahead of the compute, as fp32 (dgates rows,
// Whᵀ rows). fp32 mode: with 4x4 register tiles a step would be bound by
// shared-memory bandwidth (two 16-byte loads per 16 FMAs), so four groups of
// 64 threads with 8x8 tiles split each k-tile and add their partial tiles in
// group order; bf16 mode: warps of 16x32 mma tiles, fragments rounded and
// packed as read. The epilogue's loads are issued two rows at a time ahead of
// its stores.
template <class Cell, bool BF16>
__global__ void __launch_bounds__(256) rnn_chain_kernel(const RnnBwdArgs a, int t) {
  extern __shared__ __align__(16) float chain_smem[];  // [stage][dgates tile | Whᵀ tile]
  const int tid = threadIdx.x, s = blockIdx.z;
  const int H = a.H, B = a.B, KC = Cell::chain_k(H);
  const int b0 = blockIdx.y * kChainTile, j0 = blockIdx.x * kChainTile;
  const float* dg = a.gs + ((size_t)s * a.T + t) * B * 4 * H;  // gs rows of step t, [B,4H]
  const float* whT_s = a.whT + (size_t)s * KC * H;
  const bool rows16 = (H & 3) == 0;  // Whᵀ rows start 16-byte aligned
  const bool g_vec = Cell::vec4(H);

  // k-tile kt into a stage: 64 rows x 8 chunks of dgates and 32 rows x 16
  // chunks of Whᵀ, two of each a thread; zero-filled past B, K and H
  auto load_tile = [&](int kt, int stage) {
    float* As = chain_smem + stage * kChainStageFloats;
    float* Bs = As + kChainTile * kChainLdA;
    const int k0 = kt * kChainK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + 256 * r;
      const int row = e >> 3, c = k0 + (e & 7) * 4;
      float* dst = As + row * kChainLdA + (e & 7) * 4;
      const float* src = dg + (size_t)(b0 + row) * 4 * H;
      if (g_vec) {
        const bool ok = b0 + row < B && c < KC;
        cp_async16(dst, ok ? src + Cell::chain_col(c, H) : dg, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = b0 + row < B && c + i < KC;
          cp_async4(dst + i, ok ? src + Cell::chain_col(c + i, H) : dg, ok);
        }
      }
      const int kc = k0 + (e >> 4), jj = (e & 15) * 4, j = j0 + jj;
      float* bdst = Bs + (e >> 4) * kChainLdB + jj;
      const float* bsrc = whT_s + (size_t)kc * H + j;
      if (rows16) {
        const bool okb = kc < KC && j < H;
        cp_async16(bdst, okb ? bsrc : whT_s, okb);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool okb = kc < KC && j + i < H;
          cp_async4(bdst + i, okb ? bsrc + i : whT_s, okb);
        }
      }
    }
  };

  const int n_k = (KC + kChainK - 1) / kChainK;
#pragma unroll
  for (int st = 0; st < kChainStages - 1; ++st) {
    if (st < n_k) load_tile(st, st);
    cp_async_commit();
  }
  // bf16: acc[n8 tile][4] of a warp's 16x32 (mma's C layout); fp32: the 8x8
  // register tile of a thread of one of four groups, which split each k-tile
  typename std::conditional<BF16, float[4][4], float[8][8]>::type acc = {};
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();  // tile kt is in; the stage refilled below was read at kt - 1
    if (kt + kChainStages - 1 < n_k) load_tile(kt + kChainStages - 1, (kt + kChainStages - 1) % kChainStages);
    cp_async_commit();
    const float* As = chain_smem + (kt % kChainStages) * kChainStageFloats;
    const float* Bs = As + kChainTile * kChainLdA;
    if constexpr (BF16) {
      // warp (wm, wn): rows wm*16.., columns wn*32..; acc[j][e] as mma's C
      const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
      const int g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
      for (int k16 = 0; k16 < kChainK; k16 += 16) {
        const float* ar = As + (wm * 16 + g) * kChainLdA + k16 + 2 * q;
        const float2 x0 = *reinterpret_cast<const float2*>(ar);
        const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * kChainLdA);
        const float2 x2 = *reinterpret_cast<const float2*>(ar + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(ar + 8 * kChainLdA + 8);
        const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                                pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bc = Bs + (k16 + 2 * q) * kChainLdB + wn * 32 + 8 * j + g;
          mma_bf16(acc[j], af, pack_bf16(bc[0], bc[kChainLdB]),
                   pack_bf16(bc[8 * kChainLdB], bc[9 * kChainLdB]));
        }
      }
    } else {
      // group grp (64 threads) takes k-columns 8*grp..8*grp+7 of the tile;
      // its thread (ty, tx) owns rows ty + 8i, columns tx*4.. and 32 + tx*4..
      const int grp = tid >> 6, ty = (tid >> 3) & 7, tx = tid & 7;
#pragma unroll
      for (int u4 = 0; u4 < 2; ++u4) {
        const int k4 = 8 * grp + 4 * u4;
        float av[8][4], bv[4][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(As + (ty + 8 * i) * kChainLdA + k4);
          av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 w = *reinterpret_cast<const float4*>(Bs + (k4 + u) * kChainLdB + 32 * h + tx * 4);
            bv[u][4 * h] = w.x; bv[u][4 * h + 1] = w.y; bv[u][4 * h + 2] = w.z; bv[u][4 * h + 3] = w.w;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][u], bv[u][j], acc[i][j]);
      }
    }
  }
  // the product into [64][68] tiles over the ring (fp32: one a group, added in
  // group order), then the epilogue: thread (ty, tx) takes rows ty*4..,
  // hidden columns tx*4..+3, two rows' loads in flight at a time
  constexpr int kParts = BF16 ? 1 : 4;
  cp_async_wait<0>();
  __syncthreads();
  float* dh_tile = chain_smem;
  if constexpr (BF16) {
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    const int g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dh_tile[(wm * 16 + g + (e >= 2 ? 8 : 0)) * kChainLdB + wn * 32 + 8 * j + 2 * q + (e & 1)] = acc[j][e];
      }
  } else {
    const int grp = tid >> 6, ty = (tid >> 3) & 7, tx = tid & 7;
    float* part = dh_tile + grp * kChainTile * kChainLdB;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(part + (ty + 8 * i) * kChainLdB + 32 * h + tx * 4) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
  }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15, j = j0 + tx * 4;
  if (j >= H) return;
  for (int i0 = 0; i0 < 4; i0 += 2) {
    typename Cell::State4 cell[2];
    float dh[2][4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int b = min(b0 + ty * 4 + i0 + ii, B - 1);
      float prod[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.0f;
#pragma unroll
        for (int pt = 0; pt < kParts; ++pt) v += dh_tile[(pt * kChainTile + ty * 4 + i0 + ii) * kChainLdB + tx * 4 + e];
        prod[e] = v;
      }
      Cell::dh_prev(a, s, t, b, j, prod, dh[ii]);
      if (t > 0) cell[ii] = Cell::load4(a, s, t - 1, b, j);
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int b = b0 + ty * 4 + i0 + ii;
      if (b >= B) continue;
      if (t > 0) {
        Cell::store4(a, s, t - 1, b, j, cell[ii], dh[ii]);
      } else {
        Cell::finish(a, s, b, j, dh[ii]);
      }
    }
  }
}

// Phase 3. Grid (ceil(D/16), ceil(T*B/128), S), 256 threads: dx = the first
// G*H columns of the gate gradients @ Wxᵀ for 128 rows x 16 input columns;
// thread (ry, dq) owns rows ry*4..+3, columns dq*2, dq*2 + 1.
template <class Cell, bool BF16>
__global__ void __launch_bounds__(256) rnn_dx_kernel(const RnnBwdArgs a) {
  __shared__ __align__(16) float As[kDxK][kDxRows];
  __shared__ __align__(16) float Bs[kDxK][kDxCols];
  const int tid = threadIdx.x, s = blockIdx.z;
  const int N = Cell::kGates * a.H, ld = 4 * a.H, D = a.D, R = a.T * a.B;
  const int r0 = blockIdx.y * kDxRows, d0 = blockIdx.x * kDxCols;
  const float* g = a.gs + (size_t)s * R * ld;
  const float* wx_s = a.wx + (size_t)s * D * N;
  const int ry = tid >> 3, dq = tid & 7;
  float acc[4][2] = {};
  for (int c0 = 0; c0 < N; c0 += kDxK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = tid + 256 * j, r = slot >> 2, c = (slot & 3) * 4;
      float v[4];
      load4(g + (size_t)(r0 + r) * ld + c0 + c, r0 + r < R && c0 + c < N, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) As[c + i][r] = c0 + c + i < N ? op<BF16>(v[i]) : 0.0f;
    }
    {
      const int d = tid >> 4, kk = tid & 15;
      Bs[kk][d] = d0 + d < D && c0 + kk < N ? op<BF16>(wx_s[(size_t)(d0 + d) * N + c0 + kk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDxK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ry * 4]);
      const float2 bv = *reinterpret_cast<const float2*>(&Bs[kk][dq * 2]);
      const float x[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(x[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(x[i], bv.y, acc[i][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ry * 4 + i;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = d0 + dq * 2 + e;
      if (row < R && d < D) a.dx[((size_t)s * R + row) * D + d] = acc[i][e];
    }
  }
}

// Launches the three phases on the stream. With phase_ms, also records an
// event before, between and after them, waits for the stream, and writes
// the three phases' milliseconds there (for a timing call; nullptr on the
// main path).
template <class Cell, bool BF16>
cudaError_t rnn_bwd_launch(const RnnBwdArgs& a, int S, cudaStream_t st, float* phase_ms) {
  cudaEvent_t ev[4] = {};
  cudaError_t err = cudaSuccess;
  if (phase_ms) {
    for (auto& e : ev)
      if ((err = cudaEventCreate(&e)) != cudaSuccess) return err;
    cudaEventRecord(ev[0], st);
  }
  const int R = a.T * a.B;
  const size_t gate_smem =
      (size_t)kGateStages * (128 * gate_lda<BF16>() + kGateK * (kGateCols + 4)) * sizeof(float);
  if ((err = allow_smem(rnn_gates_kernel<Cell, BF16>, gate_smem)) != cudaSuccess) return err;
  rnn_gates_kernel<Cell, BF16><<<dim3((4 * a.H + kGateCols - 1) / kGateCols, (R + 127) / 128, S), 256,
                                 gate_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (phase_ms) cudaEventRecord(ev[1], st);
  const long long cells = (long long)S * a.B * ((a.H + 3) / 4);
  rnn_dgates_init_kernel<Cell><<<(unsigned)(cells < 4096LL * 256 ? (cells + 255) / 256 : 4096), 256, 0, st>>>(a, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 chain((a.H + kChainTile - 1) / kChainTile, (a.B + kChainTile - 1) / kChainTile, S);
  auto chain_kernel = rnn_chain_kernel<Cell, BF16>;
  const size_t smem = (size_t)kChainStages * kChainStageFloats * sizeof(float);
  if ((err = allow_smem(chain_kernel, smem)) != cudaSuccess) return err;
  for (int t = a.T - 1; t >= 0; --t) {
    chain_kernel<<<chain, 256, smem, st>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phase_ms) cudaEventRecord(ev[2], st);
  if (a.D > 0) {
    rnn_dx_kernel<Cell, BF16><<<dim3((a.D + kDxCols - 1) / kDxCols, (R + kDxRows - 1) / kDxRows, S), 256, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phase_ms) {
    cudaEventRecord(ev[3], st);
    if ((err = cudaEventSynchronize(ev[3])) != cudaSuccess) return err;
    for (int p = 0; p < 3; ++p) cudaEventElapsedTime(phase_ms + p, ev[p], ev[p + 1]);
    if (a.D == 0) phase_ms[2] = 0.0f;  // no dx phase
    for (auto& e : ev) cudaEventDestroy(e);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- the cells
//
// The LSTM cell of the three phases (lstm_x_bwd): gs holds i|f|g|o after phase
// 1 and di|df|dg|do after the chain; the carry is dc.
struct LstmCell {
  static constexpr int kGates = 4;  // gate blocks of Wx (dx takes all 4H columns)
  static constexpr bool kStoredInput = false;  // phase 1's accumulators start at zero

  __device__ __forceinline__ static int chain_k(int H) { return 4 * H; }
  __device__ __forceinline__ static int chain_col(int c, int) { return c; }
  __device__ __forceinline__ static bool vec4(int) { return true; }
  __device__ __forceinline__ static void k_range(int, int, int H, int D, int& lo, int& hi) {
    lo = 0;
    hi = H + D;
  }
  __device__ __forceinline__ static const float* gate_weight(const RnnBwdArgs& a, int s, int k, int col) {
    const int H = a.H, N = 4 * H;
    return k < H ? a.wh + ((size_t)s * H + k) * N + col : a.wx + ((size_t)s * a.D + k - H) * N + col;
  }
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int s, int, int col, float v) {
    v += a.bias[(size_t)s * 4 * a.H + col];
    return col / a.H == 2 ? tanhf(v) : sigmoid(v);
  }

  // The cell's gradient at step t, row b, hidden columns j..j+3, from the
  // activations i|f|g|o that gs holds there, cs, ghs, and the carried dh
  // (entering from step t+1) and dc: store4 writes di|df|dg|do over the
  // activations and the dc leaving step t. Split into a load half and a
  // compute-and-store half, so that a thread can have the loads of several
  // rows in flight before its first store (the compiler may not move a load
  // above a store to the same arrays).
  struct State4 {
    float i[4], f[4], g[4], o[4], c[4], c_prev[4], gh[4], dc[4];
    float keep;
  };

  __device__ __forceinline__ static State4 load4(const RnnBwdArgs& a, int s, int t, int b, int j) {
    const int H = a.H;
    const int n = min(4, H - j);
    const bool vec = n == 4 && (H & 3) == 0;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    const float* g = a.gs + row * 4 * H + j;
    State4 x;
    load_cols4(g, vec, n, x.i);
    load_cols4(g + H, vec, n, x.f);
    load_cols4(g + 2 * H, vec, n, x.g);
    load_cols4(g + 3 * H, vec, n, x.o);
    load_cols4(a.cs + row * H + j, vec, n, x.c);
    load_cols4(t == 0 ? a.c0 + ((size_t)s * a.B + b) * H + j : a.cs + (row - a.B) * H + j, vec, n, x.c_prev);
    load_cols4(a.ghs + row * H + j, vec, n, x.gh);
    load_cols4(a.carry + ((size_t)s * a.B + b) * H + j, vec, n, x.dc);
    x.keep = 1.0f - a.resets[(size_t)s * a.reset_stride + (size_t)t * a.B + b];
    return x;
  }

  __device__ __forceinline__ static void no_carry(State4& x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) x.dc[k] = 0.0f;
  }

  __device__ __forceinline__ static void store4(const RnnBwdArgs& a, int s, int t, int b, int j,
                                                const State4& x, const float (&dh)[4]) {
    const int H = a.H;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    float* g = a.gs + row * 4 * H + j;
    float* dc = a.carry + ((size_t)s * a.B + b) * H + j;
    for (int e = 0; e < min(4, H - j); ++e) {
      const float i = x.i[e], f = x.f[e], gg = x.g[e], o = x.o[e];
      const float tc = tanhf(x.c[e]);
      const float gh = x.gh[e] + dh[e];
      const float gc = x.dc[e] + gh * o * (1.0f - tc * tc);
      g[e] = gc * gg * i * (1.0f - i);
      g[H + e] = gc * x.c_prev[e] * x.keep * f * (1.0f - f);
      g[2 * H + e] = gc * i * (1.0f - gg * gg);
      g[3 * H + e] = gh * tc * o * (1.0f - o);
      dc[e] = gc * f * x.keep;
    }
  }

  // dh_prev = (dgates_t Whᵀ) * keep_t
  __device__ __forceinline__ static void dh_prev(const RnnBwdArgs& a, int s, int t, int b, int,
                                                 const float (&prod)[4], float (&dh)[4]) {
    const float keep = 1.0f - a.resets[(size_t)s * a.reset_stride + (size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = prod[e] * keep;
  }

  // t = 0: dh0 (dc0 is the carry buffer already)
  __device__ __forceinline__ static void finish(const RnnBwdArgs& a, int s, int b, int j, const float (&dh)[4]) {
    for (int e = 0; e < min(4, a.H - j); ++e) a.dh0[((size_t)s * a.B + b) * a.H + j + e] = dh[e];
  }
};

// The LSTM cell of the xproj backward (lstm_xp_bwd): phase 1 takes the
// stored projection xproj [G,T,B,4H] in place of x Wx (no x rows: D = 0),
// starting each accumulator at its row of xproj plus bh (gate_acc_input), so
// the epilogue applies the activation alone; the rest is LstmCell's.
struct LstmXpCell : LstmCell {
  static constexpr bool kStoredInput = true;

  __device__ __forceinline__ static float4 input4(const RnnBwdArgs& a, int s, int row, int col) {
    const size_t N = 4 * a.H;
    const float4 x = __ldg(reinterpret_cast<const float4*>(a.xproj + ((size_t)s * a.T * a.B + row) * N + col));
    const float4 b = __ldg(reinterpret_cast<const float4*>(a.bias + s * N + col));
    return make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
  }
  __device__ __forceinline__ static float2 input2(const RnnBwdArgs& a, int s, int row, int col) {
    const size_t N = 4 * a.H;
    const float2 x = __ldg(reinterpret_cast<const float2*>(a.xproj + ((size_t)s * a.T * a.B + row) * N + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(a.bias + s * N + col));
    return make_float2(x.x + b.x, x.y + b.y);
  }
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int, int, int col, float v) {
    return col / a.H == 2 ? tanhf(v) : sigmoid(v);
  }
};

// The GRU cell of the three phases (gru_x_bwd). Phase 1 writes r|z|a_n|u into
// gs: r and z activated, a_n = x Wx_n + bx_n and u = h Wh_n + bhn as they
// are; the chain's epilogue finishes n = tanh(a_n + r*u) at its cell and
// writes dr|dz|dn|du over them. The carry is g*z.
struct GruCell {
  static constexpr int kGates = 3;  // gate blocks of Wx (dx takes dr|dz|dn)
  static constexpr bool kStoredInput = false;  // phase 1's accumulators start at zero

  __device__ __forceinline__ static int chain_k(int H) { return 3 * H; }
  // the chain's k-th column is gs column k of dr|dz, then du (dn is skipped)
  __device__ __forceinline__ static int chain_col(int c, int H) { return c < 2 * H ? c : c + H; }
  // four gs columns from a multiple of 4 lie in one gate block, 16-byte aligned
  __device__ __forceinline__ static bool vec4(int H) { return (H & 3) == 0; }
  // a tile of a_n columns needs only the x rows, one of u columns only the h rows
  __device__ __forceinline__ static void k_range(int n0, int n_end, int H, int D, int& lo, int& hi) {
    const int q0 = n0 / H, q1 = (n_end - 1) / H;
    lo = q0 == 2 && q1 == 2 ? H : 0;
    hi = q0 == 3 && q1 == 3 ? H : H + D;
  }
  // W[k][col] of phase 1: h rows [Wh_r | Wh_z | 0 | Wh_n], x rows [Wx_r | Wx_z | Wx_n | 0]
  __device__ __forceinline__ static const float* gate_weight(const RnnBwdArgs& a, int s, int k, int col) {
    const int H = a.H, G3 = 3 * H, q = col / H, jj = col - q * H;
    if (k < H) return q == 2 ? nullptr : a.wh + ((size_t)s * H + k) * G3 + (q == 3 ? 2 * H : q * H) + jj;
    return q == 3 ? nullptr : a.wx + ((size_t)s * a.D + k - H) * G3 + q * H + jj;
  }
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int s, int, int col, float v) {
    const int H = a.H, q = col / H;
    if (q == 3) return v + a.bias2[(size_t)s * H + col - 3 * H];
    v += a.bias[(size_t)s * 3 * H + col];
    return q < 2 ? sigmoid(v) : v;
  }

  // The cell's gradient at step t, row b, hidden columns j..j+3: the load
  // half (r|z|a_n|u from gs, the masked h entering step t, ghs) and the
  // compute-and-store half (dr|dz|dn|du over them, and g*z into the carry).
  struct State4 {
    float r[4], z[4], an[4], u[4], h[4], gh[4];
  };

  __device__ __forceinline__ static State4 load4(const RnnBwdArgs& a, int s, int t, int b, int j) {
    const int H = a.H;
    const int n = min(4, H - j);
    const bool vec = n == 4 && (H & 3) == 0;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    const float* g = a.gs + row * 4 * H + j;
    State4 x;
    load_cols4(g, vec, n, x.r);
    load_cols4(g + H, vec, n, x.z);
    load_cols4(g + 2 * H, vec, n, x.an);
    load_cols4(g + 3 * H, vec, n, x.u);
    load_cols4(t == 0 ? a.h0 + ((size_t)s * a.B + b) * H + j : a.hs + (row - a.B) * H + j, vec, n, x.h);
    load_cols4(a.ghs + row * H + j, vec, n, x.gh);
    const float keep = 1.0f - a.resets[(size_t)s * a.reset_stride + (size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) x.h[e] *= keep;
    return x;
  }

  __device__ __forceinline__ static void no_carry(State4&) {}

  __device__ __forceinline__ static void store4(const RnnBwdArgs& a, int s, int t, int b, int j,
                                                const State4& x, const float (&dh)[4]) {
    const int H = a.H;
    const size_t row = ((size_t)s * a.T + t) * a.B + b;
    float* g = a.gs + row * 4 * H + j;
    float* gz = a.carry + ((size_t)s * a.B + b) * H + j;
    for (int e = 0; e < min(4, H - j); ++e) {
      const float r = x.r[e], z = x.z[e], u = x.u[e];
      const float n = tanhf(x.an[e] + r * u);
      const float gg = x.gh[e] + dh[e];
      const float dn = gg * (1.0f - z) * (1.0f - n * n);
      g[e] = dn * u * r * (1.0f - r);
      g[H + e] = gg * (x.h[e] - n) * z * (1.0f - z);
      g[2 * H + e] = dn;
      g[3 * H + e] = dn * r;
      gz[e] = gg * z;
    }
  }

  // dh_prev = (g*z + [dr|dz|du]_t Whᵀ) * keep_t
  __device__ __forceinline__ static void dh_prev(const RnnBwdArgs& a, int s, int t, int b, int j,
                                                 const float (&prod)[4], float (&dh)[4]) {
    const int n = min(4, a.H - j);
    float gz[4];
    load_cols4(a.carry + ((size_t)s * a.B + b) * a.H + j, n == 4 && (a.H & 3) == 0, n, gz);
    const float keep = 1.0f - a.resets[(size_t)s * a.reset_stride + (size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = (gz[e] + prod[e]) * keep;
  }

  // t = 0: dcarry0, over the carry buffer
  __device__ __forceinline__ static void finish(const RnnBwdArgs& a, int s, int b, int j, const float (&dh)[4]) {
    for (int e = 0; e < min(4, a.H - j); ++e) a.carry[((size_t)s * a.B + b) * a.H + j + e] = dh[e];
  }
};

// The GRU cell of the xproj backward (gru_xp_bwd): phase 1 takes the stored
// projection xproj [G,T,B,3H] (x Wx + bx, r|z|n: its row stride is 3H, not
// gs's 4H) in place of x Wx + bx, with no x rows (D = 0). gs columns r|z|a_n
// start at xproj's columns and u at bhn (gate_acc_input), so the epilogue
// activates r and z and adds nothing. GruCell::k_range gives the a_n tiles
// no k rows (their gs columns are xproj's n columns as they are) and the u
// tiles the h rows, so GruCell::gate_weight serves as it is; the chain is
// GruCell's.
struct GruXpCell : GruCell {
  static constexpr bool kStoredInput = true;

  // gs column col of row (s, row) before the product: xproj's r|z|n, or bhn
  __device__ __forceinline__ static float input1(const RnnBwdArgs& a, int s, int row, int col) {
    const int H = a.H;
    return col < 3 * H ? __ldg(a.xproj + ((size_t)s * a.T * a.B + row) * 3 * H + col)
                       : __ldg(a.bias2 + (size_t)s * H + col - 3 * H);
  }
  // w consecutive columns from col (a multiple of w) in one load where they
  // lie in one block of xproj or bhn and the load is aligned, else one by one
  template <int w>
  __device__ __forceinline__ static bool vec(const RnnBwdArgs& a) {
    return a.H % w == 0 && ((reinterpret_cast<uintptr_t>(a.xproj) | reinterpret_cast<uintptr_t>(a.bias2)) & (4 * w - 1)) == 0;
  }
  __device__ __forceinline__ static const float* input_ptr(const RnnBwdArgs& a, int s, int row, int col) {
    const int H = a.H;
    return col < 3 * H ? a.xproj + ((size_t)s * a.T * a.B + row) * 3 * H + col : a.bias2 + (size_t)s * H + col - 3 * H;
  }
  __device__ __forceinline__ static float4 input4(const RnnBwdArgs& a, int s, int row, int col) {
    if (vec<4>(a)) return __ldg(reinterpret_cast<const float4*>(input_ptr(a, s, row, col)));
    return make_float4(input1(a, s, row, col), input1(a, s, row, col + 1), input1(a, s, row, col + 2),
                       input1(a, s, row, col + 3));
  }
  __device__ __forceinline__ static float2 input2(const RnnBwdArgs& a, int s, int row, int col) {
    if (vec<2>(a)) return __ldg(reinterpret_cast<const float2*>(input_ptr(a, s, row, col)));
    return make_float2(input1(a, s, row, col), input1(a, s, row, col + 1));
  }
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int, int, int col, float v) {
    return col < 2 * a.H ? sigmoid(v) : v;
  }
};

}  // namespace
