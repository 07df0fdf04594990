// LSTM window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_x_fwd    <- _lstm_fwd_kernel_x_pair (S=2) and _lstm_fwd_kernel_x (S=1)
//   lstm_x_bwd    <- _lstm_bwd_kernel_x_pair / _lstm_bwd_kernel_x: the BPTT chain,
//                    in three phases (the note above lstm_gates_kernel)
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
// math is IEEE fp32 on the CUDA cores; bf16-mode products of the backward and
// the weight-gradient reduction run on the tensor cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (lstm_x_fwd one,
// lstm_x_bwd T+3, lstm_x_wgrad one or two), allocates nothing, and returns the
// cudaError_t of the launches (0 on success).

#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 8;  // batch rows per forward block

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

// ------------------------------------------------------------------ backward
//
// Reverse-time BPTT of lstm_x_fwd for the output gradient ghs, in three
// phases, each kernel on the caller's stream:
//
// 1. Gates, all steps at once (lstm_gates_kernel): the gate activations
//    i|f|g|o of every row (t, b) from a = [hs[t-1] * keep | x_t] @ [Wh; Wx] + bh
//    ((c0, h0) enter step 0), one tiled GEMM over the T*B rows, written into
//    the gs scratch. They depend only on what the forward saved, not on the
//    carried gradients. Bound: 2*T*B*(H+D)*4H operations (fp32 CUDA cores;
//    tensor cores in bf16 mode, where writing gs bounds it).
// 2. The chain, one launch a step (lstm_chain_kernel), t = T-1 .. 0: the only
//    truly sequential work, dh_prev = (dgates_t Whᵀ) * keep_t, a [B,4H] x
//    [4H,H] product spread over 64x64 output tiles of all streams (128
//    blocks at S=2, B=1024, H=256), so each Whᵀ element read from L2 serves
//    64 rows. Its epilogue forms the
//    next step's gate gradients at the same (b, j) cells: dgates_{t-1} from
//    the activations in gs, cs, ghs and the carried dh (just computed) and
//    dc (a [S,B,H] buffer, which is dc0 once the chain ends), written over
//    the activations; and dc_prev = gc * f * keep. lstm_dgates_init_kernel
//    does the first step's (t = T-1, zero carries). Bound: the T dependent products, 2*B*4H*H operations each
//    (fp32 CUDA cores; tensor cores in bf16 mode), one block an SM, plus the
//    epilogue's loads from device memory and T launch gaps.
// 3. dx for all steps at once (lstm_dx_kernel): dgates @ Wxᵀ over the T*B
//    rows, tall and skinny (N = D = 15): bound by reading gs once.
//
// The serial chain keeps only the product that needs the previous step; the
// gates and dx, which do not, are GEMMs over all rows. gru_x_bwd, gru_xp_bwd and
// lstm_xp_bwd have the same structure and take the same three phases: their
// gate recompute (h Wh, for the GRU also r * u) is one GEMM over all rows
// (the xproj kernels add the stored projection instead of x Wx), their chain
// is dgates @ Whᵀ with the cell's elementwise gradient in the epilogue (the
// GRU adds dh * z), and only gru_x_bwd has a dx phase.

constexpr int kGateTile = 128;  // rows x gate columns of a phase-1 block
constexpr int kGateStages = 3;  // phase 1's ring of k-tiles in shared memory
constexpr int kChainTile = 64;  // batch rows x hidden columns of a phase-2 block
constexpr int kChainK = 32;      // k-tile of phase 2
constexpr int kChainStages = 4;  // phase 2's ring of k-tiles in shared memory
constexpr int kChainLdA = kChainK + 8;     // dgates tile [64 rows][k], floats a row
constexpr int kChainLdB = kChainTile + 4;  // Whᵀ tile [k][64 columns], floats a row
constexpr int kChainStageFloats = kChainTile * kChainLdA + kChainK * kChainLdB;
static_assert(kChainStages * kChainStageFloats >= 4 * kChainTile * kChainLdB,
              "the ring holds the four partial product tiles of phase 2");
constexpr int kDxRows = 128, kDxCols = 16;
constexpr int kBwdK = 16;       // k-tile of phases 1 and 2

struct LstmBwdArgs {
  const float* xs;
  const float* resets;
  const float* c0;
  const float* h0;
  const float* wx;
  const float* wh;
  const float* whT;
  const float* bh;
  const float* hs;
  const float* cs;
  const float* ghs;
  float* dx;
  float* dc;  // the carried dc, [S,B,H]; dc0 when the chain ends
  float* dh0;
  float* gs;
  int T, B, D, H;
};

__device__ __forceinline__ float lstm_act(float v, int gate) {
  return gate == 2 ? tanhf(v) : sigmoid(v);
}

// The cell's gradient at step t, row b, hidden columns j..j+3, from the
// activations i|f|g|o that gs holds there, cs, ghs, and the carried dh
// (entering from step t+1) and dc (in a.dc): lstm_cell_store4 writes
// di|df|dg|do over the activations and the dc leaving step t. Split into a
// load half and a compute-and-store half, so that a thread can have the loads
// of several rows in flight before its first store (the compiler may not
// move a load above a store to the same arrays).
struct LstmCell4 {
  float i[4], f[4], g[4], o[4], c[4], c_prev[4], gh[4], dc[4];
  float keep;
};

__device__ __forceinline__ void load_cols4(const float* p, bool vec, int n, float (&v)[4]) {
  if (vec) {
    load4(p, true, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.0f;
  }
}

__device__ __forceinline__ LstmCell4 lstm_cell_load4(const LstmBwdArgs& a, int s, int t, int b, int j) {
  const int H = a.H;
  const int n = min(4, H - j);
  const bool vec = n == 4 && (H & 3) == 0;
  const size_t row = ((size_t)s * a.T + t) * a.B + b;
  const float* g = a.gs + row * 4 * H + j;
  LstmCell4 x;
  load_cols4(g, vec, n, x.i);
  load_cols4(g + H, vec, n, x.f);
  load_cols4(g + 2 * H, vec, n, x.g);
  load_cols4(g + 3 * H, vec, n, x.o);
  load_cols4(a.cs + row * H + j, vec, n, x.c);
  load_cols4(t == 0 ? a.c0 + ((size_t)s * a.B + b) * H + j : a.cs + (row - a.B) * H + j, vec, n, x.c_prev);
  load_cols4(a.ghs + row * H + j, vec, n, x.gh);
  load_cols4(a.dc + ((size_t)s * a.B + b) * H + j, vec, n, x.dc);
  x.keep = 1.0f - a.resets[(size_t)t * a.B + b];
  return x;
}

__device__ __forceinline__ void lstm_cell_store4(const LstmBwdArgs& a, int s, int t, int b, int j,
                                                 const LstmCell4& x, const float (&dh)[4]) {
  const int H = a.H;
  const size_t row = ((size_t)s * a.T + t) * a.B + b;
  float* g = a.gs + row * 4 * H + j;
  float* dc = a.dc + ((size_t)s * a.B + b) * H + j;
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

// Phase 1. Grid (ceil(4H/128), ceil(T*B/128), S), 256 threads, two blocks an
// SM: the block's 128 rows x 128 gate columns of act([h_masked | x] @
// [Wh; Wx] + bh) into gs. The k-tiles of 16 operand columns stream through a
// ring of kGateStages stages in shared memory by cp.async, as fp32: rows of
// [h | x] as they lie (each thread multiplies the h it copied by its row's
// keep), rows of Wh and Wx. fp32 mode: 8x8 register tiles (fma_step_8x8's
// layout); bf16 mode: warps of 64x32 mma tiles, fragments packed as read.
template <bool BF16>
__global__ void __launch_bounds__(256, 2) lstm_gates_kernel(const LstmBwdArgs a) {
  constexpr int kLdA = BF16 ? kBwdK + 8 : kBwdK + 4;  // floats a row of the [h | x] tile
  constexpr int kLdB = kGateTile + 4;                 // floats a row of the weight tile
  constexpr int kStageFloats = kGateTile * kLdA + kBwdK * kLdB;
  extern __shared__ __align__(16) float gate_smem[];
  const int tid = threadIdx.x, s = blockIdx.z;
  const int H = a.H, D = a.D, N = 4 * H, K = H + D, R = a.T * a.B;
  const int r0 = blockIdx.y * kGateTile, n0 = blockIdx.x * kGateTile;
  const float* wh_s = a.wh + (size_t)s * H * N;
  const float* wx_s = a.wx + (size_t)s * D * N;

  // [h | x] copies: rows ar and ar + 64 of the tile, operand columns ak..ak+3
  // of each k-tile; the rows' carry, x row and keep are fixed for the block
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const float* hrow[2];
  const float* xrow[2];
  float keep[2];
  bool valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r0 + ar + 64 * j;
    valid[j] = row < R;
    const int rr = valid[j] ? row : R - 1;
    const int t = rr / a.B, b = rr - t * a.B;
    keep[j] = valid[j] ? 1.0f - a.resets[rr] : 1.0f;
    hrow[j] = t == 0 ? a.h0 + ((size_t)s * a.B + b) * H : a.hs + (((size_t)s * a.T + t - 1) * a.B + b) * H;
    xrow[j] = D > 0 ? a.xs + (((size_t)s * a.T + t) * a.B + b) * D : nullptr;
  }
  // weight copies: rows pr and pr + 8 of each k-tile, gate columns c4..c4+3
  const int pr = tid >> 5, c4 = (tid & 31) * 4;
  const bool h_vec = (H & 3) == 0;

  auto issue = [&](int kt) {
    float* As = gate_smem + (kt % kGateStages) * kStageFloats;
    float* Bs = As + kGateTile * kLdA;
    const int k = kt * kBwdK + ak;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* dst = As + (ar + 64 * j) * kLdA + ak;
      if (h_vec && k + 3 < H) {
        cp_async16(dst, valid[j] ? hrow[j] + k : a.gs, valid[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = k + i;
          const bool is_h = valid[j] && kc < H, is_x = valid[j] && kc >= H && kc < K;
          cp_async4(dst + i, is_h ? hrow[j] + kc : is_x ? xrow[j] + (kc - H) : a.gs, is_h || is_x);
        }
      }
      const int kb = kt * kBwdK + pr + 8 * j;
      const bool ok = kb < K && n0 + c4 < N;
      const float* w = kb < H ? wh_s + (size_t)kb * N : wx_s + (size_t)(kb - H) * N;
      cp_async16(Bs + (pr + 8 * j) * kLdB + c4, ok ? w + n0 + c4 : a.gs, ok);
    }
  };
  auto fix_keep = [&](int kt) {  // the h this thread copied, times its row's keep
    float* As = gate_smem + (kt % kGateStages) * kStageFloats;
    const int k = kt * kBwdK + ak;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (keep[j] == 1.0f) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k + i < H) As[(ar + 64 * j) * kLdA + ak + i] *= keep[j];
    }
  };

  const int n_kt = (K + kBwdK - 1) / kBwdK;
#pragma unroll
  for (int st = 0; st < kGateStages - 1; ++st) {
    if (st < n_kt) issue(st);
    cp_async_commit();
  }
  const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const int wm = warp >> 2, wn = warp & 3;  // bf16: warp tile rows wm*64.., columns wn*32..
  const int ty = tid >> 4, tx = tid & 15;   // fp32: see fma_step_8x8
  typename std::conditional<BF16, float[4][4][4], float[8][8]>::type acc = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kGateStages - 2>();
    fix_keep(kt);
    __syncthreads();  // tile kt is in and masked; the stage refilled below was read at kt - 1
    if (kt + kGateStages - 1 < n_kt) issue(kt + kGateStages - 1);
    cp_async_commit();
    const float* As = gate_smem + (kt % kGateStages) * kStageFloats;
    const float* Bs = As + kGateTile * kLdA;
    if constexpr (BF16) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bc = Bs + 2 * q * kLdB + wn * 32 + 8 * j + g;
        b[j][0] = pack_bf16(bc[0], bc[kLdB]);
        b[j][1] = pack_bf16(bc[8 * kLdB], bc[9 * kLdB]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar0 = As + (wm * 64 + 16 * i + g) * kLdA + 2 * q;
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
#pragma unroll
      for (int kk = 0; kk < kBwdK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[tile8_index(ty, i) * kLdA + kk];
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + 64 + tx * 4);
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const float* bias = a.bh + (size_t)s * N;
  float* out = a.gs + (size_t)s * R * N;
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + wm * 64 + 16 * i + g + (e >= 2 ? 8 : 0);
          const int col = n0 + wn * 32 + 8 * j + 2 * q + (e & 1);
          if (row < R && col < N) out[(size_t)row * N + col] = lstm_act(acc[i][j][e] + bias[col], col / H);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + tile8_index(ty, i);
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tile8_index(tx, j);
        if (col < N) out[(size_t)row * N + col] = lstm_act(acc[i][j] + bias[col], col / H);
      }
    }
  }
}

// The chain's first step (t = T-1, zero carries): grid-stride over (s, b,
// four hidden columns).
__global__ void lstm_dgates_init_kernel(const LstmBwdArgs a, int S) {
  const int J = (a.H + 3) / 4;
  const long long n = (long long)S * a.B * J;
  const float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % J) * 4;
    const int b = (int)((e / J) % a.B);
    const int s = (int)(e / ((long long)J * a.B));
    LstmCell4 x = lstm_cell_load4(a, s, a.T - 1, b, j);
#pragma unroll
    for (int k = 0; k < 4; ++k) x.dc[k] = 0.0f;  // nothing is carried into the last step
    lstm_cell_store4(a, s, a.T - 1, b, j, x, dh);
  }
}

// Phase 2, step t. Grid (ceil(H/64), ceil(B/64), S), 256 threads: the
// block's 64 rows x 64 hidden columns of dh_prev = (dgates_t Whᵀ) * keep_t,
// then dgates_{t-1} and the carried dc there (or dh0 at t = 0). A step has
// few blocks (128 at S=2: one an SM), each a 64 x 64 x 4H product. The
// k-tiles stream through a ring of kChainStages stages in shared memory,
// filled by cp.async kChainStages - 1 tiles ahead of the compute, as fp32
// (dgates rows, Whᵀ rows). fp32 mode: with 4x4 register tiles a step would be
// bound by shared-memory bandwidth (two 16-byte loads per 16 FMAs), so four
// groups of 64 threads with 8x8 tiles split each k-tile and add their
// partial tiles in group order; bf16 mode: warps of 16x32 mma tiles,
// fragments rounded and packed as read. The epilogue's loads (eight arrays
// at the block's cells) are issued two rows at a time ahead of its stores.
template <bool BF16>
__global__ void __launch_bounds__(256) lstm_chain_kernel(const LstmBwdArgs a, int t) {
  extern __shared__ __align__(16) float chain_smem[];  // [stage][dgates tile | Whᵀ tile]
  const int tid = threadIdx.x, s = blockIdx.z;
  const int H = a.H, N = 4 * H, B = a.B;
  const int b0 = blockIdx.y * kChainTile, j0 = blockIdx.x * kChainTile;
  const float* dg = a.gs + ((size_t)s * a.T + t) * B * N;  // dgates of step t, [B,4H]
  const float* whT_s = a.whT + (size_t)s * N * H;
  const bool rows16 = (H & 3) == 0;  // Whᵀ rows start 16-byte aligned

  // k-tile kt into a stage: 64 rows x 8 chunks of dgates and 32 rows x 16
  // chunks of Whᵀ, two of each a thread; zero-filled past B, 4H and H
  auto load_tile = [&](int kt, int stage) {
    float* As = chain_smem + stage * kChainStageFloats;
    float* Bs = As + kChainTile * kChainLdA;
    const int k0 = kt * kChainK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + 256 * r;
      const int row = e >> 3, ch = (e & 7) * 4;
      const bool ok = b0 + row < B && k0 + ch < N;
      cp_async16(As + row * kChainLdA + ch, ok ? dg + (size_t)(b0 + row) * N + k0 + ch : dg, ok);
      const int c = k0 + (e >> 4), jj = (e & 15) * 4, j = j0 + jj;
      float* dst = Bs + (e >> 4) * kChainLdB + jj;
      const float* src = whT_s + (size_t)c * H + j;
      if (rows16) {
        const bool okb = c < N && j < H;
        cp_async16(dst, okb ? src : whT_s, okb);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool okb = c < N && j + i < H;
          cp_async4(dst + i, okb ? src + i : whT_s, okb);
        }
      }
    }
  };

  const int n_k = (N + kChainK - 1) / kChainK;
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
  // group order), then the epilogue: dh_prev = product * keep_t; thread (ty,
  // tx) takes rows ty*4.., hidden columns tx*4..+3, two rows' loads in flight
  // at a time
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
    LstmCell4 cell[2];
    float dh[2][4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int b = min(b0 + ty * 4 + i0 + ii, B - 1);
      const float keep = 1.0f - a.resets[(size_t)t * B + b];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.0f;
#pragma unroll
        for (int pt = 0; pt < kParts; ++pt) v += dh_tile[(pt * kChainTile + ty * 4 + i0 + ii) * kChainLdB + tx * 4 + e];
        dh[ii][e] = v * keep;
      }
      if (t > 0) cell[ii] = lstm_cell_load4(a, s, t - 1, b, j);
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int b = b0 + ty * 4 + i0 + ii;
      if (b >= B) continue;
      if (t > 0) {
        lstm_cell_store4(a, s, t - 1, b, j, cell[ii], dh[ii]);
      } else {
        for (int e = 0; e < min(4, H - j); ++e) a.dh0[((size_t)s * B + b) * H + j + e] = dh[ii][e];
      }
    }
  }
}

// Phase 3. Grid (ceil(D/16), ceil(T*B/128), S), 256 threads: dx = dgates @
// Wxᵀ for 128 rows x 16 input columns; thread (ry, dq) owns rows ry*4..+3,
// columns dq*2, dq*2 + 1.
template <bool BF16>
__global__ void __launch_bounds__(256) lstm_dx_kernel(const LstmBwdArgs a) {
  __shared__ __align__(16) float As[kBwdK][kDxRows];
  __shared__ __align__(16) float Bs[kBwdK][kDxCols];
  const int tid = threadIdx.x, s = blockIdx.z;
  const int N = 4 * a.H, D = a.D, R = a.T * a.B;
  const int r0 = blockIdx.y * kDxRows, d0 = blockIdx.x * kDxCols;
  const float* g = a.gs + (size_t)s * R * N;
  const float* wx_s = a.wx + (size_t)s * D * N;
  const int ry = tid >> 3, dq = tid & 7;
  float acc[4][2] = {};
  for (int c0 = 0; c0 < N; c0 += kBwdK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = tid + 256 * j, r = slot >> 2, c = (slot & 3) * 4;
      float v[4];
      load4(g + (size_t)(r0 + r) * N + c0 + c, r0 + r < R && c0 + c < N, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) As[c + i][r] = op<BF16>(v[i]);
    }
    {
      const int d = tid >> 4, kk = tid & 15;
      Bs[kk][d] = d0 + d < D && c0 + kk < N ? op<BF16>(wx_s[(size_t)(d0 + d) * N + c0 + kk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBwdK; ++kk) {
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

template <bool BF16>
cudaError_t lstm_x_bwd_launch(const LstmBwdArgs& a, int S, cudaStream_t st) {
  const int R = a.T * a.B;
  const size_t gate_smem = (size_t)kGateStages * (kGateTile * (kBwdK + (BF16 ? 8 : 4)) + kBwdK * (kGateTile + 4)) * 4;
  cudaError_t err = allow_smem(lstm_gates_kernel<BF16>, gate_smem);
  if (err != cudaSuccess) return err;
  lstm_gates_kernel<BF16><<<dim3((4 * a.H + kGateTile - 1) / kGateTile, (R + kGateTile - 1) / kGateTile, S),
                            256, gate_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long cells = (long long)S * a.B * ((a.H + 3) / 4);
  lstm_dgates_init_kernel<<<(unsigned)(cells < 4096LL * 256 ? (cells + 255) / 256 : 4096), 256, 0, st>>>(a, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 chain((a.H + kChainTile - 1) / kChainTile, (a.B + kChainTile - 1) / kChainTile, S);
  auto chain_kernel = lstm_chain_kernel<BF16>;
  const size_t smem = (size_t)kChainStages * kChainStageFloats * sizeof(float);
  if ((err = allow_smem(chain_kernel, smem)) != cudaSuccess) return err;
  for (int t = a.T - 1; t >= 0; --t) {
    chain_kernel<<<chain, 256, smem, st>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.D > 0) {
    lstm_dx_kernel<BF16><<<dim3((a.D + kDxCols - 1) / kDxCols, (R + kDxRows - 1) / kDxRows, S), 256, 0, st>>>(a);
    err = cudaGetLastError();
  }
  return err;
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
  const LstmBwdArgs a{xs, resets, c0, h0, wx, wh, whT, bh, hs, cs, ghs, dx, dc0, dh0, gs, T, B, D, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? lstm_x_bwd_launch<true>(a, S, st) : lstm_x_bwd_launch<false>(a, S, st));
}

// The weight-gradient reduction of rnn_wgrad.cuh with the LSTM's gate
// gradients: C = Σ_rows [h_masked | x | 1]ᵀ [di|df|dg|do] = dWh | dWx | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_x_wgrad(const float* xs, const float* resets, const float* h0,
                            const float* hs, const float* gs, float* W, float* C, int S, int T,
                            int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, h0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, 0, stream);
}
