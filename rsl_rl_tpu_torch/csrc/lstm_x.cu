// LSTM window replay with done-masked resets, for Hopper (sm_90a).
//
// Replaces the Pallas x-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_x_fwd    <- _lstm_fwd_kernel_x_pair (S=2) and _lstm_fwd_kernel_x (S=1)
//   lstm_x_bwd    <- _lstm_bwd_kernel_x_pair / _lstm_bwd_kernel_x: the BPTT chain,
//                    in the three phases of rnn_bwd.cuh with the LSTM cell
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
// math is IEEE fp32 on the CUDA cores; bf16-mode products run on the tensor
// cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (lstm_x_fwd one,
// lstm_x_bwd T+3, lstm_x_wgrad one or two), allocates nothing, and returns the
// cudaError_t of the launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_wgrad.cuh"

namespace {

// ------------------------------------------------------------------ forward
//
// One persistent kernel over thread-block clusters of kCluster CTAs. A
// cluster owns a tile of batch rows of one stream for the whole window; each
// of its CTAs owns ceil(H / kCluster) hidden columns and all four gates of
// them (gate columns interleaved, n = jj*4 + q), so the cell update is local
// to the CTA and c never leaves it (each thread re-reads the c it wrote a
// step earlier). What bounded the kernel this replaces was re-reading Wh
// (1 MiB fp32 at H=256) from L2 at every step for 8 rows a block; here the
// CTA's slice of [Wh; Wx] stays in shared memory for all T steps (fp32 at
// H=256: 272 x 136 floats, 148 KB; bf16 mode: k-pairs rounded once when
// staged, 74 KB), and its product at each step is the gate tile of
// rnn_common.cuh: fp32 register tiles on the CUDA cores, IEEE; bf16
// mma.m16n8k16 with fp32 accumulation. Step t's h is exchanged through hs
// itself: every CTA writes its columns of hs[t], a cluster barrier
// (arrive.release / wait.acquire) orders the steps, and step t+1 streams its
// rows back from L2 through the gate tile's cp.async ring, masked by keep. Clusters never wait for each other, so
// correctness does not depend on how many are resident at once. The launcher
// sizes the grid from cudaOccupancyMaxActiveClusters: with Q clusters at
// once, each stream takes max(1, Q/S) of them and a cluster ceil(B / (Q/S))
// rows, so S=1 and S=2 both fill one wave; the rows go through 128-row tiles
// and those past the last full one through a 64- or 32-row tile where that
// wastes less (an H100 runs 15 clusters of 8: 147 rows a cluster at S=2,
// B=1024, one 128-row and one 32-row tile; 69 at S=1, one 128-row tile). The
// weights streamed from L2 (below) take 128-row tiles only. Where
// the slice does not fit a CTA's shared memory (H > 256) the same kernel
// streams it from L2 through the ring at every step, chosen by shape. Bound: 2*T*S*B*(H+D)*4H operations over the card (fp32 CUDA
// cores; in bf16 mode the tensor cores, where the h loads from L2 and the T
// barriers bound a step instead).

constexpr int kCluster = 8;  // CTAs of a cluster (the largest portable size)
constexpr int kFwdPad = 8;   // pad of a weight row: conflict-free bf16 fragments

struct LstmFwdArgs {
  const float* xs;
  const float* resets;
  const float* c0;
  const float* h0;
  const float* wx;
  const float* wh;
  const float* bh;
  float* hs;
  float* cs;
  int T, B, D, H;
  int rows;     // batch rows of a cluster
  int hc;       // hidden columns of a CTA (the last ones may own fewer)
  int n_tiles;  // 128-column tiles of a CTA's 4*hc gate columns
  int kp;       // operand rows H+D, rounded up to k-tiles
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Operand row k of [Wh; Wx] at gate column n of the CTA whose hidden columns
// start at j0 (gate q = n % 4 of hidden column j0 + n / 4), or nullptr where
// the value is zero (past the CTA's columns or the operand rows).
__device__ __forceinline__ const float* fwd_weight(const LstmFwdArgs& a, int s, int j0, int hc, int k, int n) {
  const int jj = n >> 2, H = a.H;
  if (jj >= hc || k >= H + a.D) return nullptr;
  const int col = (n & 3) * H + j0 + jj;
  return k < H ? a.wh + ((size_t)s * H + k) * 4 * H + col : a.wx + ((size_t)s * a.D + k - H) * 4 * H + col;
}

// Cell c of a thread's part of the gate tile: its tile row and hidden column
// (of the tile's 32). fp32: rows gate_row_of(ty, c/2), hidden columns tx and
// 16 + tx, gates acc[c/2][4*(c%2) + q]; bf16: of n8 tile c%4 of m16 tile c/4,
// row g (even lanes) or g + 8 (odd lanes), gates acc[c/4][c%4][q] once the
// lane pairs have swapped halves (fwd_gather_gates).
template <int kTM, bool BF16>
__device__ __forceinline__ void fwd_cell(int c, int& row, int& jj) {
  const int tid = threadIdx.x;
  if constexpr (BF16) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
    row = (warp >> 2) * (kTM / 2) + 16 * (c >> 2) + g + 8 * (q & 1);
    jj = (warp & 3) * 8 + 2 * (c & 3) + (q >> 1);
  } else {
    row = gate_row_of<kTM>(tid >> 4, c >> 1);
    jj = (c & 1) * 16 + (tid & 15);
  }
}

// bf16: lane pairs (q, q^1) hold gates 0,1 and 2,3 of the same hidden column
// for rows g and g + 8; they swap halves so that each holds all four gates of
// one row.
template <int kTM>
__device__ __forceinline__ void fwd_gather_gates(GateAcc<kTM, true>& acc) {
  const bool odd = threadIdx.x & 1;
#pragma unroll
  for (int i = 0; i < kTM / 32; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* v = acc[i][j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      if (odd) {
        v[0] = r0;
        v[1] = r1;
      } else {
        v[2] = r0;
        v[3] = r1;
      }
    }
}

template <int kTM, bool BF16>
__device__ __forceinline__ float fwd_gate(const GateAcc<kTM, BF16>& acc, int c, int q) {
  if constexpr (BF16) {
    return acc[c >> 2][c & 3][q];
  } else {
    return acc[c >> 1][4 * (c & 1) + q];
  }
}

// The ring of k-tiles.
constexpr int kFwdStages = 4;

// A stage of the ring: a 128-row [h | x] tile and (streamed) a weight tile.
template <bool BF16, bool kResident>
__host__ __device__ constexpr int fwd_stage_floats() {
  return 128 * gate_lda<BF16>() + (kResident ? 0 : kGateK * (kGateCols + kFwdPad));
}

// Shared memory: the resident [Wh; Wx] slice (fp32 rows or bf16 k-pairs,
// n_tiles*128 + kFwdPad a row), the bias of the CTA's gate columns, the ring.
template <bool BF16, bool kResident>
__host__ __device__ int fwd_smem_floats(int kp, int n_tiles) {
  const int ld = n_tiles * kGateCols + kFwdPad;
  return (kResident ? (BF16 ? kp / 2 : kp) * ld : 0) + n_tiles * kGateCols +
         kFwdStages * fwd_stage_floats<BF16, kResident>();
}

// What a CTA owns: stream s, batch rows [rb0, rb1), hidden columns [j0, j0+hc)
// and their weights and bias in shared memory (w, bias, ld a weight row).
struct FwdCta {
  int s, rb0, rb1, j0, hc, ld, n_kt;
  const float* w;
  const float* bias;
  float* ring;
};

// Step t at rows m0.. (kTM of them, those below rb1) and the CTA's gate
// columns nt*128..: the product over the ring, then the cell update at the
// thread's cells, written to hs[t] and cs[t].
template <int kTM, bool BF16, bool kResident>
__device__ __forceinline__ void fwd_tile(const LstmFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
  constexpr int kStage = fwd_stage_floats<BF16, kResident>();
  constexpr int kStageA = 128 * gate_lda<BF16>();
  constexpr int kLdBs = kGateCols + kFwdPad;  // a streamed weight tile's row
  constexpr int kCells = kTM / 8;
  const int tid = threadIdx.x, H = a.H, B = a.B, K = H + a.D;
  GateRows<kTM> rows;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    const int b = m0 + (tid >> 2) + 64 * r;
    rows.set(r, b < c.rb1, c.s, t, b < c.rb1 ? b : c.rb0, a.h0, a.hs, a.xs, a.resets, a.T, B, a.D, H);
  }
  auto issue = [&](int kt) {
    float* As = c.ring + (kt % kFwdStages) * kStage;
    gate_issue_a<kTM, BF16>(rows, As, kt, H, K, a.hs);
    if constexpr (!kResident) {
#pragma unroll
      for (int r = 0; r < kGateK * kGateCols / 256; ++r) {
        const int e = tid + 256 * r, kr = e >> 7, n = e & (kGateCols - 1);
        const float* w = fwd_weight(a, c.s, c.j0, c.hc, kt * kGateK + kr, nt * kGateCols + n);
        cp_async4(As + kStageA + kr * kLdBs + n, w ? w : a.hs, w != nullptr);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < c.n_kt) issue(st);
    cp_async_commit();
  }
  GateAcc<kTM, BF16> acc = {};
  for (int kt = 0; kt < c.n_kt; ++kt) {
    cp_async_wait<kFwdStages - 2>();
    float* As = c.ring + (kt % kFwdStages) * kStage;
    gate_fix_keep<kTM, BF16>(rows, As, kt, H);
    __syncthreads();  // tile kt is in and masked; the stage refilled below was read at kt - 1
    if (kt + kFwdStages - 1 < c.n_kt) issue(kt + kFwdStages - 1);
    cp_async_commit();
    if constexpr (!kResident) {
      gate_tile_step<kTM, BF16>(acc, As, GateB32{As + kStageA, kLdBs});
    } else if constexpr (BF16) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(c.w);
      gate_tile_step<kTM, BF16>(acc, As, GateB16{w + kt * (kGateK / 2) * c.ld + nt * kGateCols, c.ld});
    } else {
      gate_tile_step<kTM, BF16>(acc, As, GateB32{c.w + kt * kGateK * c.ld + nt * kGateCols, c.ld});
    }
  }
  cp_async_wait<0>();

  // the cell update at the thread's cells: the carried c and keep are loaded
  // here, not ahead of the product, where they would hold registers through it
  float c_prev[kCells], keep[kCells];
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    int row, jj;
    fwd_cell<kTM, BF16>(e, row, jj);
    const int b = m0 + row, j = c.j0 + nt * 32 + jj;
    const bool on = b < c.rb1 && nt * 32 + jj < c.hc;
    keep[e] = on ? 1.0f - a.resets[(size_t)t * B + b] : 0.0f;
    c_prev[e] = !on ? 0.0f
                    : t == 0 ? a.c0[((size_t)c.s * B + b) * H + j]
                             : a.cs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j];
  }
  if constexpr (BF16) fwd_gather_gates<kTM>(acc);
  const float* bias = c.bias + nt * kGateCols;
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    int row, jj;
    fwd_cell<kTM, BF16>(e, row, jj);
    const int b = m0 + row;
    if (b >= c.rb1 || nt * 32 + jj >= c.hc) continue;
    const float i = sigmoid(fwd_gate<kTM, BF16>(acc, e, 0) + bias[jj * 4]);
    const float f = sigmoid(fwd_gate<kTM, BF16>(acc, e, 1) + bias[jj * 4 + 1]);
    const float g = tanhf(fwd_gate<kTM, BF16>(acc, e, 2) + bias[jj * 4 + 2]);
    const float o = sigmoid(fwd_gate<kTM, BF16>(acc, e, 3) + bias[jj * 4 + 3]);
    const float cell = f * (c_prev[e] * keep[e]) + i * g;
    const size_t out = (((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * 32 + jj;
    a.cs[out] = cell;
    a.hs[out] = o * tanhf(cell);
  }
  __syncthreads();  // the ring is refilled by the next tile
}

// Grid (clusters * kCluster), clusters of kCluster along x, 256 threads. A
// cluster's rows go through 128-row tiles and the rows past the last full one
// through tiles of kTail rows (128, 64 or 32, chosen by the launcher from the
// rows of a cluster), so that a share of the batch that is no multiple of 128
// wastes little of a step; one kernel holds at most two tile sizes (each more
// costs registers and spills).
template <bool BF16, bool kResident, int kTail>
__global__ void __launch_bounds__(256, 1) lstm_x_fwd_kernel(const LstmFwdArgs a) {
  extern __shared__ __align__(16) float fwd_smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kCluster, cluster = blockIdx.x / kCluster;
  const int H = a.H, B = a.B, G4 = 4 * H;
  const int per_stream = (B + a.rows - 1) / a.rows;
  FwdCta c;
  c.s = cluster / per_stream;
  c.rb0 = (cluster - c.s * per_stream) * a.rows;
  c.rb1 = min(B, c.rb0 + a.rows);
  c.j0 = rank * a.hc;
  c.hc = max(0, min(H - c.j0, a.hc));
  c.ld = a.n_tiles * kGateCols + kFwdPad;
  c.n_kt = a.kp / kGateK;
  float* bias_s = fwd_smem + (kResident ? (BF16 ? a.kp / 2 : a.kp) * c.ld : 0);
  c.w = fwd_smem;
  c.bias = bias_s;
  c.ring = bias_s + a.n_tiles * kGateCols;
  const int n_tiles = c.hc > 0 ? a.n_tiles : 0;

  // stage the CTA's bias and (resident) its slice of [Wh; Wx] once; the first
  // barrier of the k-loop orders these stores before any read
  for (int n = tid; n < a.n_tiles * kGateCols; n += 256) {
    bias_s[n] = (n >> 2) < c.hc ? a.bh[(size_t)c.s * G4 + (n & 3) * H + c.j0 + (n >> 2)] : 0.0f;
  }
  if constexpr (kResident) {
    const int rows_w = BF16 ? a.kp / 2 : a.kp;
    for (int e = tid; e < rows_w * c.ld; e += 256) {
      const int r = e / c.ld, n = e - r * c.ld;
      if constexpr (BF16) {
        const float* lo = fwd_weight(a, c.s, c.j0, c.hc, 2 * r, n);
        const float* hi = fwd_weight(a, c.s, c.j0, c.hc, 2 * r + 1, n);
        reinterpret_cast<uint32_t*>(fwd_smem)[e] = pack_bf16(lo ? *lo : 0.0f, hi ? *hi : 0.0f);
      } else {
        const float* w = fwd_weight(a, c.s, c.j0, c.hc, r, n);
        fwd_smem[e] = w ? *w : 0.0f;
      }
    }
  }

  for (int t = 0; t < a.T; ++t) {
    int m0 = c.rb0;
    for (; m0 + 128 <= c.rb1 || (kTail == 128 && m0 < c.rb1); m0 += 128)
      for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<128, BF16, kResident>(a, c, t, m0, nt);
    if constexpr (kTail < 128) {
      for (; m0 < c.rb1; m0 += kTail)
        for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<kTail, BF16, kResident>(a, c, t, m0, nt);
    }
    if (t + 1 < a.T) cluster_sync();  // hs[t] of the whole cluster is in before step t+1 reads it
  }
}

// The grid of a forward launch, chosen from the card (see the note above).
struct FwdPlan {
  int clusters;  // clusters the card runs at once
  int rows;      // batch rows of a cluster
  int grid;      // clusters launched
  int resident;  // the [Wh; Wx] slices stay in shared memory
  int tail;      // rows of the tiles past the last full 128-row one
  size_t smem;
};

cudaLaunchConfig_t cluster_config(unsigned clusters, size_t smem, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool BF16, bool kResident>
cudaError_t fwd_active_clusters(size_t smem, int* clusters) {
  auto kernel = lstm_x_fwd_kernel<BF16, kResident, 128>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <bool BF16>
cudaError_t fwd_plan(int S, int B, int D, int H, LstmFwdArgs& a, FwdPlan& p) {
  a.hc = (H + kCluster - 1) / kCluster;
  a.n_tiles = (4 * a.hc + kGateCols - 1) / kGateCols;
  a.kp = (H + D + kGateK - 1) / kGateK * kGateK;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t res_smem = (size_t)fwd_smem_floats<BF16, true>(a.kp, a.n_tiles) * sizeof(float);
  p.resident = res_smem <= (size_t)max_smem;
  p.smem = p.resident ? res_smem : (size_t)fwd_smem_floats<BF16, false>(a.kp, a.n_tiles) * sizeof(float);
  p.clusters = 0;
  err = p.resident ? fwd_active_clusters<BF16, true>(p.smem, &p.clusters)
                   : fwd_active_clusters<BF16, false>(p.smem, &p.clusters);
  if (err != cudaSuccess) return err;
  if (p.clusters < 1) return cudaErrorInvalidConfiguration;
  const int per_stream = max(1, p.clusters / S);
  a.rows = p.rows = (B + per_stream - 1) / per_stream;
  p.grid = S * ((B + p.rows - 1) / p.rows);
  const int tail = p.rows % 128;
  p.tail = tail == 0 || tail > 64 ? 128 : tail > 32 ? 64 : 32;
  return cudaSuccess;
}

template <bool BF16, bool kResident, int kTail>
cudaError_t fwd_run(const LstmFwdArgs& a, const FwdPlan& p, cudaStream_t st) {
  auto kernel = lstm_x_fwd_kernel<BF16, kResident, kTail>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config((unsigned)p.grid, p.smem, st, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <bool BF16>
cudaError_t lstm_x_fwd_launch(LstmFwdArgs a, int S, cudaStream_t st) {
  FwdPlan p;
  cudaError_t err = fwd_plan<BF16>(S, a.B, a.D, a.H, a, p);
  if (err != cudaSuccess) return err;
  if (!p.resident) return fwd_run<BF16, false, 128>(a, p, st);
  if (p.tail == 32) return fwd_run<BF16, true, 32>(a, p, st);
  if (p.tail == 64) return fwd_run<BF16, true, 64>(a, p, st);
  return fwd_run<BF16, true, 128>(a, p, st);
}

// ------------------------------------------------------------------ backward
//
// The LSTM cell of rnn_bwd.cuh's three phases: gs holds i|f|g|o after phase
// 1 and di|df|dg|do after the chain; the carry is dc.
struct LstmCell {
  static constexpr int kGates = 4;  // gate blocks of Wx (dx takes all 4H columns)

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
  __device__ __forceinline__ static float gate_out(const RnnBwdArgs& a, int s, int col, float v) {
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
    x.keep = 1.0f - a.resets[(size_t)t * a.B + b];
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
  __device__ __forceinline__ static void dh_prev(const RnnBwdArgs& a, int, int t, int b, int,
                                                 const float (&prod)[4], float (&dh)[4]) {
    const float keep = 1.0f - a.resets[(size_t)t * a.B + b];
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = prod[e] * keep;
  }

  // t = 0: dh0 (dc0 is the carry buffer already)
  __device__ __forceinline__ static void finish(const RnnBwdArgs& a, int s, int b, int j, const float (&dh)[4]) {
    for (int e = 0; e < min(4, a.H - j); ++e) a.dh0[((size_t)s * a.B + b) * a.H + j + e] = dh[e];
  }
};

}  // namespace

extern "C" int lstm_x_fwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* bh,
                          float* hs, float* cs, int S, int T, int B, int D, int H, int bf16,
                          void* stream) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const LstmFwdArgs a{xs, resets, c0, h0, wx, wh, bh, hs, cs, T, B, D, H, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? lstm_x_fwd_launch<true>(a, S, st) : lstm_x_fwd_launch<false>(a, S, st));
}

// The forward's grid for these shapes on the current card: out[0] clusters
// the card runs at once, out[1] batch rows a cluster owns, out[2] clusters
// launched, out[3] 1 where the weight slices stay in shared memory.
extern "C" int lstm_x_fwd_plan(int S, int B, int D, int H, int bf16, int* out) {
  if (bad_dims(S, 1, B, D, H) || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  LstmFwdArgs a{};
  FwdPlan p;
  const cudaError_t err = bf16 ? fwd_plan<true>(S, B, D, H, a, p) : fwd_plan<false>(S, B, D, H, a, p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.clusters;
  out[1] = p.rows;
  out[2] = p.grid;
  out[3] = p.resident;
  return 0;
}

// phase_ms: nullptr, or three floats that receive the milliseconds of the
// three phases (the call then waits for the stream).
extern "C" int lstm_x_bwd(const float* xs, const float* resets, const float* c0,
                          const float* h0, const float* wx, const float* wh, const float* whT,
                          const float* bh, const float* hs, const float* cs, const float* ghs,
                          float* dx, float* dc0, float* dh0, float* gs, int S, int T, int B,
                          int D, int H, int bf16, void* stream, float* phase_ms) {
  if (bad_dims(S, T, B, D, H)) return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0 || B == 0) return 0;
  const RnnBwdArgs a{xs, resets, c0, h0, wx, wh, whT, bh, nullptr, hs, cs, ghs, dx, dc0, dh0, gs, T, B, D, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_bwd_launch<LstmCell, true>(a, S, st, phase_ms)
                    : rnn_bwd_launch<LstmCell, false>(a, S, st, phase_ms));
}

// The weight-gradient reduction of rnn_wgrad.cuh with the LSTM's gate
// gradients: C = Σ_rows [h_masked | x | 1]ᵀ [di|df|dg|do] = dWh | dWx | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_x_wgrad(const float* xs, const float* resets, const float* h0,
                            const float* hs, const float* gs, float* W, float* C, int S, int T,
                            int B, int D, int H, int P, int bf16, void* stream) {
  return rnn_wgrad_launch(xs, resets, h0, hs, gs, W, C, S, T, B, D, H, P, bf16, 0, 0, stream);
}
