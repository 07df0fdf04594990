// The cluster forward shared by the GRU and LSTM x-streaming replays
// (sm_90a): gru_x_fwd (gru_x.cu) and lstm_x_fwd (lstm_x.cu).
//
// One persistent kernel over thread-block clusters of kCluster CTAs. A
// cluster owns a tile of batch rows of one stream for the whole window; each
// of its CTAs owns ceil(H / kCluster) hidden columns and every product column
// of them, so the cell update is local to the CTA (each thread re-reads the
// state it wrote a step earlier: the LSTM's c, the GRU's h). What bounded the
// one-column kernels this replaces was re-reading Wh (768 KiB fp32 for the
// GRU, 1 MiB for the LSTM at H=256) from L2 at every step for a few rows a
// block; here the CTA's slice of [Wh; Wx] stays in shared memory for all T
// steps (fp32 at H=256: 272 rows of 128 LSTM or 96 GRU columns, 148 / 113
// KB; bf16 mode: k-pairs rounded once when staged, half that), and its
// product at each step is a gate tile (rnn_common.cuh): fp32 register tiles
// on the CUDA cores, IEEE; bf16 mma.m16n8k16 with fp32 accumulation. Step t's
// h is exchanged through hs itself: every CTA writes its columns of hs[t], a
// cluster barrier (arrive.release / wait.acquire) orders the steps, and step
// t+1 streams its rows back from L2 through the tile's cp.async ring, masked
// by keep. Clusters never wait for each other, so correctness does not
// depend on how many are resident at once. The launcher sizes the grid from
// cudaOccupancyMaxActiveClusters: with Q clusters at once, each stream takes
// max(1, Q/S) of them and a cluster ceil(B / (Q/S)) rows, so S=1 and S=2 both
// fill one wave; the rows go through 128-row tiles and those past the last
// full one through a 64- or 32-row tile where that wastes less (an H100 runs
// 15 clusters of 8: 147 rows a cluster at S=2, B=1024, one 128-row and one
// 32-row tile; 69 at S=1, one 128-row tile). A cell with kOneTile (the GRU)
// takes a cluster's rows in one tile of 96 or 160 rows where they fit one
// (69 rows: 96; 147: 160), since each tile of a step pays the step's latency
// again (its k-loop's barriers, the ring's first copies, the epilogue's round
// trips): a 32-row tail tile costs about half a 128-row one. Where the slice
// does not fit a CTA's shared memory (the LSTM above H=256, the GRU's fp32
// mode above 256) the same kernel streams it from L2 through the ring at
// every step, chosen by shape; the streamed weights take 128-row tiles only.
// Bound: 2*T*S*B*
// (H+D)*G*H operations over the card (fp32 CUDA cores; in bf16 mode the
// tensor cores, where the h loads from L2 and the T barriers bound a step
// instead).
//
// The cell is the template policy (LstmFwdCell in lstm_x.cu, GruFwdCell in
// gru_x.cu): the width of a tile's product columns and how they map onto
// [Wh; Wx], where the x rows start, the bias a tile stages, and its Tile: the
// accumulators, the product of one k-tile, a hook at the first x k-tile and
// the epilogue's cell update.
// - LSTM: 128 columns a tile, the four gates of 32 hidden columns
//   interleaved (n = jj*4 + q), x right after h.
// - GRU: 96 columns a tile, r | z | n of 32 hidden columns; x starts at the
//   k-tile after h, and the n column's h part (u) is stashed when the x
//   k-tiles begin, so [Wh; Wx] has no zero block (see gru_x.cu).
#pragma once

#include "rnn_common.cuh"

namespace {

constexpr int kCluster = 8;      // CTAs of a cluster (the largest portable size)
constexpr int kFwdPad = 8;       // pad of a weight row: conflict-free bf16 fragments
constexpr int kFwdStages = 4;    // the ring of k-tiles
constexpr int kFwdTileHidden = 32;  // hidden columns of a tile

// Inputs and outputs of a forward; a cell reads the fields it has.
struct RnnFwdArgs {
  const float* xs;
  const float* resets;
  const float* c0;     // LSTM: the cell state entering step 0
  const float* h0;     // the hidden state entering step 0 (the GRU's carry0)
  const float* wx;
  const float* wh;
  const float* bias;   // LSTM: bh [S,4H]; GRU: bx [S,3H]
  const float* bias2;  // GRU: bhn [S,H]
  float* hs;
  float* cs;           // LSTM: the cell states
  int T, B, D, H;
  int rows;     // batch rows of a cluster
  int hc;       // hidden columns of a CTA (the last ones may own fewer)
  int n_tiles;  // tiles of kFwdTileHidden hidden columns a CTA
  int kp;       // operand rows (h, then x from Cell::x_start(H)), rounded up to k-tiles
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Rows of a stage's [h | x] tile: 128, or 192 for the 160-row tile (the
// copies fill whole groups of 64 rows, GateRows).
__host__ __device__ constexpr int fwd_stage_rows(int tile) { return tile > 128 ? 192 : 128; }

// A stage of the ring: a kRows-row [h | x] tile and (streamed) a weight tile.
template <class Cell, bool BF16, bool kResident>
__host__ __device__ constexpr int fwd_stage_floats(int rows) {
  return rows * gate_lda<BF16>() + (kResident ? 0 : kGateK * (Cell::kTileCols + kFwdPad));
}

// Shared memory: the resident [Wh; Wx] slice (fp32 rows or bf16 k-pairs,
// n_tiles*kTileCols + kFwdPad a row), the bias (128 a tile), the ring of
// stages of stage_rows rows.
template <class Cell, bool BF16, bool kResident>
__host__ __device__ int fwd_smem_floats(int kp, int n_tiles, int stage_rows) {
  const int ld = n_tiles * Cell::kTileCols + kFwdPad;
  return (kResident ? (BF16 ? kp / 2 : kp) * ld : 0) + n_tiles * kGateCols +
         kFwdStages * fwd_stage_floats<Cell, BF16, kResident>(stage_rows);
}

// What a CTA owns: stream s, batch rows [rb0, rb1), hidden columns [j0, j0+hc)
// and their weights and bias in shared memory (w, bias, ld a weight row); the
// k-tiles of a step and the first of its x rows.
struct FwdCta {
  int s, rb0, rb1, j0, hc, ld, n_kt, kt_x;
  const float* w;
  const float* bias;
  float* ring;
};

// Step t at rows m0.. (kTM of them, those below rb1) and the CTA's tile nt,
// over a ring of kRows-row stages: the product over the ring, then the cell
// update at the thread's cells.
template <class Cell, int kTM, bool BF16, bool kResident, int kRows>
__device__ __forceinline__ void fwd_tile(const RnnFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
  constexpr int kStage = fwd_stage_floats<Cell, BF16, kResident>(kRows);
  constexpr int kStageA = kRows * gate_lda<BF16>();
  constexpr int kLdBs = Cell::kTileCols + kFwdPad;  // a streamed weight tile's row
  const int tid = threadIdx.x, H = a.H, B = a.B, x0 = Cell::x_start(H);
  GateRows<kTM> rows;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    const int rr = (tid >> 2) + 64 * r, b = m0 + rr;
    const bool ok = b < c.rb1 && (!GateRows<kTM>::kPartial || rr < kTM);
    rows.set(r, ok, c.s, t, ok ? b : c.rb0, a.h0, a.hs, a.xs, a.resets, a.T, B, a.D, H);
  }
  auto issue = [&](int kt) {
    float* As = c.ring + (kt % kFwdStages) * kStage;
    gate_issue_a<kTM, BF16>(rows, As, kt, H, x0, x0 + a.D, a.hs);
    if constexpr (!kResident) {
#pragma unroll
      for (int r = 0; r < kGateK * Cell::kTileCols / 256; ++r) {
        const int e = tid + 256 * r, kr = e / Cell::kTileCols, n = e % Cell::kTileCols;
        const float* w = Cell::weight(a, c.s, c.j0, c.hc, kt * kGateK + kr, nt * Cell::kTileCols + n);
        cp_async4(As + kStageA + kr * kLdBs + n, w ? w : a.hs, w != nullptr);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < c.n_kt) issue(st);
    cp_async_commit();
  }
  typename Cell::template Tile<kTM, BF16> tile = {};
  for (int kt = 0; kt < c.n_kt; ++kt) {
    cp_async_wait<kFwdStages - 2>();
    float* As = c.ring + (kt % kFwdStages) * kStage;
    gate_fix_keep<kTM, BF16>(rows, As, kt, H);
    __syncthreads();  // tile kt is in and masked; the stage refilled below was read at kt - 1
    if (kt + kFwdStages - 1 < c.n_kt) issue(kt + kFwdStages - 1);
    cp_async_commit();
    if (kt == c.kt_x) tile.at_x();
    if constexpr (!kResident) {
      tile.step(As, GateB32{As + kStageA, kLdBs});
    } else if constexpr (BF16) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(c.w);
      tile.step(As, GateB16{w + kt * (kGateK / 2) * c.ld + nt * Cell::kTileCols, c.ld});
    } else {
      tile.step(As, GateB32{c.w + kt * kGateK * c.ld + nt * Cell::kTileCols, c.ld});
    }
  }
  if (c.kt_x >= c.n_kt) tile.at_x();  // no x k-tile (D = 0)
  cp_async_wait<0>();
  tile.epilogue(a, c, t, m0, nt);
  __syncthreads();  // the ring is refilled by the next tile
}

// Grid (clusters * kCluster), clusters of kCluster along x, 256 threads. A
// cluster's rows go through 128-row tiles and the rows past the last full one
// through tiles of kTail rows (128, 64 or 32, chosen by the launcher from the
// rows of a cluster), so that a share of the batch that is no multiple of 128
// wastes little of a step; one kernel holds at most two tile sizes (each more
// costs registers and spills). kTail = 96 or 160 (kOneTile cells): all the
// cluster's rows in one tile of kTail rows.
template <class Cell, bool BF16, bool kResident, int kTail>
__global__ void __launch_bounds__(256, 1) rnn_x_fwd_kernel(const RnnFwdArgs a) {
  constexpr int kRows = fwd_stage_rows(kTail);
  constexpr bool kOne = kTail == 96 || kTail == 160;
  extern __shared__ __align__(16) float fwd_smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kCluster, cluster = blockIdx.x / kCluster;
  const int H = a.H, B = a.B;
  const int per_stream = (B + a.rows - 1) / a.rows;
  FwdCta c;
  c.s = cluster / per_stream;
  c.rb0 = (cluster - c.s * per_stream) * a.rows;
  c.rb1 = min(B, c.rb0 + a.rows);
  c.j0 = rank * a.hc;
  c.hc = max(0, min(H - c.j0, a.hc));
  c.ld = a.n_tiles * Cell::kTileCols + kFwdPad;
  c.n_kt = a.kp / kGateK;
  c.kt_x = Cell::x_start(H) / kGateK;
  float* bias_s = fwd_smem + (kResident ? (BF16 ? a.kp / 2 : a.kp) * c.ld : 0);
  c.w = fwd_smem;
  c.bias = bias_s;
  c.ring = bias_s + a.n_tiles * kGateCols;
  const int n_tiles = c.hc > 0 ? a.n_tiles : 0;

  // stage the CTA's bias and (resident) its slice of [Wh; Wx] once; the first
  // barrier of the k-loop orders these stores before any read
  for (int n = tid; n < a.n_tiles * kGateCols; n += 256) bias_s[n] = Cell::bias(a, c.s, c.j0, c.hc, n);
  if constexpr (kResident) {
    const int rows_w = BF16 ? a.kp / 2 : a.kp;
    for (int e = tid; e < rows_w * c.ld; e += 256) {
      const int r = e / c.ld, n = e - r * c.ld;
      if constexpr (BF16) {
        const float* lo = Cell::weight(a, c.s, c.j0, c.hc, 2 * r, n);
        const float* hi = Cell::weight(a, c.s, c.j0, c.hc, 2 * r + 1, n);
        reinterpret_cast<uint32_t*>(fwd_smem)[e] = pack_bf16(lo ? *lo : 0.0f, hi ? *hi : 0.0f);
      } else {
        const float* w = Cell::weight(a, c.s, c.j0, c.hc, r, n);
        fwd_smem[e] = w ? *w : 0.0f;
      }
    }
  }

  for (int t = 0; t < a.T; ++t) {
    if constexpr (kOne) {
      for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<Cell, kTail, BF16, kResident, kRows>(a, c, t, c.rb0, nt);
    } else {
      int m0 = c.rb0;
      for (; m0 + 128 <= c.rb1 || (kTail == 128 && m0 < c.rb1); m0 += 128)
        for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<Cell, 128, BF16, kResident, kRows>(a, c, t, m0, nt);
      if constexpr (kTail < 128) {
        for (; m0 < c.rb1; m0 += kTail)
          for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<Cell, kTail, BF16, kResident, kRows>(a, c, t, m0, nt);
      }
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
  int tail;      // rows of the tiles past the last full 128-row one (96, 160: of the one tile)
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

template <class Cell, bool BF16, bool kResident>
cudaError_t fwd_active_clusters(size_t smem, int* clusters) {
  auto kernel = rnn_x_fwd_kernel<Cell, BF16, kResident, 128>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <class Cell, bool BF16>
cudaError_t fwd_plan(int S, int B, int D, int H, RnnFwdArgs& a, FwdPlan& p) {
  a.hc = (H + kCluster - 1) / kCluster;
  a.n_tiles = (a.hc + kFwdTileHidden - 1) / kFwdTileHidden;
  a.kp = (Cell::x_start(H) + D + kGateK - 1) / kGateK * kGateK;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t res_smem = (size_t)fwd_smem_floats<Cell, BF16, true>(a.kp, a.n_tiles, 128) * sizeof(float);
  p.resident = res_smem <= (size_t)max_smem;
  p.smem = p.resident ? res_smem : (size_t)fwd_smem_floats<Cell, BF16, false>(a.kp, a.n_tiles, 128) * sizeof(float);
  p.clusters = 0;
  err = p.resident ? fwd_active_clusters<Cell, BF16, true>(p.smem, &p.clusters)
                   : fwd_active_clusters<Cell, BF16, false>(p.smem, &p.clusters);
  if (err != cudaSuccess) return err;
  if (p.clusters < 1) return cudaErrorInvalidConfiguration;
  const int per_stream = max(1, p.clusters / S);
  a.rows = p.rows = (B + per_stream - 1) / per_stream;
  p.grid = S * ((B + p.rows - 1) / p.rows);
  const int tail = p.rows % 128;
  p.tail = tail == 0 || tail > 64 ? 128 : tail > 32 ? 64 : 32;
  if (Cell::kOneTile && p.resident && p.rows > 64 && p.rows <= 160) {
    // one tile takes the cluster's rows (the weights streamed from L2 take
    // 128-row tiles only); 160 rows need 192-row stages, where they fit
    const size_t wide = (size_t)fwd_smem_floats<Cell, BF16, true>(a.kp, a.n_tiles, 192) * sizeof(float);
    int wide_clusters = 0;
    if (p.rows <= 96) {
      p.tail = 96;
    } else if (p.rows > 128 && wide <= (size_t)max_smem &&
               fwd_active_clusters<Cell, BF16, true>(wide, &wide_clusters) == cudaSuccess &&
               wide_clusters >= p.clusters) {
      p.tail = 160;
      p.smem = wide;
    }
  }
  return cudaSuccess;
}

template <class Cell, bool BF16, bool kResident, int kTail>
cudaError_t fwd_run(const RnnFwdArgs& a, const FwdPlan& p, cudaStream_t st) {
  auto kernel = rnn_x_fwd_kernel<Cell, BF16, kResident, kTail>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config((unsigned)p.grid, p.smem, st, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <class Cell, bool BF16>
cudaError_t rnn_x_fwd_launch(RnnFwdArgs a, int S, cudaStream_t st) {
  FwdPlan p;
  cudaError_t err = fwd_plan<Cell, BF16>(S, a.B, a.D, a.H, a, p);
  if (err != cudaSuccess) return err;
  if (!p.resident) return fwd_run<Cell, BF16, false, 128>(a, p, st);
  if constexpr (Cell::kOneTile) {
    if (p.tail == 96) return fwd_run<Cell, BF16, true, 96>(a, p, st);
    if (p.tail == 160) return fwd_run<Cell, BF16, true, 160>(a, p, st);
  }
  if (p.tail == 32) return fwd_run<Cell, BF16, true, 32>(a, p, st);
  if (p.tail == 64) return fwd_run<Cell, BF16, true, 64>(a, p, st);
  return fwd_run<Cell, BF16, true, 128>(a, p, st);
}

// The forward's grid for these shapes on the current card: out[0] clusters
// the card runs at once, out[1] batch rows a cluster owns, out[2] clusters
// launched, out[3] 1 where the weight slices stay in shared memory, out[4]
// the rows of the tiles past the last full 128-row one (96, 160: of the one
// tile that takes a cluster's rows).
template <class Cell>
int rnn_x_fwd_plan(int S, int B, int D, int H, int bf16, int* out) {
  if (bad_dims(S, 1, B, D, H) || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  RnnFwdArgs a{};
  FwdPlan p;
  const cudaError_t err = bf16 ? fwd_plan<Cell, true>(S, B, D, H, a, p) : fwd_plan<Cell, false>(S, B, D, H, a, p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.clusters;
  out[1] = p.rows;
  out[2] = p.grid;
  out[3] = p.resident;
  out[4] = p.tail;
  return 0;
}

}  // namespace
