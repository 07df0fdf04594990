// The cluster forward shared by the GRU and LSTM replays (sm_90a): gru_x_fwd
// (gru_x.cu), lstm_x_fwd (lstm_x.cu) and lstm_xp_fwd (lstm_xp.cu).
//
// One persistent kernel over thread-block clusters of kCluster CTAs. A
// cluster owns a tile of batch rows of one stream for the whole window; each
// of its CTAs owns ceil(H / kCluster) hidden columns and every product column
// of them, so the cell update is local to the CTA (each thread re-reads the
// state it wrote a step earlier: the LSTM's c, the GRU's h). What bounded the
// one-column kernels this replaces was re-reading Wh (768 KiB fp32 for the
// GRU, 1 MiB for the LSTM at H=256) from L2 at every step for a few rows a
// block; here the CTA's slice of [Wh; Wx] stays in shared memory for all T
// steps (fp32 at H=256: 272 rows of 128 LSTM or 96 GRU columns, 148 / 113 KB;
// bf16 mode: k-pairs rounded once when staged, half that), and its product at
// each step is a gate tile (rnn_common.cuh): fp32 register tiles on the CUDA
// cores, IEEE; bf16 mma.m16n8k16 with fp32 accumulation. Step t's h is
// exchanged through hs itself: every CTA writes its columns of hs[t], a
// cluster barrier (arrive.release / wait.acquire) orders the steps, and step
// t+1 streams its rows back from L2 through the tile's cp.async ring, masked
// by keep. Clusters never wait for each other, so correctness does not
// depend on how many are resident at once. The launcher sizes the grid from
// cudaOccupancyMaxActiveClusters: with Q clusters at once, each stream takes
// max(1, Q/S) of them and a cluster ceil(B / (Q/S)) rows, so S=1 and S=2 both
// fill one wave; the rows go through 128-row tiles and those past the last
// full one through a 64- or 32-row tile where that wastes less (an H100 runs
// 15 clusters of 8: 147 rows a cluster at S=2, B=1024, one 128-row and one
// 32-row tile; 69 at S=1, one 128-row tile). A cell with one_tile (the GRU)
// takes a cluster's rows in one tile of 96 or 160 rows where they fit one
// (69 rows: 96; 147: 160), since each tile of a step pays the step's latency
// again (its k-loop's barriers, the ring's first copies, the epilogue's round
// trips): a 32-row tail tile costs about half a 128-row one. Where the slice
// does not fit a CTA's shared memory (the LSTM above H=256, the GRU's fp32
// mode above 256) the same kernel streams it from L2 through the ring at
// every step, chosen by shape; the streamed weights take 128-row tiles only.
// Bound: 2*T*S*B*(H+D)*G*H operations over the card (fp32 CUDA cores; in bf16
// mode the tensor cores, where the h loads from L2 and the T barriers bound a
// step instead).
//
// Many streams (kXproj: the G = 16 streams of a multi-seed study, 8 seeds x
// actor and critic, each with its own weights; rnn_xp_fwd_kernel): with a
// cluster of its own for each stream, 16 clusters on a card that runs 15
// take two waves, the second a whole pass for one cluster. Clusters of 4 CTAs
// do not help (the card runs 30 of them, fewer than two a stream, and a CTA
// of one runs two 32-column tiles a step), nor do the streams' rows laid end
// to end over the 15 clusters (137 rows each, mostly two parts of 60-70 rows,
// two 128-row tiles a step: a tile's cost hardly falls with its rows). So
// where the streams outnumber the Q clusters at once, each cluster serves
// S / Q whole streams and a share of the rest's rows (G=16: stream c and 9
// rows of stream 15), its CTAs holding the weight slice of each (bf16 at
// H=256: two of 70 KB for the LSTM, 53 KB for the GRU); a step runs a
// 128-row and a 32-row tile, one wave. Where the slices do not fit (fp32 at
// H=256: 106 KB a GRU slice, 139 KB an LSTM one; bf16 above H=256), a
// cluster a stream, in several waves; in fp32 mode the one-thread-per-column
// kernels serve instead where they win (xp_fwd_columns).
//
// The cell is the template policy (GruFwdCell, LstmFwdCell and their xproj
// cells below): the width of a tile's product columns and how they map onto
// [Wh; Wx], where the x rows start, the bias a tile stages, and its Tile: the
// accumulators, the product of one k-tile, a hook at the first x k-tile and
// the epilogue's cell update.
// - LSTM: 128 columns a tile, the four gates of 32 hidden columns
//   interleaved (n = jj*4 + q), x right after h.
// - GRU: 96 columns a tile, r | z | n of 32 hidden columns; x starts at the
//   k-tile after h, and the n column's h part (u) is stashed when the x
//   k-tiles begin, so [Wh; Wx] has no zero block.
// - The xproj cells (kXproj): the h rows alone (D = 0), the accumulators
//   starting at the stored projection row plus the bias (Tile::start, before
//   the k-loop), and a reset mask a stream (RnnXpFwdArgs::reset_stride). The
//   GRU's n accumulator starts at bhn and ends as u; its xproj column a_n is
//   loaded beside the others and kept apart for the epilogue.
#pragma once

#include <map>
#include <mutex>
#include <utility>

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

// The xproj cell's (kXproj) inputs besides: G streams with a reset mask each
// over the stored projection. The x cells' kernels take RnnFwdArgs alone.
struct RnnXpFwdArgs : RnnFwdArgs {
  int streams;         // the streams S
  int parts;           // the streams a cluster serves at most
  int whole;           // whole streams a cluster serves (0: a.rows rows of one stream)
  int reset_stride;    // floats between the streams' reset masks
  const float* xproj;  // the stored input projection
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
__device__ __forceinline__ void fwd_tile(const typename Cell::Args& a, const FwdCta& c, int t, int m0, int nt) {
  constexpr int kStage = fwd_stage_floats<Cell, BF16, kResident>(kRows);
  constexpr int kStageA = kRows * gate_lda<BF16>();
  constexpr int kLdBs = Cell::kTileCols + kFwdPad;  // a streamed weight tile's row
  const int tid = threadIdx.x, H = a.H, B = a.B, x0 = Cell::x_start(H);
  const float* resets = a.resets;
  if constexpr (Cell::kXproj) resets += (size_t)c.s * a.reset_stride;
  GateRows<kTM> rows;
#pragma unroll
  for (int r = 0; r < GateRows<kTM>::kN; ++r) {
    const int rr = (tid >> 2) + 64 * r, b = m0 + rr;
    const bool ok = b < c.rb1 && (!GateRows<kTM>::kPartial || rr < kTM);
    rows.set(r, ok, c.s, t, ok ? b : c.rb0, a.h0, a.hs, a.xs, resets, a.T, B, a.D, H);
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
  if constexpr (Cell::kXproj) tile.start(a, c, t, m0, nt);
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

// The CTA's hidden columns and k-tiles; the stream and rows are the kernel's.
template <class Cell>
__device__ __forceinline__ FwdCta fwd_cta(const RnnFwdArgs& a) {
  FwdCta c;
  c.j0 = (blockIdx.x % kCluster) * a.hc;
  c.hc = max(0, min(a.H - c.j0, a.hc));
  c.ld = a.n_tiles * Cell::kTileCols + kFwdPad;
  c.n_kt = a.kp / kGateK;
  c.kt_x = Cell::x_start(a.H) / kGateK;
  return c;
}

// Stage stream c.s's bias (a.n_tiles * kGateCols floats at bias) and,
// resident, its slice of [Wh; Wx] (fp32 rows or bf16 k-pairs of c.ld at w) for
// the CTA's columns, once; the first barrier of the k-loop orders these stores
// before any read.
template <class Cell, bool BF16, bool kResident>
__device__ __forceinline__ void fwd_stage_slice(const typename Cell::Args& a, const FwdCta& c, float* w, float* bias) {
  const int s = c.s;
  const int tid = threadIdx.x;
  for (int n = tid; n < a.n_tiles * kGateCols; n += 256) bias[n] = Cell::bias(a, s, c.j0, c.hc, n);
  if constexpr (kResident) {
    const int rows_w = BF16 ? a.kp / 2 : a.kp;
    for (int e = tid; e < rows_w * c.ld; e += 256) {
      const int r = e / c.ld, n = e - r * c.ld;
      if constexpr (BF16) {
        const float* lo = Cell::weight(a, s, c.j0, c.hc, 2 * r, n);
        const float* hi = Cell::weight(a, s, c.j0, c.hc, 2 * r + 1, n);
        reinterpret_cast<uint32_t*>(w)[e] = pack_bf16(lo ? *lo : 0.0f, hi ? *hi : 0.0f);
      } else {
        const float* wk = Cell::weight(a, s, c.j0, c.hc, r, n);
        w[e] = wk ? *wk : 0.0f;
      }
    }
  }
}

// Grid (clusters * kCluster), clusters of kCluster along x, 256 threads. A
// cluster's rows go through 128-row tiles and the rows past the last full one
// through tiles of kTail rows (128, 64 or 32, chosen by the launcher from the
// rows of a cluster), so that a share of the batch that is no multiple of 128
// wastes little of a step; one kernel holds at most two tile sizes (each more
// costs registers and spills). kTail = 96 or 160 (one_tile cells): all the
// cluster's rows in one tile of kTail rows.
template <class Cell, bool BF16, bool kResident, int kTail>
__global__ void __launch_bounds__(256, 1) rnn_x_fwd_kernel(const typename Cell::Args a) {
  constexpr int kRows = fwd_stage_rows(kTail);
  constexpr bool kOne = kTail == 96 || kTail == 160;
  extern __shared__ __align__(16) float fwd_smem[];
  const int cluster = blockIdx.x / kCluster;
  const int per_stream = (a.B + a.rows - 1) / a.rows;
  FwdCta c = fwd_cta<Cell>(a);
  c.s = cluster / per_stream;
  c.rb0 = (cluster - c.s * per_stream) * a.rows;
  c.rb1 = min(a.B, c.rb0 + a.rows);
  float* bias_s = fwd_smem + (kResident ? (BF16 ? a.kp / 2 : a.kp) * c.ld : 0);
  c.w = fwd_smem;
  c.bias = bias_s;
  c.ring = bias_s + a.n_tiles * kGateCols;
  const int n_tiles = c.hc > 0 ? a.n_tiles : 0;
  fwd_stage_slice<Cell, BF16, kResident>(a, c, fwd_smem, bias_s);

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

// Step t of a part q of an xproj cluster: its rows through 128-row tiles
// until the rest fits one kTail-row tile.
template <class Cell, bool BF16, bool kResident, int kTail, int kRows>
__device__ __forceinline__ void fwd_part_step(const RnnXpFwdArgs& a, const FwdCta& q, int t, int n_tiles) {
  for (int m0 = q.rb0; m0 < q.rb1;) {
    if (q.rb1 - m0 > kTail) {
      for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<Cell, 128, BF16, kResident, kRows>(a, q, t, m0, nt);
      m0 += 128;
    } else {
      for (int nt = 0; nt < n_tiles; ++nt) fwd_tile<Cell, kTail, BF16, kResident, kRows>(a, q, t, m0, nt);
      m0 += kTail;
    }
  }
}

// The xproj cell's kernel: rnn_x_fwd_kernel's steps, where a cluster may
// serve several streams. With a.whole = 0 a cluster owns a.rows rows of one
// stream, as above. With a.whole = w > 0 (more streams than the Q clusters
// the card runs at once) cluster c owns the whole streams c*w .. c*w+w-1 and
// a.rows of the remaining streams' rows laid end to end after them (G=16,
// Q=15: stream c, and 9 rows of stream 15). Each stream a cluster serves is a
// part: its CTAs hold the part's weight slice and bias, and a step runs each
// part's rows (fwd_part_step). The x cells keep a kernel and an argument of
// their own: compiled through this one, or given RnnXpFwdArgs, their
// forwards ran 6-15% slower.
template <class Cell, bool BF16, bool kResident, int kTail>
__global__ void __launch_bounds__(256, 1) rnn_xp_fwd_kernel(const RnnXpFwdArgs a) {
  constexpr int kRows = fwd_stage_rows(kTail);
  extern __shared__ __align__(16) float fwd_smem[];
  const int cluster = blockIdx.x / kCluster;
  const int B = a.B;
  FwdCta c = fwd_cta<Cell>(a);
  const int slice = kResident ? (BF16 ? a.kp / 2 : a.kp) * c.ld : 0;  // floats of a weight slice
  const int bias_n = a.n_tiles * kGateCols;
  float* bias_s = fwd_smem + a.parts * slice;
  c.ring = bias_s + a.parts * bias_n;
  const int n_tiles = c.hc > 0 ? a.n_tiles : 0;
  // the rows [lo, hi) of the streams laid end to end that follow the whole streams
  int lo, hi;
  if (a.whole == 0) {
    const int per_stream = (B + a.rows - 1) / a.rows;
    const int s = cluster / per_stream;
    lo = s * B + (cluster - s * per_stream) * a.rows;
    hi = min(s * B + B, lo + a.rows);
  } else {
    lo = a.whole * (int)(gridDim.x / kCluster) * B + cluster * a.rows;
    hi = min(lo + a.rows, a.streams * B);
  }
  const int n_parts = a.whole + (hi > lo ? (hi - 1) / B - lo / B + 1 : 0);
  auto part = [&](int p) {
    FwdCta q = c;
    if (p < a.whole) {
      q.s = cluster * a.whole + p;
      q.rb0 = 0;
      q.rb1 = B;
    } else {
      q.s = lo / B + p - a.whole;
      q.rb0 = max(lo - q.s * B, 0);
      q.rb1 = min(hi - q.s * B, B);
    }
    q.w = fwd_smem + p * slice;
    q.bias = bias_s + p * bias_n;
    return q;
  };

  for (int p = 0; p < n_parts; ++p)
    fwd_stage_slice<Cell, BF16, kResident>(a, part(p), fwd_smem + p * slice, bias_s + p * bias_n);

  for (int t = 0; t < a.T; ++t) {
    for (int p = 0; p < n_parts; ++p) fwd_part_step<Cell, BF16, kResident, kTail, kRows>(a, part(p), t, n_tiles);
    if (t + 1 < a.T) cluster_sync();  // hs[t] of the whole cluster is in before step t+1 reads it
  }
}

// The kernel of a cell.
template <class Cell, bool BF16, bool kResident, int kTail>
constexpr auto fwd_kernel() {
  if constexpr (Cell::kXproj) {
    return rnn_xp_fwd_kernel<Cell, BF16, kResident, kTail>;
  } else {
    return rnn_x_fwd_kernel<Cell, BF16, kResident, kTail>;
  }
}

// The grid of a forward launch, chosen from the card (see the note above).
struct FwdPlan {
  int clusters;  // clusters the card runs at once
  int rows;      // batch rows of a cluster
  int grid;      // clusters launched
  int waves;     // ceil(grid / clusters)
  int resident;  // the [Wh; Wx] slices stay in shared memory
  int tail;      // rows of the tiles past the last full 128-row one (96, 160: of the one tile)
  int parts;     // the streams a cluster serves at most
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

// The clusters the card runs at once with smem bytes a CTA. The plan runs
// before every launch, so the occupancy query runs once per device and size.
template <class Cell, bool BF16, bool kResident>
cudaError_t fwd_active_clusters(size_t smem, int* clusters) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find({dev, smem});
  if (hit != known.end()) {
    *clusters = hit->second;
    return cudaSuccess;
  }
  auto kernel = fwd_kernel<Cell, BF16, kResident, 128>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err == cudaSuccess) known[{dev, smem}] = *clusters;
  return err;
}

// The xproj cell's layout where S streams outnumber the Q clusters at once:
// w = S / Q whole streams a cluster and ceil((S % Q) * B / Q) rows of the
// rest; the streams a cluster serves at most, whose weight slices its CTAs
// hold. Returns false where they do not fit a CTA's shared memory.
template <class Cell, bool BF16>
bool fwd_whole_streams(int S, int B, int max_smem, RnnXpFwdArgs& a, FwdPlan& p) {
  const int Q = p.clusters, w = S / Q, r = S - w * Q;
  const int rest = (r * B + Q - 1) / Q;
  int parts = w;
  for (int c = 0; c < Q && r > 0; ++c) {
    const int lo = c * rest, hi = min(lo + rest, r * B);
    if (hi > lo) parts = max(parts, w + (hi - 1) / B - lo / B + 1);
  }
  const size_t slice = (size_t)(BF16 ? a.kp / 2 : a.kp) * (a.n_tiles * Cell::kTileCols + kFwdPad);
  const size_t smem =
      (parts * (slice + a.n_tiles * kGateCols) + kFwdStages * fwd_stage_floats<Cell, BF16, true>(128)) * sizeof(float);
  if (smem > (size_t)max_smem) return false;
  a.whole = w;
  a.rows = rest;
  p.rows = w * B + rest;
  p.grid = Q;
  p.parts = a.parts = parts;
  p.smem = smem;
  const int tail = (r > 0 ? rest : B) % 128;
  p.tail = tail == 0 || tail > 64 ? 128 : tail > 32 ? 64 : 32;
  return true;
}

template <class Cell, bool BF16>
cudaError_t fwd_plan(int S, int B, int D, int H, typename Cell::Args& a, FwdPlan& p) {
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
  p.parts = 1;
  if constexpr (Cell::kXproj) {
    a.parts = 1;
    a.whole = 0;
    a.streams = S;
    if (S > p.clusters && p.resident && fwd_whole_streams<Cell, BF16>(S, B, max_smem, a, p)) {
      p.waves = 1;
      return cudaSuccess;
    }
  }
  const int per_stream = max(1, p.clusters / S);
  a.rows = p.rows = (B + per_stream - 1) / per_stream;
  p.grid = S * ((B + p.rows - 1) / p.rows);
  p.waves = (p.grid + p.clusters - 1) / p.clusters;
  const int tail = p.rows % 128;
  p.tail = tail == 0 || tail > 64 ? 128 : tail > 32 ? 64 : 32;
  if (Cell::one_tile(BF16) && p.resident && p.rows > 64 && p.rows <= 160) {
    // one tile takes the cluster's rows (the weights streamed from L2 take
    // 128-row tiles only); 160 rows need 192-row stages, where they fit
    const size_t wide = (size_t)fwd_smem_floats<Cell, BF16, true>(a.kp, a.n_tiles, 192) * sizeof(float);
    int wide_clusters = 0;
    if (Cell::kXproj && !BF16 && p.rows <= 80) {
      p.tail = 80;  // fp32 tiles take multiples of 16 rows: 69 rows ran 14-17% faster in 80 than in 96 on an H100
    } else if (p.rows <= 96) {
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
cudaError_t fwd_run(const typename Cell::Args& a, const FwdPlan& p, cudaStream_t st) {
  auto kernel = fwd_kernel<Cell, BF16, kResident, kTail>();
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config((unsigned)p.grid, p.smem, st, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <class Cell, bool BF16>
cudaError_t rnn_x_fwd_launch(typename Cell::Args a, int S, cudaStream_t st) {
  FwdPlan p;
  cudaError_t err = fwd_plan<Cell, BF16>(S, a.B, a.D, a.H, a, p);
  if (err != cudaSuccess) return err;
  if (!p.resident) return fwd_run<Cell, BF16, false, 128>(a, p, st);
  if constexpr (Cell::one_tile(BF16)) {
    if constexpr (Cell::kXproj && !BF16) {
      if (p.tail == 80) return fwd_run<Cell, BF16, true, 80>(a, p, st);
    }
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
// tile that takes a cluster's rows), out[5] the streams a cluster serves at
// most, out[6] the waves (clusters launched over clusters at once, rounded
// up).
template <class Cell, bool BF16>
int rnn_x_fwd_plan(int S, int B, int D, int H, int* out) {
  if (bad_dims(S, 1, B, D, H) || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  typename Cell::Args a{};
  FwdPlan p;
  const cudaError_t err = fwd_plan<Cell, BF16>(S, B, D, H, a, p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.clusters;
  out[1] = p.rows;
  out[2] = p.grid;
  out[3] = p.resident;
  out[4] = p.tail;
  out[5] = p.parts;
  out[6] = p.waves;
  return 0;
}

// What a step of the xproj forwards costs in fp32 mode, in microseconds on an
// H100 at H=256 (PERF.md: kernel_ab.py --variant fp32-cluster fp32-columns
// --shapes, G from 1 to 15 and B from 128 to 1024): a tile of the cluster
// forward of m rows tile_us + row_us * m; the one-thread-per-column kernels
// wave_us for each wave of their blocks of block_rows rows over the SMs, and
// at least floor_us.
struct XpFp32Cost {
  float tile_us, row_us;
  int block_rows;
  float wave_us, floor_us;
};

// A step of a part's n rows through the tiles fwd_part_step takes.
inline float xp_part_us(const XpFp32Cost& k, int n, int tail) {
  float us = 0.0f;
  for (int m = 0; m < n;) {
    const int tile = n - m > tail ? 128 : tail;
    us += k.tile_us + k.row_us * tile;
    m += tile;
  }
  return us;
}

// The xproj forwards keep one thread a hidden column (gru_xp.cu, lstm_xp.cu)
// in fp32 mode where the cluster forward's step (each part's tiles, in every
// wave) costs more than the column kernels' by k, and where its weight slices
// would stream from L2 (fp32 above H=256, not timed against them). Elsewhere,
// and in bf16 mode, the cluster forward.
template <class Cell>
cudaError_t xp_fwd_columns(int bf16, int G, int B, int H, const XpFp32Cost& k, bool* columns) {
  *columns = false;
  if (bf16) return cudaSuccess;
  RnnXpFwdArgs a{};
  FwdPlan p;
  int dev = 0, sms = 0;
  cudaError_t err = fwd_plan<Cell, false>(G, B, 0, H, a, p);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  float step = xp_part_us(k, a.whole > 0 ? B : p.rows, p.tail) * max(a.whole, 1);
  const int share = p.parts - a.whole;
  if (a.whole > 0 && share > 0) step += share * xp_part_us(k, (a.rows + share - 1) / share, p.tail);
  const int waves = (G * ((B + k.block_rows - 1) / k.block_rows) + sms - 1) / sms;
  const float cols = k.wave_us * waves > k.floor_us ? k.wave_us * waves : k.floor_us;
  *columns = !p.resident || p.waves * step > cols;
  return cudaSuccess;
}

// The xproj forward's plan (rnn_x_fwd_plan's seven ints), all zero where it
// runs the one-thread-per-column kernels.
template <class Cell>
int rnn_xp_fwd_plan(int G, int B, int H, int bf16, const XpFp32Cost& k, int* out) {
  if (bad_dims(G, 1, B, 0, H) || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  bool columns = false;
  const cudaError_t err = xp_fwd_columns<Cell>(bf16, G, B, H, k, &columns);
  if (err != cudaSuccess) return (int)err;
  if (columns) {
    for (int i = 0; i < 7; ++i) out[i] = 0;
    return 0;
  }
  return bf16 ? rnn_x_fwd_plan<Cell, true>(G, B, 0, H, out) : rnn_x_fwd_plan<Cell, false>(G, B, 0, H, out);
}

// ------------------------------------------------------------ the LSTM cells
//
// A tile's 128 product columns are the four gates of 32 hidden columns,
// interleaved (n = jj*4 + q), over [Wh; Wx] with x right after h.

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

// The LSTM cell update at the thread's cells, written to hs[t] and cs[t]: the
// carried c and keep are loaded here, not ahead of the product, where they
// would hold registers through it. kStored (the xproj cell): the
// accumulators already hold the input projection and bias, and keep comes
// from the stream's own reset mask.
template <int kTM, bool BF16, bool kStored, class Args>
__device__ __forceinline__ void lstm_fwd_update(GateAcc<kTM, BF16>& acc, const Args& a, const FwdCta& c, int t,
                                                int m0, int nt) {
  constexpr int kCells = kTM / 8;
  const int H = a.H, B = a.B;
  size_t reset0 = 0;
  if constexpr (kStored) reset0 = (size_t)c.s * a.reset_stride;
  float c_prev[kCells], keep[kCells];
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    int row, jj;
    fwd_cell<kTM, BF16>(e, row, jj);
    const int b = m0 + row, j = c.j0 + nt * 32 + jj;
    const bool on = b < c.rb1 && nt * 32 + jj < c.hc;
    keep[e] = on ? 1.0f - a.resets[reset0 + (size_t)t * B + b] : 0.0f;
    c_prev[e] = !on ? 0.0f
                    : t == 0 ? a.c0[((size_t)c.s * B + b) * H + j]
                             : a.cs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j];
  }
  if constexpr (BF16) fwd_gather_gates<kTM>(acc);
  const float* bias = c.bias + nt * kGateCols;
  auto gate = [&](int e, int jj, int q) {
    const float v = fwd_gate<kTM, BF16>(acc, e, q);
    if constexpr (kStored) {
      return v;
    } else {
      return v + bias[jj * 4 + q];
    }
  };
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    int row, jj;
    fwd_cell<kTM, BF16>(e, row, jj);
    const int b = m0 + row;
    if (b >= c.rb1 || nt * 32 + jj >= c.hc) continue;
    const float i = sigmoid(gate(e, jj, 0));
    const float f = sigmoid(gate(e, jj, 1));
    const float g = tanhf(gate(e, jj, 2));
    const float o = sigmoid(gate(e, jj, 3));
    const float cell = f * (c_prev[e] * keep[e]) + i * g;
    const size_t out = (((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * 32 + jj;
    a.cs[out] = cell;
    a.hs[out] = o * tanhf(cell);
  }
}

// The LSTM cell of lstm_x_fwd.
struct LstmFwdCell {
  static constexpr int kTileCols = kGateCols;
  static constexpr bool kXproj = false;
  // 128-row tiles and one tail size (its kernels spill at 255 registers)
  __host__ __device__ static constexpr bool one_tile(bool) { return false; }
  using Args = RnnFwdArgs;

  __host__ __device__ static int x_start(int H) { return H; }

  // Operand row k of [Wh; Wx] at gate column n of the CTA whose hidden columns
  // start at j0 (gate q = n % 4 of hidden column j0 + n / 4), or nullptr where
  // the value is zero (past the CTA's columns or the operand rows).
  __device__ __forceinline__ static const float* weight(const RnnFwdArgs& a, int s, int j0, int hc, int k, int n) {
    const int jj = n >> 2, H = a.H;
    if (jj >= hc || k >= H + a.D) return nullptr;
    const int col = (n & 3) * H + j0 + jj;
    return k < H ? a.wh + ((size_t)s * H + k) * 4 * H + col : a.wx + ((size_t)s * a.D + k - H) * 4 * H + col;
  }

  // bh at gate column n
  __device__ __forceinline__ static float bias(const RnnFwdArgs& a, int s, int j0, int hc, int n) {
    return (n >> 2) < hc ? a.bias[(size_t)s * 4 * a.H + (n & 3) * a.H + j0 + (n >> 2)] : 0.0f;
  }

  template <int kTM, bool BF16>
  struct Tile {
    GateAcc<kTM, BF16> acc;

    __device__ __forceinline__ void at_x() {}

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      gate_tile_step<kTM, BF16>(acc, As, bt);
    }

    __device__ __forceinline__ void epilogue(const RnnFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      lstm_fwd_update<kTM, BF16, false>(acc, a, c, t, m0, nt);
    }
  };
};

// The LSTM cell of lstm_xp_fwd: over the stored projection xproj [G,T,B,4H]
// (x Wx, gates i|f|g|o) with D = 0, so its weight map (LstmFwdCell's) has the
// h rows alone; each accumulator starts at its xproj element plus bh, loaded
// before the k-loop so that the loads' latency hides behind the ring's first
// copies (after the product each would wait behind the epilogue's stores,
// which may alias), and each stream has its own reset mask.
struct LstmXpFwdCell : LstmFwdCell {
  static constexpr bool kXproj = true;
  using Args = RnnXpFwdArgs;
  // fp32: a cluster's rows in one 96- or 160-row tile where they fit (G=1:
  // 69 rows in a 96-row tile); bf16 keeps 128-row tiles
  __host__ __device__ static constexpr bool one_tile(bool bf16) { return !bf16; }

  template <int kTM, bool BF16>
  struct Tile : LstmFwdCell::Tile<kTM, BF16> {
    __device__ __forceinline__ void start(const RnnXpFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      const int H = a.H;
      const float* bias = c.bias + nt * kGateCols;
      const float* xp = a.xproj + (((size_t)c.s * a.T + t) * a.B) * 4 * H + c.j0 + nt * kFwdTileHidden;
      // tile row `row` at product column n (gate n % 4 of hidden column n / 4)
      auto input = [&](int row, int n) {
        const int b = m0 + row, jj = n >> 2;
        if (b >= c.rb1 || nt * kFwdTileHidden + jj >= c.hc) return 0.0f;
        return __ldg(xp + (size_t)b * 4 * H + (n & 3) * H + jj) + bias[n];
      };
      const int tid = threadIdx.x;
      if constexpr (BF16) {
        const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
        const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
        for (int i = 0; i < kTM / 32; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              this->acc[i][j][e] = input(wm * (kTM / 2) + 16 * i + g + 8 * (e >> 1), wn * 32 + 8 * j + 2 * q + (e & 1));
      } else {
        const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
        for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) this->acc[i][j] = input(gate_row_of<kTM>(ty, i), (j & 4) * 16 + tx * 4 + (j & 3));
      }
    }

    __device__ __forceinline__ void epilogue(const RnnXpFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      lstm_fwd_update<kTM, BF16, true>(this->acc, a, c, t, m0, nt);
    }
  };
};

// ------------------------------------------------------------- the GRU cells
//
// The GRU cell of gru_x_fwd. Each hidden column has
// three product columns, r | z | n, over [Wh; Wx] as they are (no zero
// block): a tile's 96 columns hold 32 hidden columns in blocks of 8, column
// blk*24 + q*8 + c being quantity q of hidden column blk*8 + c, so that an
// fp32 thread's three float2 loads of a weight row and a bf16 warp's three n8
// tiles each take one quantity of the same hidden columns, and every thread
// ends with all three of its cells. The n column must give u = h Wh_n + bhn
// and a_n = x Wx_n + bx_n apart (n = tanh(a_n + r*u)): x starts at the
// k-tile after h (H rounded up to 16), and at the first x k-tile the tile
// stashes the n column's sum over h (u) and restarts it, so it ends with the
// sum over x (a_n). Against interleaving four quantities with zero blocks
// (u has no x rows, a_n no h rows), that saves the quarter of the h-product
// that would multiply zeros. The epilogue re-reads the h it wrote a step
// earlier: h' = (1 - z) * n + z * h * keep.
struct GruFwdCell {
  static constexpr int kTileCols = 3 * kFwdTileHidden;
  static constexpr bool kXproj = false;
  // a cluster's rows in one 96- or 160-row tile where they fit
  __host__ __device__ static constexpr bool one_tile(bool) { return true; }
  using Args = RnnFwdArgs;

  __host__ __device__ static int x_start(int H) { return (H + kGateK - 1) / kGateK * kGateK; }

  // Operand row k (h rows, then x rows from x_start) at product column n of
  // the CTA whose hidden columns start at j0, or nullptr where the value is
  // zero (past the CTA's columns, between h and x, past the operand rows).
  __device__ __forceinline__ static const float* weight(const RnnFwdArgs& a, int s, int j0, int hc, int k, int n) {
    const int nt = n / kTileCols, nl = n - nt * kTileCols, blk = nl / 24;
    const int jj = nt * kFwdTileHidden + blk * 8 + (nl & 7), q = (nl - blk * 24) >> 3;
    const int H = a.H, x0 = x_start(H);
    if (jj >= hc) return nullptr;
    const int col = q * H + j0 + jj;
    if (k < H) return a.wh + ((size_t)s * H + k) * 3 * H + col;
    if (k < x0 || k >= x0 + a.D) return nullptr;
    return a.wx + ((size_t)s * a.D + k - x0) * 3 * H + col;
  }

  // The bias a tile stages (128 floats): bx_r | bx_z | bhn | bx_n of its 32
  // hidden columns.
  __device__ __forceinline__ static float bias(const RnnFwdArgs& a, int s, int j0, int hc, int n) {
    const int q = (n >> 5) & 3, jj = (n >> 7) * kFwdTileHidden + (n & 31), H = a.H;
    if (jj >= hc) return 0.0f;
    const int j = j0 + jj;
    return q == 2 ? a.bias2[(size_t)s * H + j] : a.bias[(size_t)s * 3 * H + (q == 3 ? 2 : q) * H + j];
  }

  // fp32: thread (ty, tx) owns the rows gate_row_of(ty, i) and hidden columns
  // cb + e (cb = (tx/4)*8 + (tx%4)*2, e = 0, 1): acc[i][2q + e] is quantity q,
  // u[i][e] the stash. A cell c is (i, e) = (c/2, c%2).
  template <int kTM>
  struct TileF32 {
    float acc[kTM / 16][6];
    float u[kTM / 16][2];

    __device__ __forceinline__ void at_x() {
#pragma unroll
      for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u[i][e] = acc[i][4 + e];
          acc[i][4 + e] = 0.0f;
        }
    }

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      constexpr int kLdA = gate_lda<false>();
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
      const int cb = (tx >> 2) * 24 + (tx & 3) * 2;
#pragma unroll
      for (int kk = 0; kk < kGateK; ++kk) {
        float av[kTM / 16];
#pragma unroll
        for (int i = 0; i < kTM / 16; ++i) av[i] = As[gate_row_of<kTM>(ty, i) * kLdA + kk];
        const float* br = bt.row(kk) + cb;
        const float2 b0 = *reinterpret_cast<const float2*>(br);
        const float2 b1 = *reinterpret_cast<const float2*>(br + 8);
        const float2 b2 = *reinterpret_cast<const float2*>(br + 16);
        const float bv[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
#pragma unroll
        for (int i = 0; i < kTM / 16; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    __device__ __forceinline__ void cell(int c, int& row, int& jj) const {
      const int tx = threadIdx.x & 15;
      row = gate_row_of<kTM>(threadIdx.x >> 4, c >> 1);
      jj = (tx >> 2) * 8 + (tx & 3) * 2 + (c & 1);
    }
    __device__ __forceinline__ float quantity(int c, int q) const { return acc[c >> 1][2 * q + (c & 1)]; }
    __device__ __forceinline__ float stashed(int c) const { return u[c >> 1][c & 1]; }
  };

  // bf16: warp (wm, wn) owns rows wm*kTM/2.. (kTM/32 m16 tiles) and hidden
  // columns wn*8..wn*8+7, its n8 tile q being quantity q of them (mma's C
  // layout: lane (g, l) holds rows g, g+8 x hidden columns 2l, 2l+1):
  // acc[i][q][v], u[i][v] the stash. A cell c is (i, v) = (c/4, c%4).
  template <int kTM>
  struct TileB16 {
    float acc[kTM / 32][3][4];
    float u[kTM / 32][4];

    __device__ __forceinline__ void at_x() {
#pragma unroll
      for (int i = 0; i < kTM / 32; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          u[i][v] = acc[i][2][v];
          acc[i][2][v] = 0.0f;
        }
    }

    template <class Bt>
    __device__ __forceinline__ void step(const float* As, const Bt& bt) {
      constexpr int kLdA = gate_lda<true>();
      const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, l = threadIdx.x & 3;
      const int wm = warp >> 2, wn = warp & 3;
      uint32_t b[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) bt.frag(l, wn * 24 + 8 * q + g, b[q][0], b[q][1]);
#pragma unroll
      for (int i = 0; i < kTM / 32; ++i) {
        const float* ar0 = As + (wm * (kTM / 2) + 16 * i + g) * kLdA + 2 * l;
        const float2 x0 = *reinterpret_cast<const float2*>(ar0);
        const float2 x1 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA);
        const float2 x2 = *reinterpret_cast<const float2*>(ar0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(ar0 + 8 * kLdA + 8);
        const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                                pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int q = 0; q < 3; ++q) mma_bf16(acc[i][q], af, b[q][0], b[q][1]);
      }
    }

    __device__ __forceinline__ void cell(int c, int& row, int& jj) const {
      const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, l = threadIdx.x & 3;
      row = (warp >> 2) * (kTM / 2) + 16 * (c >> 2) + g + 8 * ((c & 3) >> 1);
      jj = (warp & 3) * 8 + 2 * l + (c & 1);
    }
    __device__ __forceinline__ float quantity(int c, int q) const { return acc[c >> 2][q][c & 3]; }
    __device__ __forceinline__ float stashed(int c) const { return u[c >> 2][c & 3]; }
  };

  template <int kTM, bool BF16>
  struct Tile : std::conditional<BF16, TileB16<kTM>, TileF32<kTM>>::type {
    // the cell update at the thread's cells, written to hs[t]: the carried h
    // and keep are loaded here, not ahead of the product
    __device__ __forceinline__ void epilogue(const RnnFwdArgs& a, const FwdCta& c, int t, int m0, int nt) const {
      constexpr int kCells = kTM / 8;
      const int H = a.H, B = a.B;
      float h_prev[kCells];
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row, j = c.j0 + nt * kFwdTileHidden + jj;
        const bool on = b < c.rb1 && nt * kFwdTileHidden + jj < c.hc;
        const float keep = on ? 1.0f - a.resets[(size_t)t * B + b] : 0.0f;
        h_prev[e] = !on ? 0.0f
                        : keep * (t == 0 ? a.h0[((size_t)c.s * B + b) * H + j]
                                         : a.hs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j]);
      }
      const float* bias = c.bias + nt * kGateCols;
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row;
        if (b >= c.rb1 || nt * kFwdTileHidden + jj >= c.hc) continue;
        const float r = sigmoid(this->quantity(e, 0) + bias[jj]);
        const float z = sigmoid(this->quantity(e, 1) + bias[32 + jj]);
        const float u = this->stashed(e) + bias[64 + jj];
        const float n = tanhf(this->quantity(e, 2) + bias[96 + jj] + r * u);
        a.hs[(((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * kFwdTileHidden + jj] = (1.0f - z) * n + z * h_prev[e];
      }
    }
  };
};


// The GRU cell of gru_xp_fwd: over the stored projection xproj [G,T,B,3H]
// (x Wx + bx, r | z | n) with D = 0, so GruFwdCell's weight map has the h
// rows alone and no k-tile is an x one (no stash). Before the k-loop the r
// and z accumulators load their xproj columns and the n accumulator bhn, so
// that it ends as u = h Wh_n + bhn; a_n, xproj's n column, is loaded beside
// them into registers of its own (the loads' latency hides behind the ring's
// first copies, as LstmXpFwdCell's). xproj's rows are 3H apart: a thread's
// two neighbouring hidden columns come in one 8-byte load where they are
// aligned, else one by one (odd H or j0). Each stream has its own reset mask.
struct GruXpFwdCell : GruFwdCell {
  static constexpr bool kXproj = true;
  using Args = RnnXpFwdArgs;

  // the bias a tile stages: bhn in GruFwdCell's u slot (64 + jj), zero elsewhere
  __device__ __forceinline__ static float bias(const RnnFwdArgs& a, int s, int j0, int hc, int n) {
    const int jj = (n >> 7) * kFwdTileHidden + (n & 31);
    return ((n >> 5) & 3) == 2 && jj < hc ? a.bias2[(size_t)s * a.H + j0 + jj] : 0.0f;
  }

  template <int kTM, bool BF16>
  struct Tile : GruFwdCell::Tile<kTM, BF16> {
    float an[kTM / 8];  // a_n at the thread's cells

    __device__ __forceinline__ void at_x() {}

    // the accumulator of quantity q (r, z, u) at cell c
    __device__ __forceinline__ float& slot(int c, int q) {
      if constexpr (BF16) {
        return this->acc[c >> 2][q][c & 3];
      } else {
        return this->acc[c >> 1][2 * q + (c & 1)];
      }
    }

    __device__ __forceinline__ void start(const RnnXpFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      const int H = a.H, j_tile = nt * kFwdTileHidden;
      const float* bias = c.bias + nt * kGateCols;
      const float* xp = a.xproj + ((size_t)c.s * a.T + t) * a.B * 3 * H + c.j0 + j_tile;
      const bool vec = ((H | c.j0) & 1) == 0 && (reinterpret_cast<uintptr_t>(a.xproj) & 7) == 0;
      // cells e and e + 1: one row, hidden columns jj and jj + 1
#pragma unroll
      for (int e = 0; e < kTM / 8; e += 2) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row;
        const bool on0 = b < c.rb1 && j_tile + jj < c.hc, on1 = b < c.rb1 && j_tile + jj + 1 < c.hc;
        const float* x = xp + (size_t)(on0 ? b : c.rb0) * 3 * H + jj;
        float v[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (vec && on1) {
            const float2 f = __ldg(reinterpret_cast<const float2*>(x + q * H));
            v[q][0] = f.x;
            v[q][1] = f.y;
          } else {
            v[q][0] = on0 ? __ldg(x + q * H) : 0.0f;
            v[q][1] = on1 ? __ldg(x + q * H + 1) : 0.0f;
          }
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          slot(e + d, 0) = v[0][d];
          slot(e + d, 1) = v[1][d];
          slot(e + d, 2) = bias[64 + jj + d];
          an[e + d] = v[2][d];
        }
      }
    }

    // the cell update at the thread's cells, written to hs[t]: the carried h
    // and keep (the stream's own mask) are loaded here, not ahead of the product
    __device__ __forceinline__ void epilogue(const RnnXpFwdArgs& a, const FwdCta& c, int t, int m0, int nt) {
      constexpr int kCells = kTM / 8;
      const int H = a.H, B = a.B;
      const float* resets = a.resets + (size_t)c.s * a.reset_stride;
      float h_prev[kCells];
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row, j = c.j0 + nt * kFwdTileHidden + jj;
        const bool on = b < c.rb1 && nt * kFwdTileHidden + jj < c.hc;
        const float keep = on ? 1.0f - resets[(size_t)t * B + b] : 0.0f;
        h_prev[e] = !on ? 0.0f
                        : keep * (t == 0 ? a.h0[((size_t)c.s * B + b) * H + j]
                                         : a.hs[(((size_t)c.s * a.T + t - 1) * B + b) * H + j]);
      }
#pragma unroll
      for (int e = 0; e < kCells; ++e) {
        int row, jj;
        this->cell(e, row, jj);
        const int b = m0 + row;
        if (b >= c.rb1 || nt * kFwdTileHidden + jj >= c.hc) continue;
        const float r = sigmoid(slot(e, 0));
        const float z = sigmoid(slot(e, 1));
        const float n = tanhf(an[e] + r * slot(e, 2));
        a.hs[(((size_t)c.s * a.T + t) * B + b) * H + c.j0 + nt * kFwdTileHidden + jj] = (1.0f - z) * n + z * h_prev[e];
      }
    }
  };
};

}  // namespace
