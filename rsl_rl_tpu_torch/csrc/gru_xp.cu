// GRU window replay over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the Pallas xproj-streaming GRU kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   gru_xp_fwd    <- _fwd_kernel / _gru_core_fwd_impl: the cluster forward of
//                    rnn_fwd.cuh with the GRU xproj cell (fp32 mode where it
//                    costs more: one thread a column)
//   gru_xp_bwd    <- _bwd_kernel / _gru_core_bwd_impl: the BPTT chain, in the
//                    three phases of rnn_bwd.cuh with the GRU xproj cell
//   gru_xp_wgrad  <- the dWh / dbhn accumulation of the same backward (the
//                    shared reduction of rnn_wgrad.cuh, with no x columns)
// The input projection xproj = x Wx + bx is one bulk product outside the
// kernels, as in the JAX package; its gradients follow by autograd through
// that product. Layouts, math and the design note are in
// rsl_rl_tpu_torch/ops/gru_rnn.py.
//
// All tensors are contiguous fp32, with a leading stream axis G (independent
// recurrences: the seeds of a multi-seed study, times the actor and critic
// memories):
//   xproj [G,T,B,3H], resets [G,T,B] (1 = zero the carry before step t),
//   carry0 [G,B,H], wh [G,H,3H], whT [G,3H,H], bhn [G,H], hs / ghs
//   [G,T,B,H], dcarry0 [G,B,H], gs [G,T,B,4H] (per-step dr|dz|dn|du; the
//   gradient of xproj is its first 3H columns), C [G,H+1,4H] and its split-K
//   partial sums W [G,P,H+1,4H].
// With bf16 != 0 the operands of h Wh and dgates Whᵀ are rounded to bf16
// (round to nearest even) and the products accumulate in fp32, like the JAX
// package's _mm; xproj, the state and the gate math stay fp32. Otherwise all
// math is IEEE fp32 on the CUDA cores; bf16-mode products run on the tensor
// cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (gru_xp_fwd one,
// gru_xp_bwd T+2, gru_xp_wgrad one or two: the split-K products, then their
// fixed-order sum), allocates nothing, and returns the cudaError_t of the
// launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_fwd.cuh"
#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 16;  // batch rows per forward block (H <= 256)
// a fp32 step of the cluster forward's tiles and of the kernel below
constexpr XpFp32Cost kFp32Cost = {3.5f, 0.30f, kFwdRows, 52.0f, 52.0f};

// fp32 mode where the cluster forward costs more (xp_fwd_columns,
// rnn_fwd.cuh): the one-thread-per-column forward. Grid
// (ceil(B/BB), G), one thread per hidden column j (blockDim.x == H). The
// block runs the whole window for its BB rows of stream s; thread j keeps
// h[:, j] in registers and publishes the operand tile in shared memory; the
// gates add the streamed xproj row to h Wh.
template <int BB>
__global__ void __launch_bounds__(256) gru_xp_fwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  const float bn = bhn[(size_t)s * H + j];

  float h[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const int row = b0 + b;
    h[b] = row < B ? carry0[((size_t)s * B + row) * H + j] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G3;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float xr[BB], xz[BB], xn[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G3;
      xr[b] = in ? __ldg(xp + j) : 0.0f;
      xz[b] = in ? __ldg(xp + H + j) : 0.0f;
      xn[b] = in ? __ldg(xp + 2 * H + j) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
      h[b] *= keep;
      hT[j * BB + b] = h[b];
    }
    __syncthreads();

    float c[3][BB];  // h Wh for r, z, n
    gate_matvec<3, BB, false>(wh_s, hT, H, H, j, c);

    float* hs_t = hs + st * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float r = sigmoid(xr[b] + c[0][b]);
      const float z = sigmoid(xz[b] + c[1][b]);
      const float u = c[2][b] + bn;
      const float n = tanhf(xn[b] + r * u);
      h[b] = (1.0f - z) * n + z * h[b];
      if (b0 + b < B) hs_t[(size_t)(b0 + b) * H + j] = h[b];
    }
    __syncthreads();  // hT is rewritten next step
  }
}

// H > 256: the forward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB>
__global__ void __launch_bounds__(256) gru_xp_fwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ carry0, const float* __restrict__ wh,
    const float* __restrict__ bhn, float* __restrict__ hs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G3 = 3 * H;
  const float* wh_s = wh + (size_t)s * H * G3;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bn[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) bn[c] = bhn[(size_t)s * H + j[c]];

  float h[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      h[c][b] = row < B ? carry0[((size_t)s * B + row) * H + j[c]] : 0.0f;
    }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G3;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float xr[kWideCols][BB], xz[kWideCols][BB], xn[kWideCols][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G3;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        xr[c][b] = in ? __ldg(xp + j[c]) : 0.0f;
        xz[c][b] = in ? __ldg(xp + H + j[c]) : 0.0f;
        xn[c][b] = in ? __ldg(xp + 2 * H + j[c]) : 0.0f;
      }
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        h[c][b] *= keep;
        if (on[c]) hT[j[c] * BB + b] = h[c][b];
      }
    }
    __syncthreads();

    float acc[kWideCols][3][BB];  // h Wh for r, z, n
    gate_matvec_wide<3, BB, false>(wh_s, hT, H, H, j, acc);

    float* hs_t = hs + st * B * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float r = sigmoid(xr[c][b] + acc[c][0][b]);
        const float z = sigmoid(xz[c][b] + acc[c][1][b]);
        const float u = acc[c][2][b] + bn[c];
        const float n = tanhf(xn[c][b] + r * u);
        h[c][b] = (1.0f - z) * n + z * h[c][b];
        if (on[c] && b0 + b < B) hs_t[(size_t)(b0 + b) * H + j[c]] = h[c][b];
      }
    __syncthreads();  // hT is rewritten next step
  }
}

}  // namespace

// The cluster forward of rnn_fwd.cuh with GruXpFwdCell over the G streams,
// each with its own weights and reset mask (where the streams outnumber the
// clusters the card runs at once, a cluster serves whole streams and a share
// of the rest), or in fp32 mode where xp_fwd_columns says so the kernels
// above.
extern "C" int gru_xp_fwd(const float* xproj, const float* resets, const float* carry0,
                          const float* wh, const float* bhn, float* hs, int G, int T, int B,
                          int H, int bf16, void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool columns = false;
  cudaError_t err = xp_fwd_columns<GruXpFwdCell>(bf16, G, B, H, kFp32Cost, &columns);
  if (err != cudaSuccess) return (int)err;
  if (columns) {
    return (int)launch_columns(gru_xp_fwd_kernel<kFwdRows>, gru_xp_fwd_wide_kernel<kFwdRows / 2>, kFwdRows, G, B,
                               H, H, st, xproj, resets, carry0, wh, bhn, hs, T, B, H);
  }
  const RnnXpFwdArgs a{{nullptr, resets, nullptr, carry0, nullptr, wh, nullptr, bhn, hs, nullptr, T, B, 0, H, 0, 0, 0, 0},
                       G, 1, 0, T * B, xproj};
  return (int)(bf16 ? rnn_x_fwd_launch<GruXpFwdCell, true>(a, G, st) : rnn_x_fwd_launch<GruXpFwdCell, false>(a, G, st));
}

// The cluster forward's grid for these shapes on the current card: seven
// ints, as rnn_xp_fwd_plan (rnn_fwd.cuh) gives them, all zero where
// gru_xp_fwd runs the one-thread-per-column kernels.
extern "C" int gru_xp_fwd_plan(int G, int B, int H, int bf16, int* out) {
  return rnn_xp_fwd_plan<GruXpFwdCell>(G, B, H, bf16, kFp32Cost, out);
}

// The three phases of rnn_bwd.cuh over the G streams, each with its own reset
// mask: the gates GEMM over the G*T*B rows starting at xproj (and bhn), then
// one chain launch a step; gs's first 3H columns are the gradient of xproj.
// phase_ms: nullptr, or three floats that receive the milliseconds of the
// phases (gates, chain, and 0 for the dx phase the xproj backward does not
// have; the call then waits for the stream).
extern "C" int gru_xp_bwd(const float* xproj, const float* resets, const float* carry0,
                          const float* wh, const float* whT, const float* bhn, const float* hs,
                          const float* ghs, float* dcarry0, float* gs, int G, int T, int B,
                          int H, int bf16, void* stream, float* phase_ms) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  const RnnBwdArgs a{nullptr, resets, nullptr, carry0, nullptr, wh, whT, nullptr, bhn, hs, nullptr, ghs, nullptr,
                     dcarry0, nullptr, gs, T, B, 0, H, T * B, xproj};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_bwd_launch<GruXpCell, true>(a, G, st, phase_ms)
                    : rnn_bwd_launch<GruXpCell, false>(a, G, st, phase_ms));
}

// The weight-gradient reduction of rnn_wgrad.cuh with no x columns and one
// reset mask per stream: C = Σ_rows [h_masked | 1]ᵀ [dr|dz|dn|du]. W is the
// caller's scratch of [G,P,H+1,4H] partial sums, P >= 1 the number of row
// splits; C [G,H+1,4H] receives their sum.
extern "C" int gru_xp_wgrad(const float* resets, const float* carry0, const float* hs,
                            const float* gs, float* W, float* C, int G, int T, int B, int H,
                            int P, int bf16, void* stream) {
  return rnn_wgrad_launch(nullptr, resets, carry0, hs, gs, W, C, G, T, B, 0, H, P, bf16, 1,
                          1, stream);
}
