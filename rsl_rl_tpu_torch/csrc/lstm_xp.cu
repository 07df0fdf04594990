// LSTM window replay over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the Pallas xproj-streaming LSTM kernels of rsl_rl_tpu/ops/pallas_rnn.py:
//   lstm_xp_fwd    <- _lstm_fwd_kernel / _lstm_core_fwd_impl: the cluster
//                     forward of rnn_fwd.cuh with the LSTM xproj cell (fp32
//                     mode where it costs more: one thread a column)
//   lstm_xp_bwd    <- _lstm_bwd_kernel / _lstm_core_bwd_impl: the BPTT chain, in
//                     the three phases of rnn_bwd.cuh with the LSTM xproj cell
//   lstm_xp_wgrad  <- the dWh / dbh accumulation of the same backward (the
//                     shared reduction of rnn_wgrad.cuh, with no x columns)
// The input projection xproj = x Wx (flax OptimizedLSTMCell has no input
// bias) is one bulk product outside the kernels, as in the JAX package; its
// gradients follow by autograd through that product. Layouts, math and the
// design note are in rsl_rl_tpu_torch/ops/lstm_rnn.py.
//
// All tensors are contiguous fp32, with a leading stream axis G:
//   xproj [G,T,B,4H], resets [G,T,B] (1 = zero the carry before step t),
//   c0 / h0 [G,B,H], wh [G,H,4H], whT [G,4H,H], bh [G,4H] (gates i|f|g|o),
//   hs / cs / ghs [G,T,B,H], dc0 / dh0 [G,B,H], gs [G,T,B,4H] (per-step
//   di|df|dg|do, which is also the gradient of xproj), C [G,H+1,4H] and its
//   split-K partial sums W [G,P,H+1,4H].
// With bf16 != 0 the operands of h Wh and dgates Whᵀ are rounded to bf16
// (round to nearest even) and the products accumulate in fp32, like the JAX
// package's _mm; xproj, the cell and hidden state and the gate math stay
// fp32. Otherwise all math is IEEE fp32 on the CUDA cores; bf16-mode
// products of lstm_xp_fwd's cluster forward and of lstm_xp_bwd run on the
// tensor cores (mma.m16n8k16).
//
// Each entry point launches its kernels on the given stream (lstm_xp_fwd one,
// lstm_xp_bwd T+2, lstm_xp_wgrad one or two), allocates nothing, and returns
// the cudaError_t of the launches (0 on success).

#include "rnn_bwd.cuh"
#include "rnn_fwd.cuh"
#include "rnn_wgrad.cuh"

namespace {

constexpr int kFwdRows = 8;  // batch rows per forward block (H <= 256)
// a fp32 step of the cluster forward's tiles and of the kernel below
constexpr XpFp32Cost kFp32Cost = {3.2f, 0.43f, kFwdRows, 27.5f, 40.0f};

// fp32 mode where the cluster forward costs more (xp_fwd_columns,
// rnn_fwd.cuh): the one-thread-per-column forward. Grid
// (ceil(B/BB), G), one thread per hidden column j (blockDim.x == H). The
// block runs the whole window for its BB rows of stream s; thread j keeps c[:, j] and
// h[:, j] in registers and publishes the h tile in shared memory; the gates
// add the streamed xproj row and the bias to h Wh.
template <int BB>
__global__ void __launch_bounds__(256) lstm_xp_fwd_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ bh, float* __restrict__ hs,
    float* __restrict__ cs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int j = threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
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
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G4;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float x[4][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q][b] = in ? __ldg(xp + q * H + j) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
      c[b] *= keep;
      h[b] *= keep;
      hT[j * BB + b] = h[b];
    }
    __syncthreads();

    float a[4][BB];  // h Wh for i, f, g, o
    gate_matvec<4, BB, false>(wh_s, hT, H, H, j, a);

    const size_t out = st * B * H;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const float i = sigmoid(x[0][b] + a[0][b] + bias[0]);
      const float f = sigmoid(x[1][b] + a[1][b] + bias[1]);
      const float g = tanhf(x[2][b] + a[2][b] + bias[2]);
      const float o = sigmoid(x[3][b] + a[3][b] + bias[3]);
      c[b] = f * c[b] + i * g;
      h[b] = o * tanhf(c[b]);
      if (row < B) {
        hs[out + (size_t)row * H + j] = h[b];
        cs[out + (size_t)row * H + j] = c[b];
      }
    }
    __syncthreads();  // hT is rewritten next step
  }
}

// H > 256: the forward above with kWideCols hidden columns a thread (see
// wide_columns) and half the rows a block.
template <int BB>
__global__ void __launch_bounds__(256) lstm_xp_fwd_wide_kernel(
    const float* __restrict__ xproj, const float* __restrict__ resets,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, const float* __restrict__ bh, float* __restrict__ hs,
    float* __restrict__ cs, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;  // [H][BB]
  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const int G4 = 4 * H;
  const float* wh_s = wh + (size_t)s * H * G4;
  int j[kWideCols];
  bool on[kWideCols];
  wide_columns(H, j, on);
  float bias[kWideCols][4];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[c][q] = bh[(size_t)s * G4 + q * H + j[c]];

  float cc[kWideCols][BB], h[kWideCols][BB];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      cc[c][b] = row < B ? c0[((size_t)s * B + row) * H + j[c]] : 0.0f;
      h[c][b] = row < B ? h0[((size_t)s * B + row) * H + j[c]] : 0.0f;
    }
  for (int t = 0; t < T; ++t) {
    const size_t st = (size_t)s * T + t;
    const float* xp_t = xproj + st * B * G4;
    // this step's projections, loaded before the h Wh chain so that their
    // latency overlaps it
    float x[kWideCols][4][BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const int row = b0 + b;
      const bool in = row < B;
      const float* xp = xp_t + (size_t)(in ? row : 0) * G4;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) x[c][q][b] = in ? __ldg(xp + q * H + j[c]) : 0.0f;
      const float keep = in ? 1.0f - resets[st * B + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        cc[c][b] *= keep;
        h[c][b] *= keep;
        if (on[c]) hT[j[c] * BB + b] = h[c][b];
      }
    }
    __syncthreads();

    float a[kWideCols][4][BB];  // h Wh for i, f, g, o
    gate_matvec_wide<4, BB, false>(wh_s, hT, H, H, j, a);

    const size_t out = st * B * H;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const int row = b0 + b;
        const float i = sigmoid(x[c][0][b] + a[c][0][b] + bias[c][0]);
        const float f = sigmoid(x[c][1][b] + a[c][1][b] + bias[c][1]);
        const float g = tanhf(x[c][2][b] + a[c][2][b] + bias[c][2]);
        const float o = sigmoid(x[c][3][b] + a[c][3][b] + bias[c][3]);
        cc[c][b] = f * cc[c][b] + i * g;
        h[c][b] = o * tanhf(cc[c][b]);
        if (on[c] && row < B) {
          hs[out + (size_t)row * H + j[c]] = h[c][b];
          cs[out + (size_t)row * H + j[c]] = cc[c][b];
        }
      }
    __syncthreads();  // hT is rewritten next step
  }
}

}  // namespace

// The cluster forward of rnn_fwd.cuh with LstmXpFwdCell over the G streams,
// each with its own weights and reset mask (where the streams outnumber the
// clusters the card runs at once, a cluster serves whole streams and a share
// of the rest), or in fp32 mode where xp_fwd_columns says so the kernels
// above.
extern "C" int lstm_xp_fwd(const float* xproj, const float* resets, const float* c0,
                           const float* h0, const float* wh, const float* bh, float* hs,
                           float* cs, int G, int T, int B, int H, int bf16, void* stream) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool columns = false;
  cudaError_t err = xp_fwd_columns<LstmXpFwdCell>(bf16, G, B, H, kFp32Cost, &columns);
  if (err != cudaSuccess) return (int)err;
  if (columns) {
    return (int)launch_columns(lstm_xp_fwd_kernel<kFwdRows>, lstm_xp_fwd_wide_kernel<kFwdRows / 2>,
                               kFwdRows, G, B, H, H, st, xproj, resets, c0, h0, wh, bh, hs, cs, T, B, H);
  }
  const RnnXpFwdArgs a{{nullptr, resets, c0, h0, nullptr, wh, bh, nullptr, hs, cs, T, B, 0, H, 0, 0, 0, 0},
                       G, 1, 0, T * B, xproj};
  return (int)(bf16 ? rnn_x_fwd_launch<LstmXpFwdCell, true>(a, G, st) : rnn_x_fwd_launch<LstmXpFwdCell, false>(a, G, st));
}

// The cluster forward's grid for these shapes on the current card: seven
// ints, as rnn_xp_fwd_plan (rnn_fwd.cuh) gives them, all zero where
// lstm_xp_fwd runs the one-thread-per-column kernels.
extern "C" int lstm_xp_fwd_plan(int G, int B, int H, int bf16, int* out) {
  return rnn_xp_fwd_plan<LstmXpFwdCell>(G, B, H, bf16, kFp32Cost, out);
}

// The three phases of rnn_bwd.cuh over the G streams, each with its own reset
// mask: the gates GEMM over the G*T*B rows adding xproj, then one chain launch
// a step; gs is the gradient of xproj. phase_ms: nullptr, or three floats
// that receive the milliseconds of the phases (gates, chain, and 0 for the dx
// phase the xproj backward does not have; the call then waits for the stream).
extern "C" int lstm_xp_bwd(const float* xproj, const float* resets, const float* c0,
                           const float* h0, const float* wh, const float* whT, const float* bh,
                           const float* hs, const float* cs, const float* ghs, float* dc0,
                           float* dh0, float* gs, int G, int T, int B, int H, int bf16,
                           void* stream, float* phase_ms) {
  if (bad_dims(G, T, B, 0, H)) return (int)cudaErrorInvalidValue;
  if (G == 0 || T == 0 || B == 0) return 0;
  const RnnBwdArgs a{nullptr, resets, c0, h0, nullptr, wh, whT, bh, nullptr, hs, cs, ghs, nullptr, dc0, dh0,
                     gs, T, B, 0, H, T * B, xproj};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rnn_bwd_launch<LstmXpCell, true>(a, G, st, phase_ms)
                    : rnn_bwd_launch<LstmXpCell, false>(a, G, st, phase_ms));
}

// The weight-gradient reduction of rnn_wgrad.cuh with no x columns and one
// reset mask per stream: C = Σ_rows [h_masked | 1]ᵀ [di|df|dg|do] = dWh | dbh,
// with h0 as the carry entering step 0.
extern "C" int lstm_xp_wgrad(const float* resets, const float* h0, const float* hs,
                             const float* gs, float* W, float* C, int G, int T, int B, int H,
                             int P, int bf16, void* stream) {
  return rnn_wgrad_launch(nullptr, resets, h0, hs, gs, W, C, G, T, B, 0, H, P, bf16, 1, 0, stream);
}
