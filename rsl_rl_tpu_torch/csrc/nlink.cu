// One step of the N-link pendulum for every env of a batch, for Hopper (sm_90a):
// NLinkPendulum.step of rsl_rl_tpu_torch/env/nlink.py on CUDA tensors.
//
// Replaces no Pallas kernel. The JAX package's step (rsl_rl_tpu/env/nlink.py)
// is plain jnp that XLA fuses under jit; the port's plain step issues every
// [N] column of its unrolled Cholesky as its own torch op, about 560 kernels
// a step, so a graph replay spends about 1.25 us a launch on work that fits
// in registers.
//
// What bounds it: latency. A step of 4096 five-link envs moves about 0.7 MB
// and does about 20 MFLOP (4 substeps of L^2 sines, L(L+1)/2 cosines and the
// Cholesky), under a microsecond of the card's bytes or fp32 rate.
// Design: one launch a step, one thread an env, everything in registers: the
// env's [L] state, its [L, L] mass matrix and its Cholesky factor (L a
// template parameter, 1 <= L <= 8); blocks of 32 threads spread the envs over
// every SM.
//
// The arithmetic is the plain step's, op for op: each elementwise op rounds
// as torch's CUDA op does (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn, never
// contracted into an FMA; sinf / cosf, which torch's kernels call; clamps
// that pass NaN through; a division by a Python float is a product with its
// fp32 reciprocal, as torch computes it), and the sums over L follow the
// order of torch's reduce kernel for an inner dimension under 128
// (torch_sum). The reset draws are the same splitmix64 integer ops.
//
// Layouts (contiguous; N envs, L links): theta, omega, actions, theta_out,
// omega_out [N,L] fp32; episode_length(_out) [N] int32; keys(_out) [N] int64;
// max_len [N] int32 or null (then max_len_scalar for every env); coup
// [L,L] fp32 at env stride coup_stride (0: one plant for all envs, else
// L*L); gdiag [L] at env stride gdiag_stride (0 or L); lengths [L]; reward,
// height [N] fp32; done [N] bool; extra_bits [N, extra_draws] int64, the
// reset's raw draws past theta's and omega's 2L (a subclass's per-episode
// fields). consts: the 13 host floats of NlinkConsts in order.
//
// The entry point launches one kernel on the given stream, allocates nothing,
// and returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxLinks = 8;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMix2 = 0x94D049BB133111EBull;

struct NlinkConsts {
  float max_torque, max_speed, damping, h, inv_total_len, mean_factor;
  float theta_low, theta_width, omega_low, omega_width;
  float chol_floor, speed_weight, effort_weight;
};

struct NlinkArgs {
  const float* theta;
  const float* omega;
  const float* actions;
  const int32_t* episode_length;
  const int64_t* keys;
  const int32_t* max_len;
  const float* coup;
  const float* gdiag;
  const float* lengths;
  float* theta_out;
  float* omega_out;
  int32_t* episode_length_out;
  int64_t* keys_out;
  float* reward;
  bool* done;
  float* height;
  int64_t* extra_bits;
  long long coup_stride, gdiag_stride;
  int n, max_len_scalar, extra_draws, n_substeps;
  NlinkConsts c;
};

// splitmix64's finalizer (env/nlink.py _mix; products wrap mod 2^64)
__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z = (z ^ (z >> 30)) * kMix1;
  z = (z ^ (z >> 27)) * kMix2;
  return z ^ (z >> 31);
}

// torch.clamp(v, lo, hi) and torch.clamp(v, min=lo): NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return isnan(v) ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

// torch.sum(x, dim=-1) of L contiguous fp32 values on the card (ATen's
// Reduce.cuh for an inner dimension under 128, held bit for bit against
// torch 2.11 on an H100 for L = 1..8): bw = 2^floor(log2 L) lanes share a
// row; lane l adds x[l] and x[l + bw] into two of its four accumulators
// started at 0, which combine in order; then the lanes combine by warp
// shuffles at offsets bw/2, bw/4, .., 1.
template <int L>
__device__ __forceinline__ float torch_sum(const float (&x)[L]) {
  constexpr int bw = L >= 8 ? 8 : L >= 4 ? 4 : L >= 2 ? 2 : 1;
  float lane[bw];
#pragma unroll
  for (int l = 0; l < bw; ++l) {
    const float a0 = __fadd_rn(0.0f, x[l]);
    const float a1 = l + bw < L ? __fadd_rn(0.0f, x[l + bw < L ? l + bw : 0]) : 0.0f;
    lane[l] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), 0.0f), 0.0f);
  }
#pragma unroll
  for (int off = bw / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) lane[l] = __fadd_rn(lane[l], lane[l + off]);
  }
  return lane[0];
}

template <int L>
__global__ void __launch_bounds__(kThreads) nlink_step_kernel(const NlinkArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.n) return;
  const NlinkConsts& c = a.c;
  const float* cp = a.coup + a.coup_stride * e;
  const float* gd = a.gdiag + a.gdiag_stride * e;
  float coup[L][L], gdiag[L], th[L], om[L], u[L], tau[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) coup[i][j] = cp[i * L + j];
    gdiag[i] = gd[i];
    th[i] = a.theta[(int64_t)e * L + i];
    om[i] = a.omega[(int64_t)e * L + i];
    u[i] = clamp(a.actions[(int64_t)e * L + i], -c.max_torque, c.max_torque);
  }
  // tau_i = u_i - u_{i+1}, and u_L = 0
#pragma unroll
  for (int i = 0; i < L; ++i) tau[i] = __fsub_rn(u[i], i + 1 < L ? u[i + 1 < L ? i + 1 : 0] : 0.0f);

#pragma unroll 1
  for (int s = 0; s < a.n_substeps; ++s) {
    // M's lower triangle (factored in place below) and rhs = tau - C - G - damping * omega
    float m[L][L], rhs[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float terms[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float dth = __fsub_rn(th[i], th[j]);
        terms[j] = __fmul_rn(__fmul_rn(coup[i][j], sinf(dth)), __fmul_rn(om[j], om[j]));
        if (j <= i) m[i][j] = __fmul_rn(coup[i][j], cosf(dth));
      }
      const float C = torch_sum<L>(terms);
      const float G = __fmul_rn(gdiag[i], sinf(th[i]));
      rhs[i] = __fsub_rn(__fsub_rn(__fsub_rn(tau[i], C), G), __fmul_rn(c.damping, om[i]));
    }
    // the unrolled Cholesky of env/nlink.py _solve_spd
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float acc = m[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc = __fsub_rn(acc, __fmul_rn(m[i][k], m[j][k]));
        m[i][j] = i == j ? __fsqrt_rn(clamp_min(acc, c.chol_floor)) : __fdiv_rn(acc, m[j][j]);
      }
    }
    float y[L], x[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float acc = rhs[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = __fsub_rn(acc, __fmul_rn(m[i][k], y[k]));
      y[i] = __fdiv_rn(acc, m[i][i]);
    }
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      float acc = y[i];
#pragma unroll
      for (int k = i + 1; k < L; ++k) acc = __fsub_rn(acc, __fmul_rn(m[k][i], x[k]));
      x[i] = __fdiv_rn(acc, m[i][i]);
    }
    // semi-implicit Euler with the speed clamp between the two half-updates
#pragma unroll
    for (int i = 0; i < L; ++i) {
      om[i] = clamp(__fadd_rn(om[i], __fmul_rn(c.h, x[i])), -c.max_speed, c.max_speed);
      th[i] = __fadd_rn(th[i], __fmul_rn(c.h, om[i]));
    }
  }

  // reward = tip height - speed_weight * mean(omega^2) - effort_weight * mean(u^2)
  float tip[L], om2[L], u2[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    tip[i] = __fmul_rn(a.lengths[i], cosf(th[i]));
    om2[i] = __fmul_rn(om[i], om[i]);
    u2[i] = __fmul_rn(u[i], u[i]);
  }
  const float height = __fmul_rn(-torch_sum<L>(tip), c.inv_total_len);
  const float om2_mean = __fmul_rn(torch_sum<L>(om2), c.mean_factor);
  const float u2_mean = __fmul_rn(torch_sum<L>(u2), c.mean_factor);
  a.reward[e] = __fsub_rn(__fsub_rn(height, __fmul_rn(c.speed_weight, om2_mean)),
                          __fmul_rn(c.effort_weight, u2_mean));
  a.height[e] = height;

  // the time limit, then the key's next draws: every env draws a reset
  // state, kept where it is done
  const int32_t length = a.episode_length[e] + 1;
  const int32_t limit = a.max_len != nullptr ? a.max_len[e] : a.max_len_scalar;
  const bool done = length >= limit;
  const uint64_t key = static_cast<uint64_t>(a.keys[e]);
  const int draws = 2 * L + a.extra_draws;
  constexpr float kDrawScale = 1.0f / 16777216.0f;  // 2^-24
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t zt = mix(key + (uint64_t)(i + 1) * kGolden);
    const uint64_t zo = mix(key + (uint64_t)(L + i + 1) * kGolden);
    const float ft = __fadd_rn(__fmul_rn(__fmul_rn((float)(zt >> 40), c.theta_width), kDrawScale), c.theta_low);
    const float fo = __fadd_rn(__fmul_rn(__fmul_rn((float)(zo >> 40), c.omega_width), kDrawScale), c.omega_low);
    a.theta_out[(int64_t)e * L + i] = done ? ft : th[i];
    a.omega_out[(int64_t)e * L + i] = done ? fo : om[i];
  }
  for (int k = 2 * L; k < draws; ++k)
    a.extra_bits[(int64_t)e * a.extra_draws + (k - 2 * L)] =
        static_cast<int64_t>(mix(key + (uint64_t)(k + 1) * kGolden));
  a.keys_out[e] = static_cast<int64_t>(mix(key + (uint64_t)(draws + 1) * kGolden));
  a.episode_length_out[e] = done ? 0 : length;
  a.done[e] = done;
}

template <int L>
cudaError_t launch(const NlinkArgs& a, cudaStream_t stream) {
  nlink_step_kernel<L><<<(a.n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nlink_step(const float* theta, const float* omega, const float* actions,
                          const int32_t* episode_length, const int64_t* keys, const int32_t* max_len,
                          int max_len_scalar, const float* coup, long long coup_stride, const float* gdiag,
                          long long gdiag_stride, const float* lengths, float* theta_out, float* omega_out,
                          int32_t* episode_length_out, int64_t* keys_out, float* reward, bool* done,
                          float* height, int64_t* extra_bits, int n, int num_links, int extra_draws,
                          int n_substeps, const float* consts, void* stream) {
  if (num_links < 1 || num_links > kMaxLinks || n < 0 || extra_draws < 0 || n_substeps < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  NlinkArgs a{theta,      omega,        actions,   episode_length,
              keys,       max_len,      coup,      gdiag,
              lengths,    theta_out,    omega_out, episode_length_out,
              keys_out,   reward,       done,      height,
              extra_bits, coup_stride,  gdiag_stride, n,
              max_len_scalar, extra_draws, n_substeps, {}};
  const float* f = consts;
  a.c = NlinkConsts{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11], f[12]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (num_links) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    case 4: return (int)launch<4>(a, st);
    case 5: return (int)launch<5>(a, st);
    case 6: return (int)launch<6>(a, st);
    case 7: return (int)launch<7>(a, st);
    default: return (int)launch<8>(a, st);
  }
}
