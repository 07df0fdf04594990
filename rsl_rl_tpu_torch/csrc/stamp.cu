// Device clock stamps for the port's tracer (rsl_rl_tpu_torch/utils/trace.py).
//
// Replaces no TPU kernel. It was added so that an iteration replayed as a
// CUDA graph records its phase boundaries (collection, each env step, each
// collective, the update) on the device's own clock, with no host call and
// no synchronization: the stamps are captured with the iteration and read
// back with its metrics. One thread reads the GPU's global nanosecond timer
// (%globaltimer) and stores it; the kernel is bound by its launch, about a
// microsecond on the stream, which the tracer's cost counts.
//
// out: one int64 slot of a device tensor. The launch is on the given stream,
// allocates nothing, and returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

__global__ void stamp_kernel(int64_t* out) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = static_cast<int64_t>(t);
}

extern "C" int stamp(int64_t* out, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}
