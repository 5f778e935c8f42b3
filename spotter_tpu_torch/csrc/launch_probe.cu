// The launch probe: out = 2 * x on an fp32 array, one (8, 128) tile as the
// tool runs it. It replaces the trivial Pallas kernel of
// tools/profile_r101.py's `launch` part (`_k`, :316-320), which measures the
// fixed cost of one pallas_call. Here it prices one kernel launch, launched
// eagerly from Python (wrapper, ctypes, the driver's launch) and replayed
// from a CUDA graph.
//
// What bounds it on an H100: bytes, trivially: 4 KB read and 4 KB written
// take 2.4 ns at 3.35 TB/s. Its time is the launch's fixed cost, which is
// the finding; a block of 256 threads moves 4 floats each (one float4).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
launch_probe_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(out + i) = make_float4(v.x * 2.f, v.y * 2.f, v.z * 2.f, v.w * 2.f);
  } else {
    for (long long e = i; e < n; ++e) out[e] = x[e] * 2.f;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. x and out are contiguous fp32
// device arrays of n > 0 elements, 16-byte aligned. The stream is the
// caller's current CUDA stream (a capturing stream records the launch into
// its graph). Returns the CUDA error of the launch (0 on success).
extern "C" int launch_probe_double(const void* x, void* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  launch_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* launch_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
