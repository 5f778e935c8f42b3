// Multiscale deformable attention (MSDA) sampling: weighted row gather-sum.
//
// Replaces the TPU kernel spotter_tpu/ops/msda.py::pallas_onehot_sampling_merged
// (body _onehot_merged_kernel). Both compute, for each (b*h, query),
//
//     out[bh, q, :] = sum_j w[bh, q, j] * rows[bh, idx[bh, q, j], :]
//
// over the J = levels * points * corners sample terms that the corner prep
// (spotter_tpu_torch/ops/msda.py::prepare_msda_gather) produced, accumulated
// and returned in fp32. The TPU kernel builds one-hot tiles and contracts them
// on the MXU because the TPU has no fast gather; its level padding to S_TILE,
// locality sort and block-sparse hit mask all serve that workaround. Hopper
// gathers rows directly, so none of it is carried over.
//
// What bounds it on an H100: memory. At the RT-DETR decoder shapes
// (B*H = 8*B, S = 8400, hd = 32, Q = 300, J = 48) the least traffic is one
// read of rows, idx and w plus one write of out, ~78.6 MB at B = 8 (~23.5 us at
// 3.35 TB/s), against 2*BH*Q*J*hd ~ 59 MFLOP of fp32 FMAs, which is nothing.
// The gather reads each value row 300*48/8400 ~ 1.7 times per head on average,
// and the rows of one head (1.07 MB fp32) stay in the 50 MB L2 while its
// queries run, so repeat reads are L2 hits.
//
// Design, first and simple: one warp per (bh, q), the 32 lanes over hd
// (hd = 32 on this model: one lane per channel, so each sample term is one
// coalesced 128-byte row read followed by an fp32 FMA; hd != 32 loops over
// channels in steps of 32). The warp loads its query's idx/w once, 32 terms
// per coalesced load, and broadcasts each term to all lanes with a shuffle.
// Four warps per block. An index < 0 or >= S is skipped, so a bad index can
// never read out of bounds. Staging rows in shared memory and fusing the
// corner prep are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_gather_sum_kernel(const T* __restrict__ rows, const int32_t* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int bh_count, int s, int hd, int q, int j) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)bh_count * q) return;  // whole warp exits together
  const long long bh = warp / q;

  const int32_t* idx_q = idx + warp * j;
  const float* w_q = w + warp * j;
  const T* rows_bh = rows + bh * (long long)s * hd;
  float* out_q = out + warp * hd;

  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool lane_on = c < hd;
    float acc = 0.0f;
    for (int j0 = 0; j0 < j; j0 += 32) {
      const int jj = j0 + lane;
      int32_t my_s = -1;
      float my_w = 0.0f;
      if (jj < j) {
        my_s = __ldg(idx_q + jj);
        my_w = __ldg(w_q + jj);
      }
      const int n = min(32, j - j0);
      for (int k = 0; k < n; ++k) {
        const int32_t sk = __shfl_sync(0xffffffffu, my_s, k);
        const float wk = __shfl_sync(0xffffffffu, my_w, k);
        if (lane_on && sk >= 0 && sk < s) {
          acc = fmaf(wk, load_as_float(rows_bh + (long long)sk * hd + c), acc);
        }
      }
    }
    if (lane_on) out_q[c] = acc;
  }
}

template <typename T>
int launch(const void* rows, const void* idx, const void* w, void* out, int bh_count,
           int s, int hd, int q, int j, void* stream) {
  const long long warps = (long long)bh_count * q;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_gather_sum_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), bh_count, s, hd, q, j);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers; the
// stream is the caller's current CUDA stream. Returns cudaGetLastError()
// after the launch (0 on success). Never synchronises, never allocates.
extern "C" int msda_gather_sum_f32(const void* rows, const void* idx, const void* w,
                                   void* out, int bh_count, int s, int hd, int q, int j,
                                   void* stream) {
  return launch<float>(rows, idx, w, out, bh_count, s, hd, q, j, stream);
}

extern "C" int msda_gather_sum_bf16(const void* rows, const void* idx, const void* w,
                                    void* out, int bh_count, int s, int hd, int q, int j,
                                    void* stream) {
  return launch<__nv_bfloat16>(rows, idx, w, out, bh_count, s, hd, q, j, stream);
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
