// OWL-ViT / OWLv2 class-logit head: normalize, cosine product, affine and
// query mask in one pass,
//
//     n         = sqrt(sum_d img[r, d]^2) + 1e-6
//     out[r, q] = (img[r, :] . bank[q, :] / n + shift[r]) * (elu(scale[r]) + 1)
//     out[r, q] = NEG_INF (float32 min) where mask[q] == 0
//
// for every patch row r of the (B*P, Dt) dense0 output, against the
// pre-normalized (Q, Dt) query bank. It replaces the Pallas kernel
// spotter_tpu/ops/openvocab.py::pallas_class_logits (body :58). The TPU
// kernel pads P to 128 rows and Q to 128 lanes; nothing is padded here: rows
// past B*P and queries past Q are never written.
//
// What bounds it on an H100: bytes. At OWLv2 (B = 8, P = 3600, Dt = 512,
// Q = 22) the img read is 59 MB (18 us at 3.35 TB/s) against 0.65 GFLOP of
// fp32 FMAs (10 us at 67 TFLOP/s). So each img element is read from device
// memory once, with coalesced 16-byte loads, and the product is a skinny
// fp32 GEMV on CUDA cores (TF32 tensor cores would round the inputs):
//
// - one warp owns 4 patch rows at a time: lane l holds columns
//   (c * 32 + l) * 4 .. + 3 of each, c < Dt / 128 (Dt up to 1024, a
//   multiple of 4), so a warp reads each row as contiguous 512-byte runs,
//   and the row norms are 5 xor-shuffles;
// - a block stages a tile of up to 32 queries x Dt of the bank in shared
//   memory (64 KB at Dt = 512) and loops over tiles when Q is larger; its 8
//   warps walk the rows, so one bank load from shared memory serves 4 rows;
// - each lane sums its share of the 4 rows x 8 queries dot products, and a
//   reduce-scatter butterfly over the 32 lanes (16 + 8 + 4 + 2 + 1
//   shuffles) leaves lane l with the whole sum for row l / 8, query l % 8;
// - the epilogue divides by the norm and applies shift, elu-scale and the
//   mask before the one store of each logit.
//
// The number of blocks is capped at a few per SM; a block walks many row
// groups, so the bank is staged from L2 a few hundred times, not once per
// row group. More than 32 queries re-read the rows once per further tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;               // rows a warp carries at once
constexpr int kSub = 8;                // queries per butterfly: kRows * kSub = 32 lanes
constexpr int kTQ = 32;                // queries staged in shared memory per tile
constexpr int kBlocksPerSm = 2;        // grid cap; at Dt = 512 (168 registers) one is resident
constexpr int kMaxChunks = 8;          // Dt <= 1024
static_assert(kRows * kSub == 32, "the butterfly leaves one sum per lane");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Reduce-scatter over the warp: at offset O a lane keeps the half of its 2 * O
// values whose index has bit O equal to its lane's, adding its partner's
// share of them. After O = 1, v[0] is the sum over all 32 lanes of the
// value whose index is the lane's own.
template <int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_scatter<O / 2>(v, lane);
}

// C = ceil(Dt / 128): the float4 chunks of a row that each lane holds
// (columns past Dt read as zeros)
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
class_logits_kernel(const T* __restrict__ img, const float* __restrict__ bank,
                    const float* __restrict__ shift, const float* __restrict__ scale,
                    const int* __restrict__ mask, float* __restrict__ out, long long rows,
                    int dt, int q_count) {
  extern __shared__ float4 bank_s[];  // [kTQ][C * 32]: one query's row per C * 32 float4
  constexpr int kDt4 = C * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long groups = (rows + kRows - 1) / kRows;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the butterfly's result at this lane: row my_r of the group, query my_q of the pass
  const int my_r = lane / kSub;
  const int my_q = lane % kSub;

  for (int q0 = 0; q0 < q_count; q0 += kTQ) {
    const int tq = min(kTQ, q_count - q0);
    __syncthreads();  // the previous tile's readers are done with bank_s
    for (int i = threadIdx.x; i < kTQ * kDt4; i += kThreads) {
      const int q = i / kDt4;
      const int col = (i % kDt4) * 4;
      bank_s[i] = (q < tq && col < dt)
                      ? load4(bank + static_cast<long long>(q0 + q) * dt + col) : zero;
    }
    __syncthreads();

    for (long long g = first; g < groups; g += stride) {
      const long long r0 = g * kRows;
      float4 x[kRows][C];
      float nrm[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = r0 + r < rows;
        const T* row = img + (r0 + r) * dt;
        float ss = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = (c * 32 + lane) * 4;
          x[r][c] = (live && col < dt) ? load4(row + col) : zero;
          ss = dot4(x[r][c], x[r][c], ss);
        }
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        nrm[r] = sqrtf(ss) + 1e-6f;
      }
      // this lane's row of the group: shift, elu-scale and norm for the epilogue
      const long long my_row = r0 + my_r;
      float sh = 0.f, sc = 0.f, n = 1.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) n = (r == my_r) ? nrm[r] : n;
      if (my_row < rows) {
        sh = shift[my_row];
        const float sc_raw = scale[my_row];
        sc = (sc_raw > 0.f ? sc_raw : expm1f(sc_raw)) + 1.f;  // the TPU kernel's expm1 form
      }

      for (int s0 = 0; s0 < tq; s0 += kSub) {
        float v[kRows * kSub];  // v[r * kSub + q]: this lane's share of row r . query s0 + q
#pragma unroll
        for (int i = 0; i < kRows * kSub; ++i) v[i] = 0.f;
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          const float4* b = bank_s + (s0 + q) * kDt4 + lane;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float4 bq = b[c * 32];
#pragma unroll
            for (int r = 0; r < kRows; ++r) v[r * kSub + q] = dot4(x[r][c], bq, v[r * kSub + q]);
          }
        }
        reduce_scatter<16>(v, lane);  // v[0]: row my_r . query s0 + my_q
        const int q = s0 + my_q;
        if (my_row < rows && q < tq) {
          const bool masked = mask != nullptr && mask[q0 + q] == 0;
          out[my_row * q_count + q0 + q] = masked ? -FLT_MAX : (v[0] / n + sh) * sc;
        }
      }
    }
  }
}

template <typename T, int C>
int run(const void* img, const void* bank, const void* shift, const void* scale,
        const void* mask, void* out, long long rows, int dt, int q_count, unsigned blocks,
        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTQ) * C * 32 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(class_logits_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  class_logits_kernel<T, C><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(bank),
      static_cast<const float*>(shift), static_cast<const float*>(scale),
      static_cast<const int*>(mask), static_cast<float*>(out), rows, dt, q_count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* img, const void* bank, const void* shift, const void* scale,
           const void* mask, void* out, long long rows, int dt, int q_count, void* stream) {
  if (rows < 1 || q_count < 1 || dt < 4 || dt % 4 != 0 || dt > kMaxChunks * 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (rows + kRows - 1) / kRows;
  long long blocks = (groups + kWarps - 1) / kWarps;
  const long long max_blocks = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > max_blocks) blocks = max_blocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dt + 127) / 128) {
    case 1: return run<T, 1>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 2: return run<T, 2>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 3: return run<T, 3>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 4: return run<T, 4>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 5: return run<T, 5>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 6: return run<T, 6>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    case 7: return run<T, 7>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
    default: return run<T, 8>(img, bank, shift, scale, mask, out, rows, dt, q_count, grid, s);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. img is a contiguous (rows, dt)
// device array of fp32 (or bf16, widened exactly to fp32), 16-byte (8-byte)
// aligned, with dt a multiple of 4 up to 1024; bank a contiguous, 16-byte
// aligned (q_count, dt) fp32 array of pre-normalized queries; shift and
// scale contiguous (rows,) fp32; mask a (q_count,) int32 array, 0 = masked,
// or null for all valid; out a contiguous (rows, q_count) fp32 array. The
// stream is the caller's current CUDA stream. Each returns the CUDA error of
// the launch (0 on success); none synchronises or allocates.
extern "C" int owl_class_logits_fp32(const void* img, const void* bank, const void* shift,
                                     const void* scale, const void* mask, void* out,
                                     long long rows, int dt, int q_count, void* stream) {
  return launch<float>(img, bank, shift, scale, mask, out, rows, dt, q_count, stream);
}

extern "C" int owl_class_logits_bf16(const void* img, const void* bank, const void* shift,
                                     const void* scale, const void* mask, void* out,
                                     long long rows, int dt, int q_count, void* stream) {
  return launch<__nv_bfloat16>(img, bank, shift, scale, mask, out, rows, dt, q_count, stream);
}

extern "C" const char* class_logits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
