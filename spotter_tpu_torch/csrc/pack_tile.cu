// The one-hot tile build, alone: for each of BH grid rows, from idx (64, 16)
// int32 in [0, 640) and w (64, 16) fp32, the (64, 640) fp32 tile
//
//     acc[q, c] = sum_{k < 32} sum_{j < 16} where(c + k == idx[q, j], w[q, j], 0)
//
// summed in that order: each chain `oh` starts from zero and adds over j,
// then `acc` adds over k, in the accumulator's type, cast to fp32 at the
// end. It replaces the Pallas kernel of tools/bench_pack_probe.py::run
// (body `_kernel`, :44), which measures what the dense one-hot formulation
// of the merged MSDA kernel costs per formulation on the TPU's vector
// unit. The build stays dense here (every compare, select and add is
// done): the probe prices the one-hot form on CUDA cores, beside the gather
// form that the port's MSDA kernels use.
//
// Variants, the tool's eight (template arguments of one kernel):
//   null        acc += float(c + k): the machinery alone;
//   base        idx and w read from shared memory inside every chain;
//   hoist       idx and w read once into registers before the chains;
//   arith       oh += float(c + k == idx) * w (a multiply for the select);
//   i32 / bf16  int32 compares, bf16 accumulators (each add rounded to bf16);
//   i16 / bf16  two columns per 32-bit lane: __vcmpeq2 compares both 16-bit
//               halves at once, the select is an AND with the packed bf16
//               weight, and __hadd2 / __hfma2 add both halves, each rounded
//               to bf16 as the TPU's packed lanes round. This is the CUDA
//               counterpart of the TPU's "2x-packed" question.
//
// What bounds it on an H100: instructions. BH = 16 runs 16 x 32 x 16 x 64 x
// 640 = 335.5 M chain elements of at least 2 instructions each (a compare
// and an add predicated on it: `oh` starts at +0, so skipping the add of 0
// gives the select's bits): 0.67 G lane-instructions over the card's
// ~33.5 T per second (132 SMs x 128 lanes x 1.98 GHz), ~20 us, and the
// same ~20 us for the compares alone on the 64-lane integer pipe; ~15 us
// packed (a compare, a mask and an add per two elements). The bytes are
// the 2.6 MB tile (0.8 us). A thread owns two columns of one tile row, c
// and c + 320, so the packed and unpacked variants run the same threads and
// differ only in instructions; a block is one tile row (320 threads). The
// two columns are half a tile apart, not neighbours: the chain of column
// c + 1 at k is the chain of column c at k + 1, and with neighbouring
// columns nvcc shares those chains and skips half the dense work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kQT = 64;    // tile rows
constexpr int kTS = 640;   // tile columns
constexpr int kJC = 16;    // chains a row: idx / w columns
constexpr int kReps = 32;  // k
constexpr int kThreads = kTS / 2;
constexpr int kHalf = kTS / 2;  // a thread's second column: c + kHalf

enum Variant { kNull = 0, kBase = 1, kHoist = 2, kArith = 3 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(v));
  return v;
}

// fp32 accumulators, int32 compares: two independent columns a thread, c
// and c + kHalf
template <int V>
__device__ __forceinline__ float2 build_f32(int c, const int* s_idx, const float* s_w) {
  float acc0 = 0.f, acc1 = 0.f;
  int idx[kJC];
  float w[kJC];
  if constexpr (V == kHoist || V == kArith) {
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      idx[j] = s_idx[j];
      w[j] = s_w[j];
    }
  }
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    const int col0 = c + k, col1 = c + kHalf + k;
    float oh0 = 0.f, oh1 = 0.f;
    if constexpr (V == kNull) {
      oh0 = static_cast<float>(col0);
      oh1 = static_cast<float>(col1);
    } else {
#pragma unroll
      for (int j = 0; j < kJC; ++j) {
        const int id = (V == kBase) ? s_idx[j] : idx[j];
        const float wj = (V == kBase) ? s_w[j] : w[j];
        if constexpr (V == kArith) {
          oh0 = fmaf(static_cast<float>(col0 == id), wj, oh0);  // 0 * w or 1 * w: exact
          oh1 = fmaf(static_cast<float>(col1 == id), wj, oh1);
        } else {
          oh0 = oh0 + (col0 == id ? wj : 0.f);
          oh1 = oh1 + (col1 == id ? wj : 0.f);
        }
      }
    }
    acc0 = acc0 + oh0;
    acc1 = acc1 + oh1;
  }
  return make_float2(acc0, acc1);
}

// bf16 accumulators, int32 compares: scalar bf16 adds, one per column
template <int V>
__device__ __forceinline__ float2 build_i32_bf16(int c, const int* s_idx, const float* s_w) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  __nv_bfloat16 acc0 = zero, acc1 = zero;
  int idx[kJC];
  __nv_bfloat16 w[kJC];
  if constexpr (V == kHoist) {
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      idx[j] = s_idx[j];
      w[j] = __float2bfloat16_rn(s_w[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    const int col0 = c + k, col1 = c + kHalf + k;
    __nv_bfloat16 oh0 = zero, oh1 = zero;
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      const int id = (V == kBase) ? s_idx[j] : idx[j];
      const __nv_bfloat16 wj = (V == kBase) ? __float2bfloat16_rn(s_w[j]) : w[j];
      oh0 = __hadd(oh0, col0 == id ? wj : zero);
      oh1 = __hadd(oh1, col1 == id ? wj : zero);
    }
    acc0 = __hadd(acc0, oh0);
    acc1 = __hadd(acc1, oh1);
  }
  return make_float2(__bfloat162float(acc0), __bfloat162float(acc1));
}

// bf16 accumulators, int16 compares: both columns in one 32-bit lane
template <int V>
__device__ __forceinline__ float2 build_i16_bf16(int c, const int* s_idx, const float* s_w) {
  uint32_t idx2[kJC], w2[kJC];
#pragma unroll
  for (int j = 0; j < kJC; ++j) {
    const uint32_t id = static_cast<uint32_t>(s_idx[j]) & 0xffffu;  // < 640: fits int16
    idx2[j] = id | (id << 16);
    w2[j] = bits(__bfloat162bfloat162(__float2bfloat16_rn(s_w[j])));
  }
  const uint32_t one2 = bits(__bfloat162bfloat162(__float2bfloat16_rn(1.f)));
  __nv_bfloat162 acc = bf2(0u);
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    // low half column c, high half c + kHalf, both + k (< 672: fits int16)
    const uint32_t col2 = (static_cast<uint32_t>(c + k) & 0xffffu) |
                          (static_cast<uint32_t>(c + kHalf + k) << 16);
    __nv_bfloat162 oh = bf2(0u);
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      const uint32_t eq = __vcmpeq2(col2, idx2[j]);  // 0xffff in each equal half
      if constexpr (V == kArith) {
        oh = __hfma2(bf2(eq & one2), bf2(w2[j]), oh);  // 1 * w + oh or 0 * w + oh
      } else {
        oh = __hadd2(oh, bf2(eq & w2[j]));
      }
    }
    acc = __hadd2(acc, oh);
  }
  return __bfloat1622float2(acc);
}

// ACC: 0 fp32 (int32 compares), 1 bf16 with int32 compares, 2 bf16 with
// packed int16 compares
template <int V, int ACC>
__global__ void __launch_bounds__(kThreads)
pack_tile_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out) {
  __shared__ int s_idx[kJC];
  __shared__ float s_w[kJC];
  const int q = blockIdx.x;
  const long long row = static_cast<long long>(blockIdx.y) * kQT + q;
  if (threadIdx.x < kJC) {
    s_idx[threadIdx.x] = idx[row * kJC + threadIdx.x];
    s_w[threadIdx.x] = w[row * kJC + threadIdx.x];
  }
  __syncthreads();
  const int c = threadIdx.x;
  float2 v;
  if constexpr (ACC == 0) {
    v = build_f32<V>(c, s_idx, s_w);
  } else if constexpr (ACC == 1) {
    v = build_i32_bf16<V>(c, s_idx, s_w);
  } else {
    v = build_i16_bf16<V>(c, s_idx, s_w);
  }
  out[row * kTS + c] = v.x;
  out[row * kTS + c + kHalf] = v.y;
}

template <int V, int ACC>
int run(const void* idx, const void* w, void* out, int bh, cudaStream_t stream) {
  const dim3 grid(kQT, bh);
  pack_tile_kernel<V, ACC><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. idx (bh, 64, 16) int32 with every
// value in [0, 640), w (bh, 64, 16) fp32, out (bh, 64, 640) fp32: contiguous
// device arrays. variant: 0 null, 1 base i32/f32,
// 2 hoist i32/f32, 3 arith i32/f32, 4 hoist i32/bf16, 5 hoist16 i16/bf16,
// 6 arith i16/bf16, 7 base i32/bf16 (the tool's order). The stream is the
// caller's current CUDA stream. Returns the CUDA error of the launch (0 on
// success); nothing synchronises or allocates.
extern "C" int pack_tile_build(const void* idx, const void* w, void* out, int bh, int variant,
                               void* stream) {
  if (bh < 1 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return run<kNull, 0>(idx, w, out, bh, s);
    case 1: return run<kBase, 0>(idx, w, out, bh, s);
    case 2: return run<kHoist, 0>(idx, w, out, bh, s);
    case 3: return run<kArith, 0>(idx, w, out, bh, s);
    case 4: return run<kHoist, 1>(idx, w, out, bh, s);
    case 5: return run<kHoist, 2>(idx, w, out, bh, s);
    case 6: return run<kArith, 2>(idx, w, out, bh, s);
    case 7: return run<kBase, 1>(idx, w, out, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pack_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
