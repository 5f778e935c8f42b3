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
// unit. The build stays dense here (every compare and add is done): the
// probe prices the one-hot form on CUDA cores, beside the gather form that
// the port's MSDA kernels use.
//
// Variants, the tool's eight (template arguments of one kernel):
//   null        acc += float(c + k): the machinery alone;
//   base        idx and w read from shared memory inside every chain, both
//               in one 8-byte load (volatile: left to itself, nvcc loads
//               them once before the chains, and base compiles to hoist's
//               program);
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
// 640 = 335.5 M chain elements of at least 2 instructions each: a compare
// into a predicate and an add predicated on it (`oh` starts at +0 and w is
// never negative, so skipping the add of 0 gives the select's bits). That
// is 0.67 G lane-instructions over the card's ~33.5 T per second (132 SMs x
// 128 lanes x 1.98 GHz), ~20 us, and the same ~20 us for the compares alone
// on the 64-lane integer pipe; ~15 us packed (a compare, a mask and an add
// per two elements). The bytes are the 2.6 MB tile (0.8 us).
//
// What the design does about it:
// - the select form `oh + (col == id ? w : 0)` compiles to ISETP + FSEL +
//   FADD, and FSEL shares the half-rate pipe with ISETP. So the fp32 base
//   and hoist compare into a predicate and add under it in inline PTX
//   (`setp.eq.s32`, then `@p add.rn.f32`): ISETP and a predicated FADD,
//   two instructions an element (ptxas folds a chain's first add, onto the
//   +0 that `oh` starts from, into one select of w or 0);
// - those two own four columns of a tile row each, a quarter tile apart (c,
//   c + 160, c + 320, c + 480; a block of 160 threads is one tile row), so
//   in `base` the one shared-memory read of (idx, w) at each chain element
//   serves four compares, not two. The other variants keep two
//   columns a thread, half a tile apart (320 threads a block): with four,
//   their longer chains had too few warps to hide their latency. So the
//   variants do not all run the same threads, and a comparison across the
//   two layouts prices the layout with the formulation. The packed variants
//   hold their two columns in one lane. The scalar bf16 variants keep the
//   select: ptxas turns `@p add.rn.bf16` into a select, a byte permute and a
//   paired HADD2, slower than the select form. The columns are far apart,
//   not neighbours: the chain of column c + 1 at k is the chain of column c
//   at k + 1, and with neighbouring columns nvcc shares those chains and
//   skips dense work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kQT = 64;    // tile rows
constexpr int kTS = 640;   // tile columns
constexpr int kJC = 16;    // chains a row: idx / w columns
constexpr int kReps = 32;  // k

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

// oh += w where col == id: a compare into a predicate and an add under it,
// no select (oh is never -0, so skipping the add of +0 keeps its bits)
__device__ __forceinline__ void add_if_equal(float& oh, int col, int id, float w) {
  asm("{\n.reg .pred p;\nsetp.eq.s32 p, %1, %2;\n@p add.rn.f32 %0, %0, %3;\n}\n"
      : "+f"(oh)
      : "r"(col), "r"(id), "f"(w));
}

// idx[j] and w[j] of the tile row, side by side in shared memory, read
// where they stand in the chain in one 8-byte load: a volatile load is
// neither hoisted out of the loops nor shared between chains
struct Term {
  int id;
  float w;
};

__device__ __forceinline__ Term chain_read(const int2* p) {
  int id, w;
  asm volatile("ld.volatile.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(id), "=r"(w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return {id, __int_as_float(w)};
}

// Columns a thread owns, a 1 / COLS tile apart: 4 for the fp32 base and
// hoist (one pair of idx, w reads serves four compares), 2 for the others.
// More columns a thread means fewer threads, and the variants whose chains
// are longer than a compare and an add ran slower with 4 (fewer warps to
// hide their latency).
template <int V, int ACC>
constexpr int kColumns = (ACC == 0 && (V == kBase || V == kHoist)) ? 4 : 2;

// fp32 accumulators, int32 compares: COLS independent columns a thread,
// c + (kTS / COLS) * i
template <int V, int COLS>
__device__ __forceinline__ void build_f32(int c, const int* s_idx, const float* s_w,
                                          const int2* s_pair, float (&acc)[COLS]) {
  constexpr int kStride = kTS / COLS;
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
  for (int i = 0; i < COLS; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    float oh[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      oh[i] = (V == kNull) ? static_cast<float>(c + kStride * i + k) : 0.f;
    }
    if constexpr (V != kNull) {
#pragma unroll
      for (int j = 0; j < kJC; ++j) {
        const Term t = (V == kBase) ? chain_read(s_pair + j) : Term{idx[j], w[j]};
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int col = c + kStride * i + k;
          if constexpr (V == kArith) {
            oh[i] = fmaf(static_cast<float>(col == t.id), t.w, oh[i]);  // 0 * w or 1 * w: exact
          } else {
            add_if_equal(oh[i], col, t.id, t.w);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < COLS; ++i) acc[i] = acc[i] + oh[i];
  }
}

// bf16 accumulators, int32 compares: scalar bf16 adds, one per column. The
// select stays: ptxas turns `@p add.rn.bf16` into a select, a byte permute
// and a paired HADD2 (3.5 instructions an element), slower than this form.
template <int V>
__device__ __forceinline__ void build_i32_bf16(int c, const int* s_idx, const float* s_w,
                                               const int2* s_pair, float (&out)[2]) {
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
    const int col0 = c + k, col1 = c + kTS / 2 + k;
    __nv_bfloat16 oh0 = zero, oh1 = zero;
#pragma unroll
    for (int j = 0; j < kJC; ++j) {
      int id;
      __nv_bfloat16 wj;
      if constexpr (V == kBase) {
        const Term t = chain_read(s_pair + j);
        id = t.id;
        wj = __float2bfloat16_rn(t.w);
      } else {
        id = idx[j];
        wj = w[j];
      }
      oh0 = __hadd(oh0, col0 == id ? wj : zero);
      oh1 = __hadd(oh1, col1 == id ? wj : zero);
    }
    acc0 = __hadd(acc0, oh0);
    acc1 = __hadd(acc1, oh1);
  }
  out[0] = __bfloat162float(acc0);
  out[1] = __bfloat162float(acc1);
}

// bf16 accumulators, int16 compares: both columns (c, c + kTS / 2) in one
// 32-bit lane
template <int V>
__device__ __forceinline__ void build_i16_bf16(int c, const int* s_idx, const float* s_w,
                                               float (&out)[2]) {
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
    // low half column c, high half c + kTS / 2, both + k (< 672: fits int16)
    const uint32_t col2 = (static_cast<uint32_t>(c + k) & 0xffffu) |
                          (static_cast<uint32_t>(c + kTS / 2 + k) << 16);
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
  const float2 v = __bfloat1622float2(acc);
  out[0] = v.x;
  out[1] = v.y;
}

// ACC: 0 fp32 (int32 compares), 1 bf16 with int32 compares, 2 bf16 with
// packed int16 compares. A block is one tile row, kTS / COLS threads.
template <int V, int ACC>
__global__ void __launch_bounds__(kTS / kColumns<V, ACC>)
pack_tile_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out) {
  constexpr int kCols = kColumns<V, ACC>;
  __shared__ int s_idx[kJC];
  __shared__ float s_w[kJC];
  __shared__ int2 s_pair[kJC];  // (idx, w's bits): base's one read a chain element
  const int q = blockIdx.x;
  const long long row = static_cast<long long>(blockIdx.y) * kQT + q;
  if (threadIdx.x < kJC) {
    s_idx[threadIdx.x] = idx[row * kJC + threadIdx.x];
    s_w[threadIdx.x] = w[row * kJC + threadIdx.x];
    if constexpr (V == kBase) {
      s_pair[threadIdx.x] = make_int2(s_idx[threadIdx.x], __float_as_int(s_w[threadIdx.x]));
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  float v[kCols];
  if constexpr (ACC == 0) {
    build_f32<V, kCols>(c, s_idx, s_w, s_pair, v);
  } else if constexpr (ACC == 1) {
    build_i32_bf16<V>(c, s_idx, s_w, s_pair, v);
  } else {
    build_i16_bf16<V>(c, s_idx, s_w, v);
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) out[row * kTS + c + (kTS / kCols) * i] = v[i];
}

template <int V, int ACC>
int run(const void* idx, const void* w, void* out, int bh, cudaStream_t stream) {
  const dim3 grid(kQT, bh);
  pack_tile_kernel<V, ACC><<<grid, kTS / kColumns<V, ACC>, 0, stream>>>(
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
