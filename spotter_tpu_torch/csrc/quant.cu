// The passes around the int8 GEMM (csrc/int8_gemm.cu) that make the JAX
// package's int8 quantization (spotter_tpu/utils/quant.py) on Hopper: the
// TPU's XLA quantizes and dequantizes inside its s8 convolution and dot;
// PyTorch has no int8 convolution or batched int8 matmul on CUDA, so the
// port quantizes into the GEMM's K-major operands here and dequantizes its
// int32 product after it.
//
// 1. amax_s8: max |x| over each group (a sample, a (sample, head) pair, or
//    a weight's output channel): a memset of the group words, then one
//    kernel whose blocks each reduce a chunk of one group and fold it in
//    with atomicMax on the float's bits (valid: |x| >= 0, and max is
//    order-free, so the result is exact in any order).
//
// 2. quantize_s8, from the amax words of 1: scale = max(amax, 1e-12) / 127 and code =
//    clip(rint(x / scale), -127, 127), in fp32 with an IEEE division (this
//    file is built without --use_fast_math, so `/` is div.rn.f32) and
//    round-half-even (rintf), as jnp.round and jnp's `/` compute it. Each
//    thread writes 16 codes (one 16-byte store) of an output row (im2col:
//    a warp's lanes take 32 consecutive rows, so its reads coalesce); rows are
//    padded with zero codes to a multiple of 16 (TMA's row pitch), which
//    leaves every int32 sum unchanged. Three output layouts:
//      rows:     a (d0, d1, d2, d3) view -> (d0*d1*d2, K_pad), K = d3: dense
//                activations and weights, and the attention weights;
//      heads:    x (B, T, H, hd) -> (B*H, T, hd_pad): Q and K for QKᵀ;
//      heads_t:  x (B, T, H, hd) -> (B*H, hd, T_pad): V transposed, so that
//                attn·V's B operand arrives K-major;
//      im2col:   NCHW x -> (B*Ho*Wo, K_pad), K = C*kh*kw in (c, ky, kx)
//                order (the OIHW weight's own), zero padding and stride.
//    The inputs are read through their strides, fp32 or bf16.
//
// 3. dequant_s32: y (int32) -> float(y) * (sa * sb), the scale product formed
//    first (__int2float_rn, then an fp32 product), cast to the output dtype
//    (rounded to nearest even for bf16):
//      rows:  y (M, N) -> (M, N), sa[m / rows_per_group], sb[n]: dense;
//      heads: y (G, M, N) -> (G, M, N) (QKᵀ, fp32), or with H > 0 ->
//             (B, M, H, N), g = b*H + h (attn·V), sa[g] * sb[g];
//      nchw:  y (B*HW, N) -> (B, N, HW), sa[b] * sb[n], through a 32 x 32
//             tile in shared memory so that both the int32 reads and the
//             NCHW writes are coalesced: the convolution's output arrives in
//             the layout the float path gives the frozen BN that follows.
//
// What bounds them on an H100: bytes. The largest at RT-DETRv2-R101, B = 8,
// is layer 1's 3x3 conv at 160x160x64: 26 MB of bf16 input read (each
// element by 9 threads, the repeats from L1/L2) and a 118 MB im2col written;
// its dequant reads 52 MB of int32 and writes 26 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A 4-D strided input seen as groups: group g = i0 * heads + i_head, where
// the head axis (1 or 2) is `head_axis`, or every i0 is one group when
// head_axis is 0. The group's elements run over the other axes in order.
struct View {
  long long n[4];  // sizes
  long long s[4];  // strides in elements
  int head_axis;   // 0: one group a sample
};

__device__ __forceinline__ int heads_of(const View& v) {
  return v.head_axis ? static_cast<int>(v.n[v.head_axis]) : 1;
}

__device__ __forceinline__ long long group_size(const View& v) {
  return v.n[0] * v.n[1] * v.n[2] * v.n[3] / (v.n[0] * heads_of(v));
}

// The offset of the group's j-th element.
__device__ __forceinline__ long long group_offset(const View& v, int g, long long j) {
  const int heads = heads_of(v);
  long long off = static_cast<long long>(g / heads) * v.s[0];
  if (v.head_axis) off += static_cast<long long>(g % heads) * v.s[v.head_axis];
  for (int a = 3; a >= 1; --a) {
    if (a == v.head_axis) continue;
    off += (j % v.n[a]) * v.s[a];
    j /= v.n[a];
  }
  return off;
}

constexpr int kThreads = 256;

// amax over one chunk of group blockIdx.y, folded into amax_bits[g] (zeroed
// by the caller) with atomicMax on the float's bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, View v, unsigned* __restrict__ amax_bits) {
  const int g = blockIdx.y;
  const long long size = group_size(v);
  float m = 0.f;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; j < size;
       j += static_cast<long long>(gridDim.x) * kThreads) {
    m = fmaxf(m, fabsf(to_float(x[group_offset(v, g, j)])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) b = fmaxf(b, warp_max[w]);
    atomicMax(amax_bits + g, __float_as_uint(b));
  }
}

// The same fold where each group's elements are one contiguous run (a
// contiguous sample, or a weight's row): no index arithmetic an element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_contiguous_kernel(const T* __restrict__ x, long long group_stride, long long size,
                       unsigned* __restrict__ amax_bits) {
  const int g = blockIdx.y;
  const T* xg = x + g * group_stride;
  float m = 0.f;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; j < size;
       j += static_cast<long long>(gridDim.x) * kThreads) {
    m = fmaxf(m, fabsf(to_float(xg[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) b = fmaxf(b, warp_max[w]);
    atomicMax(amax_bits + g, __float_as_uint(b));
  }
}

__device__ __forceinline__ float scale_from(unsigned bits) {
  return fmaxf(__uint_as_float(bits), 1e-12f) / 127.0f;
}

__device__ __forceinline__ uint32_t code_of(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
}

// Threads with a global id below the group count write the groups' scales.
__device__ __forceinline__ void write_scales(const unsigned* amax_bits, float* scales,
                                             int groups) {
  const long long id = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (id < groups) scales[id] = scale_from(amax_bits[id]);
}

enum Layout { kRows = 0, kHeads = 1, kHeadsT = 2 };

// Codes of the (rows, cols_pad) output of `layout`, 16 a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, View v, int layout, long long rows, int cols,
                int cols_pad, const unsigned* __restrict__ amax_bits, int groups,
                int8_t* __restrict__ out, float* __restrict__ scales) {
  write_scales(amax_bits, scales, groups);
  const int chunks = cols_pad / 16;
  const long long total = rows * chunks;
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = t / chunks;
    const int c0 = static_cast<int>(t % chunks) * 16;
    // the row's input coordinates (i0, i1, i2, i3) but for the column's axis
    long long i[4] = {0, 0, 0, 0};
    int col_axis, g;
    if (layout == kRows) {  // r = flat (i0, i1, i2), column = i3
      long long q = r;
      i[2] = q % v.n[2];
      q /= v.n[2];
      i[1] = q % v.n[1];
      i[0] = q / v.n[1];
      col_axis = 3;
      g = static_cast<int>(v.head_axis ? i[0] * v.n[v.head_axis] + i[v.head_axis] : i[0]);
    } else if (layout == kHeads) {  // r = (b*H + h)*T + t, column = d
      i[1] = r % v.n[1];
      g = static_cast<int>(r / v.n[1]);
      col_axis = 3;
    } else {  // r = (b*H + h)*hd + d, column = t
      i[3] = r % v.n[3];
      g = static_cast<int>(r / v.n[3]);
      col_axis = 1;
    }
    if (layout != kRows) {
      i[0] = g / v.n[2];
      i[2] = g % v.n[2];
    }
    const float scale = scale_from(amax_bits[g]);
    const long long base = i[0] * v.s[0] + i[1] * v.s[1] + i[2] * v.s[2] + i[3] * v.s[3];
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * q + e;
        if (c < cols) {
          const float xv = to_float(x[base + c * v.s[col_axis]]);
          packed |= code_of(xv, scale) << (8 * e);
        }
      }
      w[q] = packed;
    }
    *reinterpret_cast<uint4*>(out + r * cols_pad + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// im2col codes: row r = (b, ho, wo), column c = (ci, ky, kx), 16 a thread.
// A block is 32 rows by 8 chunks of 16 columns: the lanes of a warp take 32
// consecutive rows (output pixels) of one chunk, so each of a thread's 16
// reads is one coalesced warp read along the input row (the pixels' x), and
// the block writes 32 rows x 128 contiguous bytes.
constexpr int kIm2colRows = 32;
constexpr int kIm2colChunks = kThreads / kIm2colRows;

template <typename T>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const T* __restrict__ x, View v, int ks, int stride, int pad, int ho_n, int wo_n,
              int k_pad, const unsigned* __restrict__ amax_bits, int8_t* __restrict__ out,
              float* __restrict__ scales) {
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < v.n[0]; i += kThreads) scales[i] = scale_from(amax_bits[i]);
  }
  const int h = static_cast<int>(v.n[2]);
  const int w = static_cast<int>(v.n[3]);
  const int k = static_cast<int>(v.n[1]) * ks * ks;
  const long long hw = static_cast<long long>(ho_n) * wo_n;
  const long long r = static_cast<long long>(blockIdx.x) * kIm2colRows + threadIdx.x % 32;
  const int chunk = blockIdx.y * kIm2colChunks + threadIdx.x / 32;
  if (r >= v.n[0] * hw || chunk * 16 >= k_pad) return;
  const int c0 = chunk * 16;
  const int b = static_cast<int>(r / hw);
  const int p = static_cast<int>(r % hw);
  const int y0 = (p / wo_n) * stride - pad;
  const int x0 = (p % wo_n) * stride - pad;
  const float scale = scale_from(amax_bits[b]);
  const T* xb = x + b * v.s[0];
  int ci = c0 / (ks * ks);
  int ky = (c0 / ks) % ks;
  int kx = c0 % ks;
  uint32_t words[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 4 * q + e;
      const int yy = y0 + ky;
      const int xx = x0 + kx;
      if (c < k && yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float xv = to_float(xb[ci * v.s[1] + yy * v.s[2] + xx * v.s[3]]);
        packed |= code_of(xv, scale) << (8 * e);
      }
      if (++kx == ks) {
        kx = 0;
        if (++ky == ks) {
          ky = 0;
          ++ci;
        }
      }
    }
    words[q] = packed;
  }
  *reinterpret_cast<uint4*>(out + r * k_pad + c0) =
      make_uint4(words[0], words[1], words[2], words[3]);
}

// ---- dequant -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_rows_kernel(const int32_t* __restrict__ y, const float* __restrict__ sa,
                    const float* __restrict__ sb, long long m, int n, long long rows_per_group,
                    T* __restrict__ out) {
  const long long total = m * n;
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = t / n;
    const float s = sa[row / rows_per_group] * sb[t % n];
    out[t] = from_float<T>(__int2float_rn(y[t]) * s);
  }
}

// y (G, M, N) -> out (G, M, N) when heads == 0, else (G / heads, M, heads, N)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_heads_kernel(const int32_t* __restrict__ y, const float* __restrict__ sa,
                     const float* __restrict__ sb, int groups, long long m, int n, int heads,
                     T* __restrict__ out) {
  const long long per_group = m * n;
  const long long total = per_group * groups;
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    const int g = static_cast<int>(t / per_group);
    const float v = __int2float_rn(y[t]) * (sa[g] * sb[g]);
    long long o = t;
    if (heads) {
      const long long within = t % per_group;
      const long long row = within / n;
      o = ((static_cast<long long>(g / heads) * m + row) * heads + g % heads) * n + within % n;
    }
    out[o] = from_float<T>(v);
  }
}

constexpr int kTile = 32;

// y (B*HW, N) -> out (B, N, HW): block (32, 8) over a 32 (hw) x 32 (n) tile
template <typename T>
__global__ void __launch_bounds__(kTile * 8)
dequant_nchw_kernel(const int32_t* __restrict__ y, const float* __restrict__ sa,
                    const float* __restrict__ sb, int n, long long hw, T* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int b = blockIdx.z;
  const long long p0 = static_cast<long long>(blockIdx.y) * kTile;
  const int n0 = blockIdx.x * kTile;
  const int col = n0 + threadIdx.x;
  const float sx = sa[b];
  const float s = col < n ? sx * sb[col] : 0.f;
#pragma unroll
  for (int r = threadIdx.y; r < kTile; r += 8) {
    const long long p = p0 + r;
    if (p < hw && col < n) {
      tile[r][threadIdx.x] = __int2float_rn(y[(b * hw + p) * n + col]) * s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = threadIdx.y; r < kTile; r += 8) {
    const int c = n0 + r;
    const long long p = p0 + threadIdx.x;
    if (c < n && p < hw) {
      out[(static_cast<long long>(b) * n + c) * hw + p] = from_float<T>(tile[threadIdx.x][r]);
    }
  }
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > 65536 ? 65536 : b));
}

View make_view(const long long* sizes, const long long* strides, int head_axis) {
  View v;
  for (int a = 0; a < 4; ++a) {
    v.n[a] = sizes[a];
    v.s[a] = strides[a];
  }
  v.head_axis = head_axis;
  return v;
}

bool valid_view(const View& v) {
  for (int a = 0; a < 4; ++a) {
    if (v.n[a] < 1) return false;
  }
  return v.head_axis == 0 || v.head_axis == 1 || v.head_axis == 2;
}

int groups_of(const View& v) {
  const long long groups = v.n[0] * (v.head_axis ? v.n[v.head_axis] : 1);
  return groups > 65535 ? -1 : static_cast<int>(groups);
}

// memset the amax words, then the amax pass over the view
template <typename T>
int amax_pass(const void* x_, const long long* sizes, const long long* strides, int head_axis,
              void* amax_words, cudaStream_t stream) {
  const View v = make_view(sizes, strides, head_axis);
  if (!valid_view(v) || groups_of(v) < 1) return cudaErrorInvalidValue;
  const int groups = groups_of(v);
  const T* x = static_cast<const T*>(x_);
  unsigned* amax_bits = static_cast<unsigned*>(amax_words);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned) * groups, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = v.n[0] * v.n[1] * v.n[2] * v.n[3] / groups;
  long long chunks = (size + kThreads * 16 - 1) / (kThreads * 16);
  const long long cap = groups >= 2048 ? 1 : 2048 / groups;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  const dim3 grid(static_cast<unsigned>(chunks), groups);
  const bool contiguous = v.head_axis == 0 && v.s[3] == 1 && v.s[2] == v.n[3] &&
                          v.s[1] == v.n[2] * v.n[3];
  if (contiguous) {
    amax_contiguous_kernel<T><<<grid, kThreads, 0, stream>>>(x, v.s[0], size, amax_bits);
  } else {
    amax_kernel<T><<<grid, kThreads, 0, stream>>>(x, v, amax_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int quantize(const void* x, const long long* sizes, const long long* strides, int head_axis,
             int layout, int cols_pad, const void* amax_bits, void* codes, void* scales,
             cudaStream_t stream) {
  const View v = make_view(sizes, strides, head_axis);
  if (!valid_view(v) || cols_pad % 16 || cols_pad <= 0) return cudaErrorInvalidValue;
  if (layout != kRows && head_axis != 2) return cudaErrorInvalidValue;
  const int groups = groups_of(v);
  if (groups < 1) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const unsigned* bits = static_cast<const unsigned*>(amax_bits);
  long long rows;
  int cols;
  if (layout == kRows) {
    rows = v.n[0] * v.n[1] * v.n[2];
    cols = static_cast<int>(v.n[3]);
  } else if (layout == kHeads) {
    rows = static_cast<long long>(groups) * v.n[1];
    cols = static_cast<int>(v.n[3]);
  } else {
    rows = static_cast<long long>(groups) * v.n[3];
    cols = static_cast<int>(v.n[1]);
  }
  if (cols > cols_pad) return cudaErrorInvalidValue;
  const long long work = rows * (cols_pad / 16);
  quantize_kernel<T><<<blocks_for(work > groups ? work : groups), kThreads, 0, stream>>>(
      xt, v, layout, rows, cols, cols_pad, bits, groups, static_cast<int8_t*>(codes),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int im2col(const void* x, const long long* sizes, const long long* strides, int ks, int stride,
           int pad, int k_pad, const void* amax_bits, void* codes, void* scales,
           cudaStream_t stream) {
  const View v = make_view(sizes, strides, 0);
  if (!valid_view(v) || ks < 1 || stride < 1 || pad < 0 || k_pad % 16 ||
      k_pad < v.n[1] * ks * ks || v.n[0] > 65535) {
    return cudaErrorInvalidValue;
  }
  const int ho = static_cast<int>((v.n[2] + 2 * pad - ks) / stride + 1);
  const int wo = static_cast<int>((v.n[3] + 2 * pad - ks) / stride + 1);
  if (ho < 1 || wo < 1) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const unsigned* bits = static_cast<const unsigned*>(amax_bits);
  const long long rows = v.n[0] * ho * wo;
  const long long row_blocks = (rows + kIm2colRows - 1) / kIm2colRows;
  const int chunk_blocks = (k_pad / 16 + kIm2colChunks - 1) / kIm2colChunks;
  if (row_blocks > 0x7fffffffLL || chunk_blocks > 65535) return cudaErrorInvalidValue;
  im2col_kernel<T><<<dim3(static_cast<unsigned>(row_blocks), chunk_blocks), kThreads, 0,
                     stream>>>(
      xt, v, ks, stride, pad, ho, wo, k_pad, bits, static_cast<int8_t*>(codes),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Inputs are read through their
// strides (in elements); outputs are contiguous. `amax_bits` holds one
// 32-bit word a group: amax_s8 writes each group's amax there (an fp32's
// bits), the quantize entries read it. The stream is the caller's current
// CUDA stream. Each returns the error of its launches (0 on success);
// nothing synchronises or allocates.

#define QUANT_ENTRIES(SUFFIX, T)                                                            \
  extern "C" int amax_s8_##SUFFIX(const void* x, const long long* sizes,                   \
                                  const long long* strides, int head_axis, void* amax_bits, \
                                  void* stream) {                                           \
    return amax_pass<T>(x, sizes, strides, head_axis, amax_bits,                            \
                        static_cast<cudaStream_t>(stream));                                 \
  }                                                                                         \
  extern "C" int quantize_s8_##SUFFIX(const void* x, const long long* sizes,               \
                                      const long long* strides, int head_axis, int layout,  \
                                      int cols_pad, void* amax_bits, void* codes,           \
                                      void* scales, void* stream) {                         \
    return quantize<T>(x, sizes, strides, head_axis, layout, cols_pad, amax_bits, codes,    \
                       scales, static_cast<cudaStream_t>(stream));                          \
  }                                                                                         \
  extern "C" int quantize_im2col_s8_##SUFFIX(const void* x, const long long* sizes,        \
                                             const long long* strides, int ks, int stride,  \
                                             int pad, int k_pad, void* amax_bits,           \
                                             void* codes, void* scales, void* stream) {     \
    return im2col<T>(x, sizes, strides, ks, stride, pad, k_pad, amax_bits, codes, scales,   \
                     static_cast<cudaStream_t>(stream));                                    \
  }                                                                                         \
  extern "C" int dequant_rows_##SUFFIX(const void* y, const void* sa, const void* sb,      \
                                       long long m, int n, long long rows_per_group,        \
                                       void* out, void* stream) {                           \
    if (m < 1 || n < 1 || rows_per_group < 1) return cudaErrorInvalidValue;                 \
    dequant_rows_kernel<T><<<blocks_for(m * n), kThreads, 0,                                \
                             static_cast<cudaStream_t>(stream)>>>(                          \
        static_cast<const int32_t*>(y), static_cast<const float*>(sa),                      \
        static_cast<const float*>(sb), m, n, rows_per_group, static_cast<T*>(out));         \
    return static_cast<int>(cudaGetLastError());                                            \
  }                                                                                         \
  extern "C" int dequant_heads_##SUFFIX(const void* y, const void* sa, const void* sb,     \
                                        int groups, long long m, int n, int heads,          \
                                        void* out, void* stream) {                          \
    if (groups < 1 || m < 1 || n < 1 || heads < 0 || (heads && groups % heads)) {           \
      return cudaErrorInvalidValue;                                                         \
    }                                                                                       \
    dequant_heads_kernel<T><<<blocks_for(groups * m * n), kThreads, 0,                      \
                              static_cast<cudaStream_t>(stream)>>>(                         \
        static_cast<const int32_t*>(y), static_cast<const float*>(sa),                      \
        static_cast<const float*>(sb), groups, m, n, heads, static_cast<T*>(out));          \
    return static_cast<int>(cudaGetLastError());                                            \
  }                                                                                         \
  extern "C" int dequant_nchw_##SUFFIX(const void* y, const void* sa, const void* sb,      \
                                       int batch, int n, long long hw, void* out,           \
                                       void* stream) {                                      \
    if (batch < 1 || batch > 65535 || n < 1 || hw < 1 || (hw + kTile - 1) / kTile > 65535) { \
      return cudaErrorInvalidValue;                                                         \
    }                                                                                       \
    const dim3 grid((n + kTile - 1) / kTile, static_cast<unsigned>((hw + kTile - 1) / kTile), \
                    batch);                                                                 \
    dequant_nchw_kernel<T><<<grid, dim3(kTile, 8), 0, static_cast<cudaStream_t>(stream)>>>( \
        static_cast<const int32_t*>(y), static_cast<const float*>(sa),                      \
        static_cast<const float*>(sb), n, hw, static_cast<T*>(out));                        \
    return static_cast<int>(cudaGetLastError());                                            \
  }

QUANT_ENTRIES(f32, float)
QUANT_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
