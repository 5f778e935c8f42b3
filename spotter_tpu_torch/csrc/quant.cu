// The passes around the int8 products (csrc/int8_conv.cu, csrc/int8_gemm.cu)
// that make the JAX package's int8 quantization (spotter_tpu/utils/quant.py)
// on Hopper: the TPU's XLA quantizes and dequantizes inside its s8
// convolution and dot; PyTorch has no int8 convolution or batched int8
// matmul on CUDA, so the port quantizes into the products' operands here
// and dequantizes the GEMM's int32 product after it.
//
// 1. amax_s8 (replaces the amax of spotter_tpu/utils/quant.py:136): max |x|
//    over each group (a sample, a (sample, head) pair, or a weight's output
//    channel) as `parts` partial maxima a group, (groups, parts) fp32: block
//    (j, g) reduces the j-th share of group g and writes its own word. One
//    launch, no atomics and no zeroed words, so nothing is memset before it
//    and no state outlives a call (CUDA graphs and two forwards in flight
//    see only their own buffers). Bound by bytes: a group that fills one
//    run of memory (the fast path: a sample in either layout, a weight's
//    row) is read with 16-byte streaming loads, four in flight a thread,
//    over a grid the wrapper sizes to fill the card; a strided view (the
//    two-launch heads path) is read an element at a time through its
//    strides. Max is order-free, so the amax is exact.
//
// 2. quantize_s8 and quantize_nhwc_s8 (replace quantize_activation /
//    quantize_per_head, quant.py:124), from the partials of 1: amax = max of
//    the group's partials, scale = max(amax, 1e-12) / 127 and code =
//    clip(rint(x / scale), -127, 127), in fp32 as an IEEE division (this
//    file is built without --use_fast_math, so `/` is div.rn.f32) and
//    round-half-even (rintf) give it, as jnp.round and jnp's `/` compute it
//    (`code_of`: a product by the reciprocal, the division only near a
//    half-integer). Rows
//    are padded with zero codes to a multiple of 16 (TMA's row pitch), which
//    leaves every int32 sum unchanged. Output layouts:
//      rows:     a (d0, d1, d2, d3) view -> (d0*d1*d2, K_pad), K = d3: dense
//                activations and weights, and the attention weights;
//      heads:    x (B, T, H, hd) -> (B*H, T, hd_pad): Q and K for QKᵀ;
//      heads_t:  x (B, T, H, hd) -> (B*H, hd, T_pad): V transposed, so that
//                attn·V's B operand arrives K-major;
//      nhwc:     NCHW x -> (B, H, W, C_pad): the convolution's codes, which
//                conv_s8 gathers in place.
//    All are bound by bytes: each value is read once and written as one
//    byte. Three kernels serve them:
//    - the rows kernel (rows and heads, and an nhwc whose channels are
//      contiguous, channels-last, or whose pixels are at no one stride):
//      16-byte loads where each output row is one aligned run of the
//      input, two 16-code chunks in flight a thread, 32-bit index
//      arithmetic, the block's groups' scales reduced once into shared
//      memory;
//    - the transpose kernel (nhwc from NCHW, where each channel's H*W plane
//      is one run; heads_t, where each token's hd values are): a streaming
//      transpose through a 64-byte-wide shared-memory tile tiled over the
//      run, loads along it, codes out as 16-byte rows (its comment below);
//    - the one-launch heads kernel (heads and heads_t where a (sample,
//      head) group fits a block's shared memory, ops/int8.py
//      `heads_one_launch`): the group read once into shared memory, its
//      amax, scale and codes from there, with no amax launch before it.
//    Any strides are taken: the rows and transpose kernels read a value at
//    a time through the view's strides where 16-byte loads do not fit.
//
// 3. dequant_s32: y (int32) -> float(y) * (sa * sb), the scale product formed
//    first (__int2float_rn, then an fp32 product), cast to the output dtype
//    (rounded to nearest even for bf16):
//      rows:  y (M, N) -> (M, N), sa[m / rows_per_group], sb[n]: dense;
//      heads: y (G, M, N) -> (G, M, N) (QKᵀ, fp32), or with H > 0 ->
//             (B, M, H, N), g = b*H + h (attn·V), sa[g] * sb[g].
//    (A convolution dequantizes in conv_s8's epilogue.)
//
// The largest at RT-DETRv2-R101, B = 8: the nhwc pass of layer 1's 3x3
// conv reads 26 MB of bf16 at 160x160x64 and writes 13 MB of codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The block's max of one value a thread, written by thread 0 to *dst.
__device__ __forceinline__ void block_max_to(float m, float* dst) {
  __shared__ float per_warp[kWarps];
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) per_warp[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = per_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) b = fmaxf(b, per_warp[w]);
    *dst = b;
  }
}

// ---- amax_s8 ---------------------------------------------------------------------

// The general path: the j-th share of group blockIdx.y, read element by
// element through the view's strides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, View v, int parts, float* __restrict__ partials) {
  const int g = blockIdx.y;
  const long long size = group_size(v);
  const long long step = static_cast<long long>(parts) * kThreads;
  float m = 0.f;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; j < size;
       j += step) {
    m = fmaxf(m, fabsf(to_float(x[group_offset(v, g, j)])));
  }
  block_max_to(m, partials + static_cast<long long>(g) * parts + blockIdx.x);
}

// 16 bytes that this kernel alone reads, once: not kept in L1, and the L2
// asked to fetch the 256-byte block around them
__device__ __forceinline__ uint4 load16_streaming(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// max |x| of the values packed in 16 bytes
__device__ __forceinline__ float absmax16(uint4 r, float) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(r.x)), fabsf(__uint_as_float(r.y))),
               fmaxf(fabsf(__uint_as_float(r.z)), fabsf(__uint_as_float(r.w))));
}
__device__ __forceinline__ float absmax_bf16x2(uint32_t w) {
  // a bf16 is the high half of the fp32 of the same value
  return fmaxf(fabsf(__uint_as_float(w << 16)), fabsf(__uint_as_float(w & 0xffff0000u)));
}
__device__ __forceinline__ float absmax16(uint4 r, __nv_bfloat16) {
  return fmaxf(fmaxf(absmax_bf16x2(r.x), absmax_bf16x2(r.y)),
               fmaxf(absmax_bf16x2(r.z), absmax_bf16x2(r.w)));
}

// The fast path: each group one contiguous run of memory (a contiguous or
// channels-last sample, a weight's row), its values in any order. Its
// 16-byte-aligned body is read in 16-byte loads, kUnroll in flight a
// thread, blocks interleaved along it; block 0 also takes the few values
// before the first 16-byte boundary and after the last.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_contiguous_kernel(const T* __restrict__ x, long long group_stride, long long size,
                       int parts, float* __restrict__ partials) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kUnroll = 4;
  const int g = blockIdx.y;
  const T* xg = x + g * group_stride;
  const long long lead = (16 - (reinterpret_cast<uintptr_t>(xg) & 15)) % 16 / sizeof(T);
  const long long head = lead < size ? lead : size;
  const long long vecs = (size - head) / kVec;
  const long long tail = head + vecs * kVec;
  const uint4* body = reinterpret_cast<const uint4*>(xg + head);
  float m = 0.f;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) m = fabsf(to_float(xg[threadIdx.x]));
    if (tail + threadIdx.x < size) m = fmaxf(m, fabsf(to_float(xg[tail + threadIdx.x])));
  }
  const long long step = static_cast<long long>(parts) * kThreads;
  long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  for (; i + (kUnroll - 1) * step < vecs; i += kUnroll * step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = load16_streaming(body + i + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, absmax16(r[u], T()));
  }
  for (; i < vecs; i += step) m = fmaxf(m, absmax16(load16_streaming(body + i), T()));
  block_max_to(m, partials + static_cast<long long>(g) * parts + blockIdx.x);
}

// ---- quantize_s8 and quantize_nhwc_s8 ----------------------------------------------

__device__ __forceinline__ float scale_from(float amax) {
  return fmaxf(amax, 1e-12f) / 127.0f;
}

// A group's scale and its reciprocal (rounded to nearest: the scale is at
// least 1e-12 / 127, so it is finite).
struct Scale {
  float s, inv;
};

__device__ __forceinline__ Scale scale_of_amax(float amax) {
  const float s = scale_from(amax);
  return {s, __frcp_rn(s)};
}

// clip(rint(x / s), -127, 127) exactly as div.rn.f32 and rintf give it,
// mostly without the division. q = x * inv lies within |x / s| * 1.6e-7 of
// the true quotient, and div.rn within |x / s| * 6e-8, so below |q| = 128
// the two are within 2.3e-5 of each other: where q is further than 2^-10
// from a half-integer both round to rint(q); nearer (and for NaN) the IEEE
// division decides; from |q| = 128 up both clip. The card's tests hold it
// against the plain version at every bf16 value and around every k + 0.5.
__device__ __forceinline__ uint32_t code_of(float x, Scale scale) {
  const float q = __fmul_rn(x, scale.inv);
  float r;
  if (fabsf(q) >= 128.0f) {
    r = copysignf(127.0f, q);
  } else {
    r = rintf(q);
    if (!(fabsf(fabsf(q - r) - 0.5f) > 0x1p-10f)) r = rintf(x / scale.s);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
  }
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
}

// Group g's amax from its partials: by one thread, or by one warp (every
// lane gets it).
__device__ __forceinline__ float group_amax(const float* partials, int parts, int g) {
  const float* p = partials + static_cast<long long>(g) * parts;
  float m = 0.f;
  for (int j = 0; j < parts; ++j) m = fmaxf(m, p[j]);
  return m;
}
__device__ __forceinline__ float warp_group_amax(const float* partials, int parts, int g) {
  const float* p = partials + static_cast<long long>(g) * parts;
  float m = 0.f;
  for (int j = threadIdx.x % 32; j < parts; j += 32) m = fmaxf(m, p[j]);
  return warp_max(m);
}

// The e-th value packed in 16 bytes (fp32: 4 a chunk, bf16: 8), as fp32.
__device__ __forceinline__ float value_at(uint4 r, int e, float) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  return __uint_as_float(w[e]);
}
__device__ __forceinline__ float value_at(uint4 r, int e, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  const uint32_t word = w[e / 2];
  return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Up to 16 bytes of values p[0], p[stride], ... (n of them, n <= 16 /
// sizeof(T)) packed as a 16-byte chunk would hold them, zeros past n.
template <typename T>
__device__ __forceinline__ uint4 load_values(const T* p, long long stride, int n) {
  constexpr int kVe = 16 / sizeof(T);
  constexpr int kBits = 8 * sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kVe; ++e) {
    if (e < n) w[e * kBits / 32] |= bits_of(p[e * stride]) << (e * kBits % 32);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

enum Layout { kRows = 0, kHeads = 1, kHeadsT = 2 };
// The kernel that served a quantize call, written to *path: the rows or the
// transpose kernel, each with 16-byte loads or a value at a time, or the
// one-launch heads kernel.
enum QuantPath { kPathRows = 0, kPathRowsScalar = 1, kPathTranspose = 2, kPathTransposeScalar = 3,
                 kPathGroup = 4 };

// ---- the rows kernel --------------------------------------------------------------

// Row r = (i0, i1, i2) (i2 fastest, i0 up to rows / (n1 * n2)) starts at
// i0*a0 + i1*a1 + i2*a2 and holds `cols` values `cs` apart; group r /
// rows_per_group.
struct RowView {
  unsigned n1, n2;
  long long a0, a1, a2, cs;
  int cols, rows_per_group;
};

constexpr int kRowsUnroll = 2;                   // 16-code chunks a thread
constexpr int kRowsItems = kThreads * kRowsUnroll;  // chunks a block
constexpr int kBlockGroups = 64;                 // groups a block reduces once, in shared memory

// Block b takes chunks [b * kRowsItems, +kRowsItems) of the (rows,
// cols_pad / 16) output in row order, kRowsUnroll a thread, each 16 values
// read in 16-byte loads where the columns are contiguous and every row
// starts 16-byte aligned (kVec: 4 in fp32, 2 in bf16; a ragged row end a
// value at a time, zeros past cols), else a value at a time through the
// column stride (any view), all in flight before the first is used. Index
// arithmetic is 32-bit (the host keeps rows * chunks below 2^31). The
// warps reduce the block's groups' scales once into shared memory, where
// they also write them out (a group spans blocks: each writes the same
// bits); past kBlockGroups groups a block (rows of fewer than 8 chunks,
// a scale a row) each thread reduces its own.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, RowView v, int total, int chunks,
                     const float* __restrict__ partials, int parts,
                     int8_t* __restrict__ out, float* __restrict__ scales) {
  constexpr int kVe = 16 / sizeof(T);
  constexpr int kLoads = 16 / kVe;
  const int first = blockIdx.x * kRowsItems;
  uint4 raw[kRowsUnroll][kLoads];
  int row[kRowsUnroll], col0[kRowsUnroll];
#pragma unroll
  for (int u = 0; u < kRowsUnroll; ++u) {
    const int i = first + u * kThreads + threadIdx.x;
    row[u] = i < total ? static_cast<int>(static_cast<unsigned>(i) / chunks) : -1;
    const unsigned r = row[u] < 0 ? 0u : static_cast<unsigned>(row[u]);
    col0[u] = (i - static_cast<int>(r) * chunks) * 16;
    const unsigned q = r / v.n2;
    const T* p = x + static_cast<long long>(q / v.n1) * v.a0 + (q % v.n1) * v.a1 +
                 (r % v.n2) * v.a2 + col0[u] * v.cs;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int left = v.cols - col0[u] - l * kVe;  // values of this load inside the row
      raw[u][l] = row[u] < 0 || left <= 0 ? make_uint4(0u, 0u, 0u, 0u)
                  : kVec && left >= kVe  ? load16_streaming(reinterpret_cast<const uint4*>(p) + l)
                                         : load_values(p + l * kVe * v.cs, v.cs, left);
    }
  }
  __shared__ Scale block_scale[kBlockGroups];
  const int last = (first + kRowsItems < total ? first + kRowsItems : total) - 1;
  const int g0 = first / chunks / v.rows_per_group;
  const int ng = last / chunks / v.rows_per_group - g0 + 1;
  const bool shared_table = ng <= kBlockGroups;
  if (shared_table) {
    for (int gi = threadIdx.x / 32; gi < ng; gi += kWarps) {
      const Scale s = scale_of_amax(warp_group_amax(partials, parts, g0 + gi));
      if (threadIdx.x % 32 == 0) {
        block_scale[gi] = s;
        scales[g0 + gi] = s.s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kRowsUnroll; ++u) {
    if (row[u] < 0) continue;
    const int g = row[u] / v.rows_per_group;
    Scale scale;
    if (shared_table) {
      scale = block_scale[g - g0];
    } else {
      scale = scale_of_amax(group_amax(partials, parts, g));
      if (col0[u] == 0) scales[g] = scale.s;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      w[e / 4] |= code_of(value_at(raw[u][e / kVe], e % kVe, T()), scale) << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row[u]) * (chunks * 16) + col0[u]) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- the transpose kernel -----------------------------------------------------------

// Per group g, R rows of L values: value (r, l) at (g / heads) * gs0 +
// (g % heads) * gs1 + r * rs + l * ls. The output is (L, r_pad) a group,
// value (r, l) at byte l * r_pad + r, zero for r in [R, r_pad).
struct TransposeView {
  int heads;
  long long gs0, gs1;
  int r_n, l_n;
  long long rs, ls;
};

constexpr int kTileR = 64;   // input rows (output bytes a row) a tile
constexpr int kTileSteps = 4;  // 16-byte loads in flight a thread

// A streaming transpose through shared memory. Block (l tile, r tile, g)
// takes kTileR input rows and kTileL = 4 * kVe * kTileSteps values of each
// (64 in fp32, 128 in bf16). A warp reads 8 rows, four lanes a row side by
// side (64 contiguous bytes), kTileSteps loads in flight a thread: 16-byte
// streaming loads where every row run is 16-byte aligned (kVec), else a
// value at a time through the strides. Each value is quantized once, in
// registers, and its code stored as byte [l][r] of a 64-byte row a value
// of l, the row's four 16-byte segments rotated by (l / kVe) % 4 so that
// the four lanes of a row, kVe values of l apart, store to other banks.
// Then each thread reads 16 bytes of an output row (8 lanes: two whole
// rows, all 32 banks) and stores them: a tile's row is 64 contiguous bytes
// of the output, and a tile that spans r_pad a contiguous run.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_transpose_kernel(const T* __restrict__ x, TransposeView v, int r_pad,
                          const float* __restrict__ partials, int parts,
                          int8_t* __restrict__ out, float* __restrict__ scales) {
  constexpr int kVe = 16 / sizeof(T);
  constexpr int kTileL = 4 * kVe * kTileSteps;
  __shared__ __align__(16) uint8_t tile[kTileL * kTileR];
  const int g = blockIdx.z;
  const int l0 = blockIdx.x * kTileL;
  const int r0 = blockIdx.y * kTileR;
  const int lane = threadIdx.x % 32;
  const int rr = threadIdx.x / 32 * 8 + lane / 4;  // the thread's row in the tile
  const int k = lane % 4;
  const int r = r0 + rr;
  const T* xr = x + static_cast<long long>(g / v.heads) * v.gs0 +
                static_cast<long long>(g % v.heads) * v.gs1 + static_cast<long long>(r) * v.rs;
  uint4 raw[kTileSteps];
#pragma unroll
  for (int u = 0; u < kTileSteps; ++u) {
    const int l = l0 + (4 * u + k) * kVe;
    const int left = v.l_n - l;
    if (r >= v.r_n || left <= 0) {
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
    } else if (kVec) {  // past L inside the chunk: never stored
      raw[u] = load16_streaming(reinterpret_cast<const uint4*>(xr + l));
    } else {
      raw[u] = load_values(xr + l * v.ls, v.ls, left);
    }
  }
  const Scale scale = scale_of_amax(warp_group_amax(partials, parts, g));
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scales[g] = scale.s;
  const int seg = rr / 16;
  const int byte = rr % 16;
#pragma unroll
  for (int u = 0; u < kTileSteps; ++u) {
    const int lc = (4 * u + k) * kVe;  // the chunk's first l in the tile
    uint8_t* dst = tile + lc * kTileR + ((seg ^ k) * 16) + byte;  // (lc / kVe) % 4 == k
#pragma unroll
    for (int e = 0; e < kVe; ++e) {
      dst[e * kTileR] = static_cast<uint8_t>(code_of(value_at(raw[u], e, T()), scale));
    }
  }
  __syncthreads();
  const int segs = (r_pad - r0 < kTileR ? r_pad - r0 : kTileR) / 16;
  const int l_end = v.l_n - l0 < kTileL ? v.l_n - l0 : kTileL;
  int8_t* og = out + static_cast<long long>(g) * v.l_n * r_pad + r0;
  for (int i = threadIdx.x; i < kTileL * 4; i += kThreads) {
    const int ll = i / 4;
    const int s = i % 4;
    if (ll >= l_end || s >= segs) continue;
    const uint4 val =
        *reinterpret_cast<const uint4*>(tile + ll * kTileR + ((s ^ ((ll / kVe) % 4)) * 16));
    *reinterpret_cast<uint4*>(og + static_cast<long long>(l0 + ll) * r_pad + 16 * s) = val;
  }
}

// ---- the one-launch heads kernel ----------------------------------------------------

// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Block g holds (sample, head) group g of x (B, T, H, hd) whole in shared
// memory, [t][d] in x's dtype: one read of the group (16-byte asynchronous
// copies, all in flight at once, where each row of hd values is whole
// 16-byte chunks, kAsync; else a value at a time, lanes along d), its amax
// from there, its scale, its codes: heads (T, hd_pad), a thread 16 codes
// of a row, or heads_t (hd, T_pad), lanes along d so that each of the 16
// reads a thread makes, 32 consecutive values of a row, is free of bank
// conflicts. No partials, no second launch.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
quantize_heads_group_kernel(const T* __restrict__ x, View v, int layout, int cols_pad,
                            int8_t* __restrict__ out, float* __restrict__ scales) {
  constexpr int kVe = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  T* vals = reinterpret_cast<T*>(smem);
  __shared__ float amax;
  const int g = blockIdx.x;
  const int heads = static_cast<int>(v.n[2]);
  const int t_n = static_cast<int>(v.n[1]);
  const int hd = static_cast<int>(v.n[3]);
  const int n = t_n * hd;
  const T* xg = x + static_cast<long long>(g / heads) * v.s[0] +
                static_cast<long long>(g % heads) * v.s[2];
  float m = 0.f;
  if constexpr (kAsync) {
    const int per_row = hd / kVe;
    for (int q = threadIdx.x; q < t_n * per_row; q += kThreads) {
      const int t = q / per_row;
      const int c = (q - t * per_row) * kVe;
      copy16_async(vals + t * hd + c, xg + t * v.s[1] + c);
    }
    copies_landed();
    __syncthreads();
    for (int q = threadIdx.x; q < n / kVe; q += kThreads) {
      m = fmaxf(m, absmax16(reinterpret_cast<const uint4*>(vals)[q], T()));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const T val = xg[t * v.s[1] + d * v.s[3]];
      vals[i] = val;
      m = fmaxf(m, fabsf(to_float(val)));
    }
  }
  block_max_to(m, &amax);  // its barrier also lands the scalar path's stores
  __syncthreads();
  const Scale scale = scale_of_amax(amax);
  if (threadIdx.x == 0) scales[g] = scale.s;
  const int chunks = cols_pad / 16;
  if (layout == kHeads) {
    int8_t* og = out + static_cast<long long>(g) * t_n * cols_pad;
    for (int i = threadIdx.x; i < t_n * chunks; i += kThreads) {
      const int t = i / chunks;
      const int c0 = (i - t * chunks) * 16;
      const T* src = vals + t * hd + c0;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (kAsync && c0 + 16 <= hd) {  // whole 16-byte reads of the row
#pragma unroll
        for (int l = 0; l < 16 / kVe; ++l) {
          const uint4 r = reinterpret_cast<const uint4*>(src)[l];
#pragma unroll
          for (int e = 0; e < kVe; ++e) {
            const int c = l * kVe + e;
            w[c / 4] |= code_of(value_at(r, e, T()), scale) << (8 * (c % 4));
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          if (c0 + c < hd) w[c / 4] |= code_of(to_float(src[c]), scale) << (8 * (c % 4));
        }
      }
      *reinterpret_cast<uint4*>(og + t * cols_pad + c0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    int8_t* og = out + static_cast<long long>(g) * hd * cols_pad;
    for (int i = threadIdx.x; i < hd * chunks; i += kThreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int t = j * 16 + c;
        if (t < t_n) w[c / 4] |= code_of(to_float(vals[t * hd + d]), scale) << (8 * (c % 4));
      }
      *reinterpret_cast<uint4*>(og + d * cols_pad + j * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
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

// each group's elements fill one contiguous run of memory, in any order
// (max is order-free: a channels-last sample qualifies): the strides of
// axes 1-3 longer than 1, in increasing order, are the running products of
// their sizes
bool groups_dense(const View& v) {
  if (v.head_axis) return false;
  int axes[3] = {1, 2, 3};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && v.s[axes[j]] < v.s[axes[j - 1]]; --j) {
      const int a = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = a;
    }
  }
  long long run = 1;
  for (int a : axes) {
    if (v.n[a] == 1) continue;
    if (v.s[a] != run) return false;
    run *= v.n[a];
  }
  return true;
}

// x 16-byte aligned, and the stride of every axis of v longer than 1 among
// `axes` a whole number of 16-byte units
template <typename T>
bool runs_aligned(const void* x, const View& v, std::initializer_list<int> axes) {
  if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  for (int a : axes) {
    if (v.n[a] > 1 && (v.s[a] * static_cast<long long>(sizeof(T))) % 16) return false;
  }
  return true;
}

// the amax pass: `parts` partial maxima a group into partials (groups, parts),
// by the contiguous kernel where the groups are dense (*path 1), else by the
// general one (*path 0)
template <typename T>
int amax_pass(const void* x_, const long long* sizes, const long long* strides, int head_axis,
              int parts, void* partials_, int* path, cudaStream_t stream) {
  const View v = make_view(sizes, strides, head_axis);
  const int groups = groups_of(v);
  if (!valid_view(v) || groups < 1 || parts < 1) return cudaErrorInvalidValue;
  const bool fast = groups_dense(v);
  const T* x = static_cast<const T*>(x_);
  float* partials = static_cast<float*>(partials_);
  const dim3 grid(static_cast<unsigned>(parts), groups);
  if (fast) {
    const long long size = v.n[1] * v.n[2] * v.n[3];
    amax_contiguous_kernel<T><<<grid, kThreads, 0, stream>>>(x, v.s[0], size, parts, partials);
  } else {
    amax_kernel<T><<<grid, kThreads, 0, stream>>>(x, v, parts, partials);
  }
  *path = fast;
  return static_cast<int>(cudaGetLastError());
}

// The rows kernel over `rv`, (rows, cols_pad) codes: with 16-byte loads
// where `vec`, else a value at a time.
template <typename T>
int launch_rows(const void* x, const RowView& rv, long long rows, int cols_pad, bool vec,
                const float* partials, int parts, void* codes, void* scales,
                cudaStream_t stream) {
  const int chunks = cols_pad / 16;
  const long long total = rows * chunks;
  if (total + kRowsItems > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((total + kRowsItems - 1) / kRowsItems);
  auto kernel = vec ? quantize_rows_kernel<T, true> : quantize_rows_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), rv, static_cast<int>(total), chunks, partials, parts,
      static_cast<int8_t*>(codes), static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// The transpose kernel over `tv`, `groups` groups of (L, r_pad) codes: with
// 16-byte loads where `vec`, else a value at a time.
template <typename T>
int launch_transpose(const void* x, const TransposeView& tv, int groups, int r_pad, bool vec,
                     const float* partials, int parts, void* codes, void* scales,
                     cudaStream_t stream) {
  constexpr int kTileL = 4 * (16 / sizeof(T)) * kTileSteps;
  const long long r_tiles = (r_pad + kTileR - 1) / kTileR;
  const long long l_tiles = (tv.l_n + kTileL - 1) / kTileL;
  if (groups > 65535 || r_tiles > 65535 || l_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(l_tiles), static_cast<unsigned>(r_tiles), groups);
  auto kernel = vec ? quantize_transpose_kernel<T, true> : quantize_transpose_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), tv, r_pad, partials, parts,
                                        static_cast<int8_t*>(codes),
                                        static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// The quantize pass of the rows, heads and heads_t layouts from the amax
// pass's partials: the rows kernel for rows and heads (16-byte loads where
// each row is one aligned run), the transpose kernel for heads_t (16-byte
// loads where each token's hd values are).
template <typename T>
int quantize(const void* x, const long long* sizes, const long long* strides, int head_axis,
             int layout, int cols_pad, const void* partials_, int parts, void* codes,
             void* scales, int* path, cudaStream_t stream) {
  const View v = make_view(sizes, strides, head_axis);
  if (!valid_view(v) || cols_pad % 16 || cols_pad <= 0 || parts < 1) return cudaErrorInvalidValue;
  if ((layout == kRows) != (head_axis == 0) || (layout != kRows && head_axis != 2)) {
    return cudaErrorInvalidValue;
  }
  const int groups = groups_of(v);
  if (groups < 1 || (layout == kHeadsT ? v.n[1] : v.n[3]) > cols_pad) return cudaErrorInvalidValue;
  const float* partials = static_cast<const float*>(partials_);
  const bool vec = (v.n[3] == 1 || v.s[3] == 1) && runs_aligned<T>(x, v, {0, 1, 2});
  if (layout == kHeadsT) {  // a group's T rows of hd values, transposed
    *path = vec ? kPathTranspose : kPathTransposeScalar;
    const TransposeView tv{static_cast<int>(v.n[2]), v.s[0], v.s[2], static_cast<int>(v.n[1]),
                           static_cast<int>(v.n[3]), v.s[1], v.s[3]};
    return launch_transpose<T>(x, tv, groups, cols_pad, vec, partials, parts, codes, scales,
                               stream);
  }
  *path = vec ? kPathRows : kPathRowsScalar;
  const int cols = static_cast<int>(v.n[3]);
  // rows: (d0, d1, d2), d2 fastest; heads: (b, h, t), t fastest
  const RowView rv =
      layout == kRows
          ? RowView{static_cast<unsigned>(v.n[1]), static_cast<unsigned>(v.n[2]), v.s[0], v.s[1],
                    v.s[2], v.s[3], cols, static_cast<int>(v.n[1] * v.n[2])}
          : RowView{static_cast<unsigned>(v.n[2]), static_cast<unsigned>(v.n[1]), v.s[0], v.s[2],
                    v.s[1], v.s[3], cols, static_cast<int>(v.n[1])};
  return launch_rows<T>(x, rv, v.n[0] * v.n[1] * v.n[2], cols_pad, vec, partials, parts, codes,
                        scales, stream);
}

// The NHWC codes (B, H, W, c_pad) of NCHW x from the amax pass's partials:
// the transpose kernel over each sample's C rows of H*W pixels where the
// pixels flatten to one stride and the channels are not contiguous
// (16-byte loads where the planes are 16-byte-aligned runs); otherwise the
// rows kernel over the (b, h, w) rows of C values (a channels-last input:
// no transpose, 16-byte loads where aligned).
template <typename T>
int quantize_nhwc(const void* x, const long long* sizes, const long long* strides, int c_pad,
                  const void* partials_, int parts, void* codes, void* scales, int* path,
                  cudaStream_t stream) {
  const View v = make_view(sizes, strides, 0);
  if (!valid_view(v) || c_pad % 16 || c_pad < v.n[1] || parts < 1 || v.n[0] > 65535 ||
      v.n[2] * v.n[3] > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int b = static_cast<int>(v.n[0]);
  const float* partials = static_cast<const float*>(partials_);
  const long long pixels = v.n[2] * v.n[3];
  const bool flat = v.n[2] == 1 || v.n[3] == 1 || v.s[2] == v.n[3] * v.s[3];
  if (v.s[1] != 1 && flat) {  // pixels at one stride
    const long long ls = v.n[3] == 1 ? v.s[2] : v.s[3];
    const bool vec = ls == 1 && runs_aligned<T>(x, v, {0, 1});
    *path = vec ? kPathTranspose : kPathTransposeScalar;
    const TransposeView tv{1, v.s[0], 0, static_cast<int>(v.n[1]), static_cast<int>(pixels),
                           v.s[1], ls};
    return launch_transpose<T>(x, tv, b, c_pad, vec, partials, parts, codes, scales, stream);
  }
  const bool vec = v.s[1] == 1 && runs_aligned<T>(x, v, {0, 2, 3});
  *path = vec ? kPathRows : kPathRowsScalar;
  const RowView rv{static_cast<unsigned>(v.n[2]), static_cast<unsigned>(v.n[3]), v.s[0], v.s[2],
                   v.s[3], v.s[1], static_cast<int>(v.n[1]), static_cast<int>(pixels)};
  return launch_rows<T>(x, rv, b * pixels, c_pad, vec, partials, parts, codes, scales, stream);
}

constexpr int kHeadsGroupMaxBytes = 96 * 1024;  // ops/int8.py HEADS_GROUP_MAX_BYTES

// The heads and heads_t layouts in one launch, where a (sample, head)
// group's T * hd values fit kHeadsGroupMaxBytes of shared memory.
template <typename T>
int quantize_heads_group(const void* x, const long long* sizes, const long long* strides,
                         int layout, int cols_pad, void* codes, void* scales,
                         cudaStream_t stream) {
  const View v = make_view(sizes, strides, 2);
  const int groups = groups_of(v);
  if (!valid_view(v) || groups < 1 || cols_pad % 16 || (layout != kHeads && layout != kHeadsT)) {
    return cudaErrorInvalidValue;
  }
  if ((layout == kHeads ? v.n[3] : v.n[1]) > cols_pad) return cudaErrorInvalidValue;
  const long long bytes = (v.n[1] * v.n[3] * static_cast<long long>(sizeof(T)) + 15) / 16 * 16;
  if (bytes > kHeadsGroupMaxBytes) return cudaErrorInvalidValue;
  const bool async = v.s[3] == 1 && (v.n[3] * sizeof(T)) % 16 == 0 &&
                     runs_aligned<T>(x, v, {0, 1, 2});
  auto kernel = async ? quantize_heads_group_kernel<T, true>
                      : quantize_heads_group_kernel<T, false>;
  // past 48 KB with the static words too: the opt-in limit, set every call
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHeadsGroupMaxBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<groups, kThreads, static_cast<size_t>(bytes), stream>>>(
      static_cast<const T*>(x), v, layout, cols_pad, static_cast<int8_t*>(codes),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Inputs are read through their
// strides (in elements); outputs are contiguous. `partials` holds `parts`
// fp32 words a group: amax_s8 writes each group's partial maxima there, the
// quantize entries reduce them. The amax and quantize entries write the
// path they took to *path (`amax_pass`, `QuantPath`). The stream is the
// caller's current CUDA stream. Each returns the error of its launches (0 on
// success); nothing synchronises or allocates.

#define QUANT_ENTRIES(SUFFIX, T)                                                            \
  extern "C" int amax_s8_##SUFFIX(const void* x, const long long* sizes,                   \
                                  const long long* strides, int head_axis, int parts,       \
                                  void* partials, int* path, void* stream) {                \
    return amax_pass<T>(x, sizes, strides, head_axis, parts, partials, path,                \
                        static_cast<cudaStream_t>(stream));                                 \
  }                                                                                         \
  extern "C" int quantize_s8_##SUFFIX(const void* x, const long long* sizes,               \
                                      const long long* strides, int head_axis, int layout,  \
                                      int cols_pad, void* partials, int parts, void* codes, \
                                      void* scales, int* path, void* stream) {              \
    return quantize<T>(x, sizes, strides, head_axis, layout, cols_pad, partials, parts,     \
                       codes, scales, path, static_cast<cudaStream_t>(stream));             \
  }                                                                                         \
  extern "C" int quantize_heads_s8_##SUFFIX(const void* x, const long long* sizes,         \
                                            const long long* strides, int layout,           \
                                            int cols_pad, void* codes, void* scales,        \
                                            void* stream) {                                 \
    return quantize_heads_group<T>(x, sizes, strides, layout, cols_pad, codes, scales,      \
                                   static_cast<cudaStream_t>(stream));                      \
  }                                                                                         \
  extern "C" int quantize_nhwc_s8_##SUFFIX(const void* x, const long long* sizes,          \
                                           const long long* strides, int c_pad,             \
                                           void* partials, int parts, void* codes,          \
                                           void* scales, int* path, void* stream) {         \
    return quantize_nhwc<T>(x, sizes, strides, c_pad, partials, parts, codes, scales, path, \
                            static_cast<cudaStream_t>(stream));                             \
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
  }

QUANT_ENTRIES(f32, float)
QUANT_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
