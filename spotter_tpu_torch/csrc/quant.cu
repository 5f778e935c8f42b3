// The passes around the int8 GEMM (csrc/int8_gemm.cu) that make the JAX
// package's int8 quantization (spotter_tpu/utils/quant.py) on Hopper: the
// TPU's XLA quantizes and dequantizes inside its s8 convolution and dot;
// PyTorch has no int8 convolution or batched int8 matmul on CUDA, so the
// port quantizes into the GEMM's K-major operands here and dequantizes its
// int32 product after it.
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
//    over a grid the wrapper sizes to fill the card; a strided view (Q, K,
//    V's heads: the general path) is read an element at a time through its
//    strides. Max is order-free, so the amax is exact.
//
// 2. quantize_s8 (replaces quantize_activation / quantize_per_head,
//    quant.py:124), from the partials of 1: amax = max of the group's
//    partials, scale = max(amax, 1e-12) / 127 and code =
//    clip(rint(x / scale), -127, 127), in fp32 with an IEEE division (this
//    file is built without --use_fast_math, so `/` is div.rn.f32) and
//    round-half-even (rintf), as jnp.round and jnp's `/` compute it. Rows
//    are padded with zero codes to a multiple of 16 (TMA's row pitch), which
//    leaves every int32 sum unchanged. Output layouts:
//      rows:     a (d0, d1, d2, d3) view -> (d0*d1*d2, K_pad), K = d3: dense
//                activations and weights, and the attention weights;
//      heads:    x (B, T, H, hd) -> (B*H, T, hd_pad): Q and K for QKᵀ;
//      heads_t:  x (B, T, H, hd) -> (B*H, hd, T_pad): V transposed, so that
//                attn·V's B operand arrives K-major;
//    each thread writes 16 codes (one 16-byte store) of an output row, the
//    block's groups' scales reduced once into shared memory;
//      im2col:   NCHW x -> (B*Ho*Wo, K_pad), K = C*kh*kw in (c, ky, kx)
//                order (the OIHW weight's own), zero padding and stride.
//    The im2col is bound by the bytes it writes (a 3x3 conv writes 9 bytes
//    a value read). A block owns a tile of output pixels and a chunk of
//    channels: it loads the input patch with its halo once, quantizes each
//    value once (one division, not one a tap) into int8 codes in shared
//    memory, gathers each pixel's (c, ky, kx) row from there at offsets
//    fixed at compile time (kernel size and stride are template
//    arguments), stages the rows in shared memory and writes them out in
//    16-byte stores that run along each row. Where x is contiguous along W
//    the patch arrives by 16-byte asynchronous copies (cp.async, zeros
//    outside the input), all in flight at once, or, where rows are not
//    whole 16-byte chunks, by loads with lanes along x; any other strides
//    take the general path, lanes along channels (channels-last coalesces).
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
// is layer 1's 3x3 conv at 160x160x64: 26 MB of bf16 input read and a 118 MB
// im2col written; its dequant reads 52 MB of int32 and writes 26 MB.

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

// ---- quantize_s8 -------------------------------------------------------------------

__device__ __forceinline__ float scale_from(float amax) {
  return fmaxf(amax, 1e-12f) / 127.0f;
}

__device__ __forceinline__ uint32_t code_of(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
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

enum Layout { kRows = 0, kHeads = 1, kHeadsT = 2 };

// The group of output row r (rows: one group a sample, head_axis 0). It
// never decreases along r, so a block's rows cover a run of groups.
__device__ __forceinline__ int row_group(const View& v, int layout, long long r) {
  if (layout == kRows) return static_cast<int>(r / (v.n[1] * v.n[2]));
  return static_cast<int>(r / (layout == kHeads ? v.n[1] : v.n[3]));
}

// Codes of the (rows, cols_pad) output of `layout`, 16 a thread, one chunk
// of 16 a thread in row order; threads below the group count also write
// the groups' scales.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, View v, int layout, long long rows, int cols,
                int cols_pad, const float* __restrict__ partials, int parts, int groups,
                int8_t* __restrict__ out, float* __restrict__ scales) {
  const int chunks = cols_pad / 16;
  const long long total = rows * chunks;
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long t = t0 + threadIdx.x;
  if (t < groups) scales[t] = scale_from(group_amax(partials, parts, static_cast<int>(t)));
  // the scales of the block's first kWarps groups, a warp a group
  __shared__ float block_scale[kWarps];
  const long long t1 = (t0 + kThreads < total ? t0 + kThreads : total) - 1;
  const int g0 = t0 < total ? row_group(v, layout, t0 / chunks) : 0;
  const int g1 = t0 < total ? row_group(v, layout, t1 / chunks) : -1;
  const int warp = threadIdx.x / 32;
  if (g0 + warp <= g1) {
    const float s = scale_from(warp_group_amax(partials, parts, g0 + warp));
    if (threadIdx.x % 32 == 0) block_scale[warp] = s;
  }
  __syncthreads();
  if (t >= total) return;
  const long long r = t / chunks;
  const int c0 = static_cast<int>(t % chunks) * 16;
  // the row's input coordinates (i0, i1, i2, i3) but for the column's axis
  long long i[4] = {0, 0, 0, 0};
  int col_axis;
  const int g = row_group(v, layout, r);
  if (layout == kRows) {  // r = flat (i0, i1, i2), column = i3
    long long q = r;
    i[2] = q % v.n[2];
    q /= v.n[2];
    i[1] = q % v.n[1];
    i[0] = q / v.n[1];
    col_axis = 3;
  } else {
    if (layout == kHeads) {  // r = (b*H + h)*T + t, column = d
      i[1] = r % v.n[1];
      col_axis = 3;
    } else {  // r = (b*H + h)*hd + d, column = t
      i[3] = r % v.n[3];
      col_axis = 1;
    }
    i[0] = g / v.n[2];
    i[2] = g % v.n[2];
  }
  const float scale = g - g0 < kWarps ? block_scale[g - g0]
                                      : scale_from(group_amax(partials, parts, g));
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

// ---- quantize_s8, the im2col ---------------------------------------------------------

// How a block reads its patch: through the strides with lanes along
// channels (the general path), with lanes along x (x contiguous), or in
// 16-byte asynchronous copies, all in flight at once (x contiguous, the
// tensor's base and strides 16-byte aligned).
enum PatchLoad { kLoadGeneral = 0, kLoadAlongX = 1, kLoadAsync = 2 };

// 16 bytes from global to shared memory, asynchronously (L2 only, which
// fetches the 128-byte line around them); zeros when !valid (src is then
// not read)
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A block's tile for a KS x KS kernel at stride S on T inputs: TH x TW
// output pixels of one sample and CC input channels. Shared memory holds the
// patch's codes (CC x IH x IW bytes, the halo included) and the staged rows
// (a pixel's CC*KS*KS bytes, its pitch an odd number of 16-byte units so
// that a warp's 16-byte accesses 32 pitches apart spread over the banks);
// the raw patch of the asynchronous copies (RW values a row: the 16-byte
// chunks around IW values at any offset) shares the staging region, which
// it leaves before the rows are built. A thread
// builds a unit: U channels of one pixel, U*KS*KS bytes, a whole number of
// 32-bit words (of 16-byte chunks where U*KS*KS allows).
template <typename T, int KS, int S>
struct Im2colTile {
  static constexpr int CC = KS == 1 ? 128 : (KS == 3 ? 32 : 16);
  static constexpr int TH = 8;
  static constexpr int TW = KS == 7 ? 8 : 16;
  static constexpr int U = KS == 7 ? 4 : 16;
  static constexpr int IH = (TH - 1) * S + KS;
  static constexpr int IW = (TW - 1) * S + KS;
  static constexpr int TP = TH * TW;
  static constexpr int SEG = CC * KS * KS;  // staged bytes a pixel, a multiple of 16
  static constexpr int PITCH = (SEG / 16 | 1) * 16;
  static constexpr int IN_BYTES = (CC * IH * IW + 15) / 16 * 16;
  static constexpr int VE = 16 / sizeof(T);            // values a 16-byte chunk
  static constexpr int RCH = (IW + 2 * VE - 2) / VE;    // chunks a raw row
  static constexpr int RW = RCH * VE;
  static constexpr int RAW_BYTES = CC * IH * RW * sizeof(T);
  static constexpr bool ASYNC = RAW_BYTES <= 96 * 1024;  // else the plain loads
  static constexpr int STAGE = TP * PITCH;
  static constexpr int REGION = ASYNC && RAW_BYTES > STAGE ? RAW_BYTES : STAGE;
  static constexpr int SMEM = REGION + IN_BYTES;
};

// Block (channel chunk, pixel tile, sample): (1) every warp reduces the
// sample's amax partials; (2) the patch is read once, each value quantized
// once (zero codes for the padding, the ragged edge and channels past C);
// (3) each unit gathers its pixel's (c, ky, kx) bytes at compile-time
// offsets into the staging rows; (4) the rows go out as 16-byte stores
// along each row, the block's columns [c0*KS*KS, +SEG), and for the last
// channel chunk up to k_pad (zero past K).
template <typename T, int KS, int S, int kLoad>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const T* __restrict__ x, View v, int pad, int ho_n, int wo_n, int tiles_w,
              int k_pad, const float* __restrict__ partials, int parts,
              int8_t* __restrict__ out, float* __restrict__ scales) {
  using Tile = Im2colTile<T, KS, S>;
  constexpr int kPlane = Tile::IH * Tile::IW;
  constexpr int kPatch = Tile::CC * kPlane;
  constexpr int kLoads = 8;  // loads in flight a thread on the plain paths
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = smem;
  uint8_t* patch = smem + Tile::REGION;
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * Tile::CC;
  const int oy0 = static_cast<int>(blockIdx.y / tiles_w) * Tile::TH;
  const int ox0 = static_cast<int>(blockIdx.y % tiles_w) * Tile::TW;
  const int y_base = oy0 * S - pad;
  const int x_base = ox0 * S - pad;
  const int n_c = static_cast<int>(v.n[1]);
  const int h = static_cast<int>(v.n[2]);
  const int w = static_cast<int>(v.n[3]);
  const T* xb = x + b * v.s[0];
  // the raw patch's rows start at the 16-byte chunk holding x_base (chunks
  // lie wholly inside or outside a row: W is a whole number of chunks)
  const int x_chunk = (x_base >= 0 ? x_base : x_base - Tile::VE + 1) / Tile::VE * Tile::VE;
  if constexpr (kLoad == kLoadAsync) {  // every copy of the patch in flight at once
    for (int q = threadIdx.x; q < Tile::CC * Tile::IH * Tile::RCH; q += kThreads) {
      const int row = q / Tile::RCH;  // (cu, iy)
      const int c = c0 + row / Tile::IH;
      const int yy = y_base + row % Tile::IH;
      const int xx = x_chunk + q % Tile::RCH * Tile::VE;
      const bool inside = c < n_c && static_cast<unsigned>(yy) < static_cast<unsigned>(h) &&
                          static_cast<unsigned>(xx) < static_cast<unsigned>(w);
      copy16_async(stage + static_cast<size_t>(q) * 16,
                   inside ? xb + c * v.s[1] + yy * v.s[2] + xx : x, inside);
    }
  }
  const float scale = scale_from(warp_group_amax(partials, parts, b));
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scales[b] = scale;

  if constexpr (kLoad == kLoadAsync) {
    copies_landed();
    __syncthreads();
    const T* raw = reinterpret_cast<const T*>(stage);
    const int skew = x_base - x_chunk;
    for (int e = threadIdx.x; e < kPatch; e += kThreads) {
      const int row = e / Tile::IW;  // (cu, iy)
      const float val = to_float(raw[row * Tile::RW + skew + e % Tile::IW]);
      patch[e] = static_cast<uint8_t>(val == 0.f ? 0u : code_of(val, scale));
    }
  } else {
    for (int e0 = threadIdx.x; e0 < kPatch; e0 += kLoads * kThreads) {
      float val[kLoads];
      int at[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads;
        int cu, iy, ix;
        if (kLoad == kLoadAlongX) {  // e = (cu, iy, ix), x fastest
          cu = e / kPlane;
          iy = e % kPlane / Tile::IW;
          ix = e % Tile::IW;
        } else {  // e = (iy, ix, cu), channels fastest
          cu = e % Tile::CC;
          iy = e / Tile::CC / Tile::IW;
          ix = e / Tile::CC % Tile::IW;
        }
        const int c = c0 + cu;
        const int yy = y_base + iy;
        const int xx = x_base + ix;
        at[u] = e < kPatch ? cu * kPlane + iy * Tile::IW + ix : -1;
        const bool inside = e < kPatch && c < n_c &&
                            static_cast<unsigned>(yy) < static_cast<unsigned>(h) &&
                            static_cast<unsigned>(xx) < static_cast<unsigned>(w);
        val[u] = inside ? to_float(xb[c * v.s[1] + yy * v.s[2] + xx * v.s[3]]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (at[u] >= 0) {
          patch[at[u]] = static_cast<uint8_t>(val[u] == 0.f ? 0u : code_of(val[u], scale));
        }
      }
    }
  }
  __syncthreads();

  constexpr int kTaps = KS * KS;
  constexpr int kUnitBytes = Tile::U * kTaps;
  constexpr int kWords = kUnitBytes / 4;
  constexpr int kUnits = Tile::TP * (Tile::CC / Tile::U);
  for (int unit = threadIdx.x; unit < kUnits; unit += kThreads) {
    const int p = unit % Tile::TP;
    const int gu = unit / Tile::TP;
    const int py = p / Tile::TW;
    const int px = p % Tile::TW;
    if (oy0 + py >= ho_n || ox0 + px >= wo_n) continue;
    const uint8_t* src = patch + gu * Tile::U * kPlane + py * S * Tile::IW + px * S;
    uint8_t* dst = stage + p * Tile::PITCH + gu * kUnitBytes;
    uint32_t word[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * k + e;  // (cu, ky, kx) of the unit's byte
        const int tap = col % kTaps;
        packed |= static_cast<uint32_t>(src[col / kTaps * kPlane + tap / KS * Tile::IW + tap % KS])
                  << (8 * e);
      }
      word[k] = packed;
    }
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q) {
        *reinterpret_cast<uint4*>(dst + 16 * q) =
            make_uint4(word[4 * q], word[4 * q + 1], word[4 * q + 2], word[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) *reinterpret_cast<uint32_t*>(dst + 4 * k) = word[k];
    }
  }
  __syncthreads();

  constexpr int kSegChunks = Tile::SEG / 16;
  const int col0 = c0 * kTaps;
  // the last channel chunk writes on to k_pad: its staged channels past C
  // are zero codes, and any columns past its staging zero
  const int chunks = c0 + Tile::CC >= n_c ? (k_pad - col0) / 16 : kSegChunks;
  const long long row0 = static_cast<long long>(b) * ho_n * wo_n;
  for (int i = threadIdx.x; i < Tile::TP * chunks; i += kThreads) {
    const int p = chunks == kSegChunks ? i / kSegChunks : i / chunks;
    const int j = i - p * chunks;
    const int oy = oy0 + p / Tile::TW;
    const int ox = ox0 + p % Tile::TW;
    if (oy >= ho_n || ox >= wo_n) continue;
    const uint4 val = j < kSegChunks
                          ? *reinterpret_cast<const uint4*>(stage + p * Tile::PITCH + 16 * j)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(out + (row0 + static_cast<long long>(oy) * wo_n + ox) * k_pad +
                              col0 + 16 * j) = val;
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

template <typename T>
int quantize(const void* x, const long long* sizes, const long long* strides, int head_axis,
             int layout, int cols_pad, const void* partials, int parts, void* codes,
             void* scales, cudaStream_t stream) {
  const View v = make_view(sizes, strides, head_axis);
  if (!valid_view(v) || cols_pad % 16 || cols_pad <= 0 || parts < 1) return cudaErrorInvalidValue;
  if ((layout == kRows) != (head_axis == 0) || (layout != kRows && head_axis != 2)) {
    return cudaErrorInvalidValue;
  }
  const int groups = groups_of(v);
  if (groups < 1) return cudaErrorInvalidValue;
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
  const long long blocks = ((work > groups ? work : groups) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), v, layout, rows, cols, cols_pad,
      static_cast<const float*>(partials), parts, groups, static_cast<int8_t*>(codes),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// The patch's loader for x: where x is contiguous along W, the asynchronous
// copies if the tile's raw patch fits and the base and strides are 16-byte
// aligned, else loads with lanes along x; otherwise the general path. Its
// choice goes to *path.
template <typename T, int KS, int S>
int im2col_tiles(const T* x, const View& v, int pad, int ho, int wo, int k_pad,
                 const float* partials, int parts, int8_t* codes, float* scales,
                 int* path, cudaStream_t stream) {
  using Tile = Im2colTile<T, KS, S>;
  const int tiles_w = (wo + Tile::TW - 1) / Tile::TW;
  const long long tiles = static_cast<long long>((ho + Tile::TH - 1) / Tile::TH) * tiles_w;
  const long long chunks = (v.n[1] + Tile::CC - 1) / Tile::CC;
  if (tiles > 65535 || chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (v.s[0] * sizeof(T)) % 16 == 0 && (v.s[1] * sizeof(T)) % 16 == 0 &&
                       (v.s[2] * sizeof(T)) % 16 == 0 && (v.n[3] * sizeof(T)) % 16 == 0;
  const bool along_x = v.s[3] == 1 || v.n[3] == 1;
  const int load = !along_x                   ? kLoadGeneral
                   : Tile::ASYNC && aligned   ? kLoadAsync
                                              : kLoadAlongX;
  void (*kernel)(const T*, View, int, int, int, int, int, const float*, int, int8_t*, float*) =
      load == kLoadAsync    ? im2col_kernel<T, KS, S, kLoadAsync>
      : load == kLoadAlongX ? im2col_kernel<T, KS, S, kLoadAlongX>
                            : im2col_kernel<T, KS, S, kLoadGeneral>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(tiles),
                  static_cast<unsigned>(v.n[0]));
  kernel<<<grid, kThreads, Tile::SMEM, stream>>>(x, v, pad, ho, wo, tiles_w, k_pad, partials,
                                                  parts, codes, scales);
  *path = load;
  return static_cast<int>(cudaGetLastError());
}

// kernel sizes 1, 3 and 7 at strides 1 and 2
template <typename T>
int im2col(const void* x, const long long* sizes, const long long* strides, int ks, int stride,
           int pad, int k_pad, const void* partials, int parts, void* codes,
           void* scales, int* path, cudaStream_t stream) {
  const View v = make_view(sizes, strides, 0);
  if (!valid_view(v) || pad < 0 || parts < 1 || k_pad % 16 || k_pad < v.n[1] * ks * ks ||
      v.n[0] > 65535) {
    return cudaErrorInvalidValue;
  }
  const int ho = static_cast<int>((v.n[2] + 2 * pad - ks) / stride + 1);
  const int wo = static_cast<int>((v.n[3] + 2 * pad - ks) / stride + 1);
  if (ho < 1 || wo < 1) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const float* p = static_cast<const float*>(partials);
  int8_t* c = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
#define IM2COL_CASE(K, ST)                                                                     \
  if (ks == K && stride == ST) {                                                              \
    return im2col_tiles<T, K, ST>(xt, v, pad, ho, wo, k_pad, p, parts, c, s, path, stream);   \
  }
  IM2COL_CASE(1, 1)
  IM2COL_CASE(1, 2)
  IM2COL_CASE(3, 1)
  IM2COL_CASE(3, 2)
  IM2COL_CASE(7, 1)
  IM2COL_CASE(7, 2)
#undef IM2COL_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes. Inputs are read through their
// strides (in elements); outputs are contiguous. `partials` holds `parts`
// fp32 words a group: amax_s8 writes each group's partial maxima there, the
// quantize entries reduce them. The amax and im2col entries write the path
// they took to *path (`amax_pass`, `PatchLoad`). The stream is the caller's
// current CUDA stream. Each returns the error of its launches (0 on
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
                                      void* scales, void* stream) {                         \
    return quantize<T>(x, sizes, strides, head_axis, layout, cols_pad, partials, parts,     \
                       codes, scales, static_cast<cudaStream_t>(stream));                   \
  }                                                                                         \
  extern "C" int quantize_im2col_s8_##SUFFIX(                                               \
      const void* x, const long long* sizes, const long long* strides, int ks, int stride,  \
      int pad, int k_pad, void* partials, int parts, void* codes, void* scales, int* path,  \
      void* stream) {                                                                       \
    return im2col<T>(x, sizes, strides, ks, stride, pad, k_pad, partials, parts, codes,     \
                     scales, path, static_cast<cudaStream_t>(stream));                      \
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
