// Exact int8 convolution on the tensor cores, as one implicit GEMM: NHWC
// int8 codes (B, H, W, C_pad) convolved with tap-major int8 weight codes
// (N, k*k*C_pad), every product and sum exact in int32, then dequantized in
// the epilogue, float(y) * (sa[b] * sw[n]), and written NCHW (B, N, Ho, Wo)
// in fp32 or bf16 for the frozen BN that follows.
//
// It replaces no Pallas kernel: it computes spotter_tpu/utils/quant.py's
// `_int8_conv_core` (:146-154), XLA's s8 conv_general_dilated with int32
// accumulation and the dequant that XLA fuses into it on the TPU. Before it
// the port ran that as an im2col pass (9 bytes written a value at 3x3), the
// GEMM of csrc/int8_gemm.cu (an int32 product written out) and a dequant
// pass reading it back; here the codes are read in place and neither
// intermediate exists.
//
// What bounds it on an H100: operations at the 3x3 convolutions (csp80:
// 2 * 51,200 * 384 * 3,456 = 135.9 G int ops, 69 us at 1,979 TOP/s, against
// 60.3 MB of codes, weights and output, 18 us at 3.35 TB/s), bytes at the
// 1x1 ones (bb_p3). The design keeps the tensor cores fed from shared memory:
//
// - a block owns BM = 128 output pixels (linear over B*Ho*Wo, so a tile may
//   straddle two samples) by BN output channels, BN in {64, 128, 192}
//   chosen by the caller so that N tiles with little waste (N = 384 as two
//   tiles of 192, not two of 256: a 256-wide tile also spills under the
//   168 registers a thread has here); three warpgroups: a producer and two
//   consumers, each consumer 64 pixels x BN channels of int32 accumulators;
// - the K walk: step t covers the 128 bytes t*128 .. +127 of the (tap,
//   channel) order, tap = ky*k + kx and the channel fastest. 16-byte chunk j
//   of a step is at tap = off / C_pad, c = off % C_pad for off = t*128 +
//   16*j, so a step may span two taps when C_pad = 64 and any C_pad that is
//   a multiple of 16 works with no special case;
// - A is gathered in place by the producer warpgroup with 16-byte cp.async:
//   chunk (row, j) from pixel (b, oy*s + ky - p, ox*s + kx - p) of the codes,
//   zeros (src-size 0) for the halo, for K past k*k*C_pad and for rows past
//   M; each chunk lands at its slot of the 128-byte swizzle (j ^ (row & 7)),
//   so the wgmma descriptors read it as they read TMA's tiles. Lanes j = 0..7
//   of a warp cover one row's 128 bytes, so a warp reads four 128-byte runs.
//   cp.async.mbarrier.arrive.noinc signals the stage's full barrier when a
//   thread's copies have landed;
// - B (the weight, (N, K) K-major) arrives by TMA, 2-D map, in the same
//   ring of stages (full and empty mbarriers, as csrc/int8_gemm.cu);
// - cp.async writes through the generic proxy and wgmma reads through the
//   async proxy, so each consumer thread issues fence.proxy.async after its
//   wait on a stage's full barrier and before its wgmma read the stage;
// - the epilogue: __int2float_rn(acc) * (sa[b] * sw[n]), the scale product
//   formed first, rounded once to the output type (bf16 to nearest even);
//   the tile is staged transposed (channel-major, pixels along a row) in a
//   shared-memory tile of its own and stored along pixels into NCHW:
//   16-byte stores where Ho*Wo is a multiple of the 16-byte run (a run never
//   straddles two samples then), single values otherwise; sample b looked up
//   per pixel; masked at the tile's edges;
// - the grid is persistent: as many blocks as the SMs hold, each walking
//   tiles with the ring running on from one tile to the next, so the
//   producer fills the next tile's stages while the consumers run the
//   epilogue (a 1x1 convolution has two or three K steps a tile, and without
//   that overlap its loads and its stores would take turns).
//
// No memset, no host synchronisation and no state between calls: the launch
// is capturable in a CUDA graph and two calls in flight share nothing. This
// file is built without --use_fast_math, so the dequant is the IEEE product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;  // output pixels a block: two consumer warpgroups of 64
constexpr int kBK = 128;  // bytes of K a stage: one 128-byte swizzle row
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kRowsPerThread = kBM / 16;  // the producer's rows: 16 a pass of its 128 threads

// The blocks an SM holds by tile width (the 64-wide tile keeps two), and a
// block's shared memory: the staged output tile of the epilogue (BN
// channels of kBM pixels, a 16-byte pad a row) beside a ring of as many
// stages as the rest of ~220 KB (~110 KB at two blocks) holds.
template <int BN, typename T>
struct Ring {
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  static constexpr int kPitch = kBM + 16 / static_cast<int>(sizeof(T));  // staged row, elements
  static constexpr int kStageBytes = kBM * kBK + BN * kBK;
  static constexpr int kBudget = (BN == 64 ? 110 : 222) * 1024 - BN * kPitch * sizeof(T);
  static constexpr int kStages = kBudget / kStageBytes;
  static_assert(kStages >= 2, "a ring of two stages at least");
};

template <int BN, typename T>
struct alignas(1024) Smem {
  static constexpr int S = Ring<BN, T>::kStages;
  int8_t a[S][kBM * kBK];  // [pixel][k], 16 KB a stage
  int8_t b[S][BN * kBK];   // [n][k], the weight's tile
  alignas(16) T tile[BN * Ring<BN, T>::kPitch];  // the epilogue's [n][pixel]
  uint64_t full[S];
  uint64_t empty[S];
};

struct Geometry {
  int h, w, c_pad;   // the NHWC codes' sample
  int ho, wo, n;     // the output's
  int ksize, stride, pad;
  int k;             // ksize * ksize * c_pad
  int m;             // B * Ho * Wo
};

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

// 16 bytes from global memory into shared memory, asynchronously; zeros when
// !valid (src-size 0: nothing is read).
__device__ __forceinline__ void copy16_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed; the barrier's expected count includes it (noinc).
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

template <int BN, typename T>
__global__ void __launch_bounds__(kThreads, Ring<BN, T>::kMinBlocks)
conv_s8_kernel(const __grid_constant__ CUtensorMap w_map, const int8_t* __restrict__ x,
               const float* __restrict__ sa, const float* __restrict__ sw,
               T* __restrict__ out, const Geometry g) {
  using Sm = Smem<BN, T>;
  constexpr int S = Sm::S;
  constexpr int kPitch = Ring<BN, T>::kPitch;
  extern __shared__ char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_1024(smem_raw));
  // warp-uniform as far as the compiler can see, so the roles' paths are not divergent
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int hwo = g.ho * g.wo;
  const int k_tiles = (g.k + kBK - 1) / kBK;
  const int n_tiles = (g.n + BN - 1) / BN;
  const int tiles = n_tiles * ((g.m + kBM - 1) / kBM);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 128 + 1);  // each producer thread's copies, and the TMA's bytes
      mbar_init(&sm.empty[st], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the block walks tiles blockIdx.x, + gridDim.x, ..., the N tiles of an M
  // tile in a row (they gather the same pixels); `it` counts K steps over
  // the whole walk, so the ring's stages and phases run on across tiles and
  // the producer fills the next tile's stages while the consumers store
  if (warpgroup == 0) {  // producer
    const int t = threadIdx.x;
    const int j = t % 8;    // the chunk of each 128-byte step this thread copies
    const int rg = t / 8;   // its rows: rg + 16 i
    // every row of this thread sits at swizzled chunk j ^ (rg & 7) of its 128 bytes
    const uint32_t dst0 = smem_addr(sm.a[0]) + rg * kBK + ((j ^ (rg & 7)) * 16);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN;
      const int m0 = (tile / n_tiles) * kBM;
      long long row_off[kRowsPerThread];  // the row's pixel at tap (0, 0), in bytes
      int iy0[kRowsPerThread], ix0[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int p = m0 + rg + 16 * i;
        if (p < g.m) {
          const int b = p / hwo;
          const int r = p - b * hwo;
          const int oy = r / g.wo;
          iy0[i] = oy * g.stride - g.pad;
          ix0[i] = (r - oy * g.wo) * g.stride - g.pad;
          row_off[i] = ((static_cast<long long>(b) * g.h + iy0[i]) * g.w + ix0[i]) * g.c_pad;
        } else {  // past M: every tap outside
          iy0[i] = -(1 << 30);
          ix0[i] = 0;
          row_off[i] = 0;
        }
      }
      // chunk j's (tap, channel) at step 0; advanced by 128 bytes a step
      int c = (16 * j) % g.c_pad;
      const int tap = (16 * j) / g.c_pad;
      int ky = tap / g.ksize;
      int kx = tap - ky * g.ksize;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int st = it % S;
        mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
        if (t == 0) {
          mbar_expect_tx(&sm.full[st], BN * kBK);
          tma_load_2d(sm.b[st], &w_map, &sm.full[st], kt * kBK, n0);
        }
        const bool k_inside = ky < g.ksize;
        const int delta = (ky * g.w + kx) * g.c_pad + c;
        const uint32_t dst = dst0 + st * (kBM * kBK);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const bool inside = k_inside &&
                              static_cast<unsigned>(iy0[i] + ky) < static_cast<unsigned>(g.h) &&
                              static_cast<unsigned>(ix0[i] + kx) < static_cast<unsigned>(g.w);
          copy16_async(dst + 16 * i * kBK, inside ? x + row_off[i] + delta : x, inside);
        }
        copies_arrive(&sm.full[st]);
        c += kBK;
        while (c >= g.c_pad) {
          c -= g.c_pad;
          if (++kx == g.ksize) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer cw owns pixels m0 + 64 cw .. + 63; within them warp w rows
  // 16 w .. + 15, and lane (q = lane / 4, t = lane % 4) rows q and q + 8,
  // channels 8 i + 2 t and + 1 of each 8-channel group i: acc[4 i + 2 r + c]
  const int cw = warpgroup - 1;
  const int tid = threadIdx.x - 128 * warpgroup;
  const int warp = tid / 32;
  const int q = (tid % 32) / 4;
  const int t = tid % 4;
  const int ct = threadIdx.x - 128;  // 0 .. 255: the store's thread
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles) * BN;
    const int m0 = (tile / n_tiles) * kBM;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % S;
      mbar_wait(&sm.full[st], (it / S) & 1);
      fence_proxy_async_shared();  // the producer's cp.async writes, before wgmma reads them
      const uint64_t a_desc = sw128_desc(&sm.a[st][cw * 64 * kBK], 16);
      const uint64_t b_desc = sw128_desc(sm.b[st], 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {  // 32 bytes of K a step
        wgmma_s8_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done with it
      if (kt > 0) mbar_arrive_per_warp(&sm.empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive_per_warp(&sm.empty[(it - 1) % S]);  // the tile's last stage

    // the epilogue: the dequantized tile staged channel-major, once both
    // consumers' stores of the previous tile have read the staging
    named_bar_sync(1, kConsumerThreads);
    float s_pix[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = m0 + 64 * cw + 16 * warp + q + 8 * r;
      s_pix[r] = p < g.m ? sa[p / hwo] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * i + 2 * t + c;
        const float s_ch = n0 + n < g.n ? sw[n0 + n] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float s = s_pix[r] * s_ch;
          sm.tile[n * kPitch + 64 * cw + 16 * warp + q + 8 * r] =
              from_float<T>(__int2float_rn(acc[4 * i + 2 * r + c]) * s);
        }
      }
    }
    named_bar_sync(1, kConsumerThreads);

    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (hwo % kVec == 0) {  // 16-byte runs of pixels, each inside one sample
      constexpr int kRuns = kBM / kVec;
      for (int item = ct; item < BN * kRuns; item += kConsumerThreads) {
        const int n = item / kRuns;
        const int p = m0 + (item % kRuns) * kVec;
        if (n0 + n < g.n && p < g.m) {
          const int b = p / hwo;
          T* dst = out + (static_cast<long long>(b) * g.n + n0 + n) * hwo + (p - b * hwo);
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(sm.tile + n * kPitch + (item % kRuns) * kVec);
        }
      }
    } else {
      for (int item = ct; item < BN * kBM; item += kConsumerThreads) {
        const int n = item / kBM;
        const int p = m0 + item % kBM;
        if (n0 + n < g.n && p < g.m) {
          const int b = p / hwo;
          out[(static_cast<long long>(b) * g.n + n0 + n) * hwo + (p - b * hwo)] =
              sm.tile[n * kPitch + item % kBM];
        }
      }
    }
  }
}

template <int BN, typename T>
int launch(const void* x, const void* w, const void* sa, const void* sw, void* out,
           const Geometry& g, cudaStream_t stream) {
  CUtensorMap w_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.k), static_cast<cuuint64_t>(g.n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.k)};
  const cuuint32_t box[2] = {kBK, BN};
  const int err = encode_tiled(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box);
  if (err != 0) return err;
  constexpr size_t smem = sizeof(Smem<BN, T>) + 1024;  // + the alignment slack
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_s8_kernel<BN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;  // persistent: as many blocks as the SMs hold at once
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = sms * Ring<BN, T>::kMinBlocks;
  const long long tiles =
      static_cast<long long>((g.n + BN - 1) / BN) * ((g.m + kBM - 1) / kBM);
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  conv_s8_kernel<BN, T><<<grid, kThreads, smem, stream>>>(
      w_map, static_cast<const int8_t*>(x), static_cast<const float*>(sa),
      static_cast<const float*>(sw), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int conv(const void* x, const void* w, const void* sa, const void* sw, void* out, int batch,
         int h, int wd, int c_pad, int n, int ksize, int stride, int pad, int bn,
         cudaStream_t stream) {
  if (batch < 1 || h < 1 || wd < 1 || c_pad < 16 || c_pad % 16 || n < 1 || ksize < 1 ||
      stride < 1 || pad < 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.h = h;
  g.w = wd;
  g.c_pad = c_pad;
  g.ho = (h + 2 * pad - ksize) / stride + 1;
  g.wo = (wd + 2 * pad - ksize) / stride + 1;
  g.n = n;
  g.ksize = ksize;
  g.stride = stride;
  g.pad = pad;
  const long long k = static_cast<long long>(ksize) * ksize * c_pad;
  const long long m = static_cast<long long>(batch) * g.ho * g.wo;
  // |sum| <= K * 127 * 127 must fit int32; pixels and tiles in int
  if (g.ho < 1 || g.wo < 1 || k > (2147483647LL / (127 * 127)) || m > (1LL << 30) ||
      static_cast<long long>(batch) * h * wd * c_pad > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((n + 63LL) / 64 * ((m + kBM - 1) / kBM) > 2147483647LL) {  // tiles in int
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.k = static_cast<int>(k);
  g.m = static_cast<int>(m);
  switch (bn) {
    case 64:
      return launch<64, T>(x, w, sa, sw, out, g, stream);
    case 128:
      return launch<128, T>(x, w, sa, sw, out, g, stream);
    case 192:
      return launch<192, T>(x, w, sa, sw, out, g, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. x: NHWC int8 codes (batch, h, w,
// c_pad), contiguous, c_pad a multiple of 16; w: the tap-major int8 weight
// codes (n, ksize*ksize*c_pad), contiguous; sa (batch,) and sw (n,) fp32;
// out: NCHW (batch, n, ho, wo) fp32 or bf16, contiguous; bn: the tile's
// width in output channels, 64, 128 or 192. The grid is as many blocks as
// the SMs hold at once (a block a tile when there are fewer tiles), each
// walking tiles blockIdx.x, + gridDim.x, ... Every pointer 16-byte aligned. The stream is the caller's current CUDA stream. Returns the
// error of the launch or of its tensor map (0 on success); nothing
// synchronises or allocates.
#define CONV_ENTRY(SUFFIX, T)                                                                \
  extern "C" int conv_s8_##SUFFIX(const void* x, const void* w, const void* sa,             \
                                  const void* sw, void* out, int batch, int h, int wd,      \
                                  int c_pad, int n, int ksize, int stride, int pad, int bn, \
                                  void* stream) {                                           \
    return conv<T>(x, w, sa, sw, out, batch, h, wd, c_pad, n, ksize, stride, pad, bn,       \
                   static_cast<cudaStream_t>(stream));                                      \
  }

CONV_ENTRY(f32, float)
CONV_ENTRY(bf16, __nv_bfloat16)

extern "C" const char* conv_s8_error_string(int code) { return hopper::error_string(code); }
