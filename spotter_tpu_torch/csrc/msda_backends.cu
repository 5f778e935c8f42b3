// The two opt-in MSDA sampling backends (SPOTTER_TPU_MSDA=pallas_sep and
// =pallas_gather), each on the operands the JAX package hands its TPU kernel.
//
// 1. msda_sep_sum replaces spotter_tpu/ops/msda.py::pallas_sep_sampling, the
//    separable bilinear sampling of one feature level. Per (b*h, query):
//
//        out[bh, q] = sum_p sum_{dy, dx in {0, 1}} xw_dx * V[y0 + dy, x0 + dx] * yw_dy
//
//    with x0/y0 the unclamped level-local corner, attention and validity
//    folded into the weights, 64-query tiles (point-major inside a tile), and
//    a per-(tile, row band) hit table: a row counts only where its band's bit
//    is set. The TPU kernel builds an x one-hot (P*64, W), contracts it with a
//    band of value rows transposed to (W, R*hd) on the MXU, selects rows by
//    compares and sums with a 0/1 matrix: MXU-shaped work. Here each corner
//    is evaluated directly: the value rows are read in their own row-major
//    (lh*lw, hd) layout, and a corner outside the level or in a band whose bit
//    is clear is never loaded (the TPU gets that from its compares; an index
//    that is not checked would read out of bounds here). fp32 out, whatever
//    the value dtype, as the JAX kernel's out_shape.
//
// 2. msda_hd_gather_sum replaces spotter_tpu/ops/msda.py::
//    pallas_deformable_sampling, the lane gather in its own layout: value
//    vt (B, H, hd, S), sample-major idx/w (B, H, 4, LP*Q) from the corner
//    prep, out (B, H, hd, Q):
//
//        out[bh, d, q] = sum_j (sum_c w[bh, c, j*Q + q] * vt[bh, d, idx[bh, c, j*Q + q]])
//
//    with the four corner products and then the LP samples summed in vt's
//    dtype, in that order, as the TPU kernel accumulates. Nothing is padded:
//    the TPU's common lane extent max(S, LP*Q) exists for Mosaic's gather,
//    and any S and Q are taken here.
//
// What bounds them on an H100. Both move few bytes per operation: every term
// is one value load and one or two FMAs. sep: at the Deformable-DETR encoder
// (1333x1333 bucket: S = Q = 37,150 tokens over 4 levels, 8 heads of 32,
// 4 points a level) the six query-side operands are 24 bytes per (query,
// point) per level, about 0.9 GB over the four levels at B = 8, against
// 0.3 GB of values and 0.3 GB of output. The value rows of one head's level
// (at most 3.6 MB) stay in the 50 MB L2 while the head's tiles run, so repeat
// row reads are L2 hits. hd_gather: idx + w are 32 bytes per sample and
// corner slot, 1.2 GB at that size, and are read once, coalesced along q; but
// a sample's hd values lie in hd different rows of vt (stride S), so every
// value load is a 32-byte sector of its own: the kernel is bound by L1/L2
// sector traffic and load latency well above its bytes bound. That layout is
// the backend's contract (it is the TPU lane layout); msda_gather_sum in
// msda.cu is the row layout's kernel.
//
// Design.
// - sep. Its first kernel (one warp a query, a lane a
//   channel; per point six warp-wide 4-byte operand loads, then up to four
//   row loads behind `continue`) ran 13x its bytes bound, and neither
//   dependent load chains nor its operand loads were the main cause:
//   tools/sep_probe.py times it with the branches predicated, the operands
//   loaded first, or staged in shared memory, and none of those moves it
//   far. Now one block of 256 threads per (64-query tile, b*h) first copies
//   its tile's operands (6 x P x 64 words, contiguous per operand) with
//   coalesced loads into shared memory, and turns its row of the hit table
//   into one flag per level row (so no division in the inner loop). A
//   thread then takes one query and 4 channels (8 threads cover a 128-byte
//   fp32 row at hd = 32, a warp 4 neighbouring queries) and, for 4 points at
//   a time, issues every (point, corner) row load before any FMA: 16-byte
//   loads (8 bytes for bf16 rows) at constant offsets from the point's
//   corner (0, 0), each predicated on the corner being inside the level, in
//   a band whose bit is set and of non-zero weight, with no branch between
//   them; a corner not loaded is 0 and adds exactly nothing. Each (query,
//   channel) sum keeps the first kernel's order: points, then dy, then dx, with
//   fmaf(wx * v, wy, acc). The sep probe's reading of it: a case with every
//   sample on four L1-resident cells runs nearly as fast as the real op, so
//   what remains is the work inside the SM, not L2. Any hd: channels past
//   hd are neither loaded nor written, and an hd that is not a multiple of 4
//   (or rows not 16-byte aligned) takes scalar loads.
// - hd_gather: one thread per (b*h, query, 8 channels): its idx/w reads are
//   coalesced along q, its 8 channel sums stay in registers, and its writes
//   out[bh, d, q] are coalesced along q. It skips a term whose weight is 0 (a
//   discrete sample's empty corner slots, out-of-range corners), which
//   changes no sum.
// Offsets are 64-bit: at B = 8 one hd_gather launch's idx + w span 1.2 GB.
// wgmma has nothing to multiply here. On an H100 80GB HBM3 at 700 W one
// encoder op at B = 8 takes ~1.6 ms under sep (2.3x its bytes bound; 9.5 ms
// under the first kernel) and ~5.7 ms under hd_gather (10x); PERF.md has the
// runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSepQTile = 64;  // the JAX package's Q_TILE
constexpr int kSepThreads = 256;
constexpr int kSepPointChunk = 4;  // points whose rows a thread loads before it sums them
constexpr int kGatherThreads = 128;
constexpr int kGatherChannels = 8;  // channels a thread of msda_hd_gather_sum sums

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// rounds an fp32 value to T's precision (identity for fp32), so sums "in vt's
// dtype" round where the TPU kernel's bf16 arithmetic rounds
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 channels of one value row into v, as fp32: one 16-byte (fp32) or 8-byte
// (bf16) load when kVec, else one load a channel below hd; zeros where
// `on` is false (nothing is read then).
template <typename T, bool kVec>
__device__ __forceinline__ void load_quad(const T* __restrict__ p, int c, int hd, bool on,
                                          float (&v)[4]);

template <>
__device__ __forceinline__ void load_quad<float, true>(const float* __restrict__ p, int, int,
                                                       bool on, float (&v)[4]) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (on) x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <>
__device__ __forceinline__ void load_quad<__nv_bfloat16, true>(const __nv_bfloat16* __restrict__ p,
                                                               int, int, bool on,
                                                               float (&v)[4]) {
  uint2 x = make_uint2(0u, 0u);
  if (on) x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(x.x << 16);  // bf16 -> fp32: the high half of the word
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

template <typename T, bool kVec>
__device__ __forceinline__ void load_quad(const T* __restrict__ p, int c, int hd, bool on,
                                          float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = on && c + e < hd ? to_float(p[e]) : 0.0f;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kSepThreads)
msda_sep_sum_kernel(const T* __restrict__ rows, const int32_t* __restrict__ xi,
                    const float* __restrict__ xw0, const float* __restrict__ xw1,
                    const int32_t* __restrict__ yi, const float* __restrict__ yw0,
                    const float* __restrict__ yw1, const int32_t* __restrict__ mask,
                    float* __restrict__ out, int n_qt, int n_points, int lh, int lw, int hd,
                    int r_band, int n_bands) {
  // this tile's operands, [operand][point][query], then a flag per level row:
  // its band's bit in the tile's row of the hit table
  extern __shared__ int smem[];
  const int n_ops = n_points * kSepQTile;
  int* s_xi = smem;
  int* s_yi = smem + n_ops;
  float* s_w = reinterpret_cast<float*>(smem + 2 * n_ops);  // xw0, xw1, yw0, yw1
  int* row_on = smem + 6 * n_ops;
  const long long tile_row = (long long)blockIdx.y * n_qt + blockIdx.x;  // bh * n_qt + tile
  const long long op0 = tile_row * n_ops;
  for (int i = threadIdx.x; i < n_ops; i += kSepThreads) {
    s_xi[i] = __ldg(xi + op0 + i);
    s_yi[i] = __ldg(yi + op0 + i);
    s_w[i] = __ldg(xw0 + op0 + i);
    s_w[n_ops + i] = __ldg(xw1 + op0 + i);
    s_w[2 * n_ops + i] = __ldg(yw0 + op0 + i);
    s_w[3 * n_ops + i] = __ldg(yw1 + op0 + i);
  }
  for (int y = threadIdx.x; y < lh; y += kSepThreads) {
    row_on[y] = __ldg(mask + tile_row * n_bands + y / r_band);
  }
  __syncthreads();

  const T* rows_bh = rows + (long long)blockIdx.y * lh * lw * hd;
  float* out_tile = out + tile_row * kSepQTile * hd;
  const int quads = (hd + 3) / 4;
  const int row_stride = lw * hd;
  for (int item = threadIdx.x; item < kSepQTile * quads; item += kSepThreads) {
    const int qi = item / quads;
    const int c = (item % quads) * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p0 = 0; p0 < n_points; p0 += kSepPointChunk) {
      float v[kSepPointChunk][4][4];  // [point][corner 2 dy + dx][channel]
      float wx[kSepPointChunk][2], wy[kSepPointChunk][2];
      // every row load of these points first, each predicated, no branches;
      // a corner not loaded is 0 and its term adds exactly nothing
#pragma unroll
      for (int pp = 0; pp < kSepPointChunk; ++pp) {
        const bool point_on = p0 + pp < n_points;
        const int o = (point_on ? p0 + pp : 0) * kSepQTile + qi;
        const int x0 = s_xi[o];
        const int y0 = s_yi[o];
        wx[pp][0] = s_w[o];
        wx[pp][1] = s_w[n_ops + o];
        wy[pp][0] = s_w[2 * n_ops + o];
        wy[pp][1] = s_w[3 * n_ops + o];
        const T* p = rows_bh + (long long)y0 * row_stride + x0 * hd + c;  // corner (0, 0)
        bool col_on[2];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          col_on[dx] = static_cast<unsigned>(x0 + dx) < static_cast<unsigned>(lw) &&
                       wx[pp][dx] != 0.0f;
        }
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          // outside the level, or in a band the hit table leaves out: the
          // row is not loaded
          const int y = y0 + dy;
          const bool row_in = static_cast<unsigned>(y) < static_cast<unsigned>(lh);
          const bool on_row = point_on && row_in && wy[pp][dy] != 0.0f &&
                              row_on[row_in ? y : 0] != 0;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            load_quad<T, kVec>(p + dy * row_stride + dx * hd, c, hd, on_row && col_on[dx],
                               v[pp][2 * dy + dx]);
          }
        }
      }
      // then the sums, in the order points, dy, dx
#pragma unroll
      for (int pp = 0; pp < kSepPointChunk; ++pp)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[e] = fmaf(__fmul_rn(wx[pp][dx], v[pp][2 * dy + dx][e]), wy[pp][dy], acc[e]);
            }
    }
    float* dst = out_tile + (long long)qi * hd + c;
    if (kVec) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < hd) dst[e] = acc[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
msda_hd_gather_sum_kernel(const T* __restrict__ vt, const int32_t* __restrict__ idx,
                          const float* __restrict__ w, T* __restrict__ out, int hd, int s,
                          int q, int lp, int n_slots) {
  const int qq = blockIdx.x * kGatherThreads + threadIdx.x;
  if (qq >= q) return;
  const int d0 = blockIdx.y * kGatherChannels;
  const long long bh = blockIdx.z;
  const long long n = (long long)lp * q;  // samples per corner slot
  const int32_t* idx_bh = idx + bh * n_slots * n;
  const float* w_bh = w + bh * n_slots * n;
  const T* vt_d = vt + (bh * hd + d0) * (long long)s;

  float total[kGatherChannels];
#pragma unroll
  for (int k = 0; k < kGatherChannels; ++k) total[k] = 0.0f;
  for (int j = 0; j < lp; ++j) {
    float acc[kGatherChannels];
#pragma unroll
    for (int k = 0; k < kGatherChannels; ++k) acc[k] = 0.0f;
    for (int c = 0; c < n_slots; ++c) {
      const long long o = c * n + (long long)j * q + qq;
      const int sk = __ldg(idx_bh + o);
      const float wk = round_to<T>(__ldg(w_bh + o));
      if (sk < 0 || sk >= s || wk == 0.0f) continue;
#pragma unroll
      for (int k = 0; k < kGatherChannels; ++k) {
        if (d0 + k < hd) {
          const float g = to_float(vt_d[k * (long long)s + sk]);
          acc[k] = round_to<T>(__fadd_rn(acc[k], round_to<T>(__fmul_rn(g, wk))));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGatherChannels; ++k) {
      total[k] = round_to<T>(__fadd_rn(total[k], acc[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < kGatherChannels; ++k) {
    if (d0 + k < hd) out[(bh * hd + d0 + k) * (long long)q + qq] = from_float<T>(total[k]);
  }
}

template <typename T>
int launch_sep(const void* rows, const void* xi, const void* xw0, const void* xw1,
               const void* yi, const void* yw0, const void* yw1, const void* mask, void* out,
               int bh_count, int n_qt, int n_points, int lh, int lw, int hd, int r_band,
               int n_bands, void* stream) {
  if (bh_count < 1 || bh_count > 65535 || n_qt < 1 || n_points < 1 || r_band < 1 || hd < 1 ||
      n_bands != (lh + r_band - 1) / r_band) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (6 * (size_t)n_points * kSepQTile + lh);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // vector loads and stores need every row and output quad 16-byte aligned
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(n_qt, bh_count);
  auto kernel = vec ? &msda_sep_sum_kernel<T, true> : &msda_sep_sum_kernel<T, false>;
  kernel<<<grid, kSepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(xi),
      static_cast<const float*>(xw0), static_cast<const float*>(xw1),
      static_cast<const int32_t*>(yi), static_cast<const float*>(yw0),
      static_cast<const float*>(yw1), static_cast<const int32_t*>(mask),
      static_cast<float*>(out), n_qt, n_points, lh, lw, hd, r_band, n_bands);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd_gather(const void* vt, const void* idx, const void* w, void* out, int bh_count,
                     int hd, int s, int q, int lp, int n_slots, void* stream) {
  if (bh_count < 1 || bh_count > 65535 || hd < 1 || q < 1 || lp < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((q + kGatherThreads - 1) / kGatherThreads,
                  (hd + kGatherChannels - 1) / kGatherChannels, bh_count);
  msda_hd_gather_sum_kernel<T><<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vt), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), hd, s, q, lp, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers; the
// stream is the caller's current CUDA stream. Each returns the CUDA error of
// the launch (0 on success). None synchronises or allocates.

extern "C" int msda_sep_sum_f32(const void* rows, const void* xi, const void* xw0,
                                const void* xw1, const void* yi, const void* yw0,
                                const void* yw1, const void* mask, void* out, int bh_count,
                                int n_qt, int n_points, int lh, int lw, int hd, int r_band,
                                int n_bands, void* stream) {
  return launch_sep<float>(rows, xi, xw0, xw1, yi, yw0, yw1, mask, out, bh_count, n_qt,
                           n_points, lh, lw, hd, r_band, n_bands, stream);
}

extern "C" int msda_sep_sum_bf16(const void* rows, const void* xi, const void* xw0,
                                 const void* xw1, const void* yi, const void* yw0,
                                 const void* yw1, const void* mask, void* out, int bh_count,
                                 int n_qt, int n_points, int lh, int lw, int hd, int r_band,
                                 int n_bands, void* stream) {
  return launch_sep<__nv_bfloat16>(rows, xi, xw0, xw1, yi, yw0, yw1, mask, out, bh_count, n_qt,
                                   n_points, lh, lw, hd, r_band, n_bands, stream);
}

extern "C" int msda_hd_gather_sum_f32(const void* vt, const void* idx, const void* w, void* out,
                                      int bh_count, int hd, int s, int q, int lp, int n_slots,
                                      void* stream) {
  return launch_hd_gather<float>(vt, idx, w, out, bh_count, hd, s, q, lp, n_slots, stream);
}

extern "C" int msda_hd_gather_sum_bf16(const void* vt, const void* idx, const void* w,
                                       void* out, int bh_count, int hd, int s, int q, int lp,
                                       int n_slots, void* stream) {
  return launch_hd_gather<__nv_bfloat16>(vt, idx, w, out, bh_count, hd, s, q, lp, n_slots,
                                         stream);
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
