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
// Design, first and simple.
// - sep: one block per (64-query tile, b*h), 8 warps of 8 queries each; the
//   tile's row of the hit table in shared memory; the 32 lanes over hd (hd =
//   32: one lane per channel, so each corner is one coalesced 128-byte row
//   read). Each point's six operands are broadcast loads, shared by the
//   warp's lanes.
// - hd_gather: one thread per (b*h, query, 8 channels): its idx/w reads are
//   coalesced along q, its 8 channel sums stay in registers, and its writes
//   out[bh, d, q] are coalesced along q.
// Both skip a term whose weight is 0 (a discrete sample's empty corner slots,
// out-of-range corners), which changes no sum. Offsets are 64-bit: at B = 8
// one hd_gather launch's idx + w span 1.2 GB. wgmma has nothing to multiply
// here. On an H100 80GB HBM3 at 700 W one encoder op at B = 8 takes ~9.5 ms
// (sep, 13x its bytes bound: each warp walks its queries and points one
// dependent load chain at a time, so latency bounds it) and ~5.7 ms
// (hd_gather, 10x); loading all of a query's operands at once, more rows in
// flight, and a head's level staged in shared memory are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSepQTile = 64;  // the JAX package's Q_TILE
constexpr int kSepWarps = 8;
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

template <typename T>
__global__ void __launch_bounds__(kSepWarps * 32)
msda_sep_sum_kernel(const T* __restrict__ rows, const int32_t* __restrict__ xi,
                    const float* __restrict__ xw0, const float* __restrict__ xw1,
                    const int32_t* __restrict__ yi, const float* __restrict__ yw0,
                    const float* __restrict__ yw1, const int32_t* __restrict__ mask,
                    float* __restrict__ out, int n_qt, int n_points, int lh, int lw, int hd,
                    int r_band, int n_bands) {
  extern __shared__ int band_on[];  // this tile's row of the hit table
  const long long tile_row = (long long)blockIdx.y * n_qt + blockIdx.x;  // bh * n_qt + tile
  for (int i = threadIdx.x; i < n_bands; i += blockDim.x) {
    band_on[i] = __ldg(mask + tile_row * n_bands + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rows_bh = rows + (long long)blockIdx.y * lh * lw * hd;
  const long long op_tile = tile_row * n_points * kSepQTile;
  for (int qi = warp; qi < kSepQTile; qi += kSepWarps) {
    float* out_q = out + (tile_row * kSepQTile + qi) * hd;
    for (int c0 = 0; c0 < hd; c0 += 32) {
      const int c = c0 + lane;
      const bool lane_on = c < hd;
      float acc = 0.0f;
      for (int p = 0; p < n_points; ++p) {
        const long long o = op_tile + (long long)p * kSepQTile + qi;
        const int x0 = __ldg(xi + o);
        const int y0 = __ldg(yi + o);
        const float wx[2] = {__ldg(xw0 + o), __ldg(xw1 + o)};
        const float wy[2] = {__ldg(yw0 + o), __ldg(yw1 + o)};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int y = y0 + dy;
          // outside the level, or in a band the hit table leaves out: the
          // row is not loaded
          if (y < 0 || y >= lh || wy[dy] == 0.0f || band_on[y / r_band] == 0) continue;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int x = x0 + dx;
            if (x < 0 || x >= lw || wx[dx] == 0.0f || !lane_on) continue;
            const float v = to_float(rows_bh[((long long)y * lw + x) * hd + c]);
            acc = fmaf(__fmul_rn(wx[dx], v), wy[dy], acc);
          }
        }
      }
      if (lane_on) out_q[c] = acc;
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
  if (bh_count < 1 || bh_count > 65535 || n_qt < 1 || n_points < 1 || r_band < 1 ||
      n_bands != (lh + r_band - 1) / r_band) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (size_t)n_bands;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_qt, bh_count);
  msda_sep_sum_kernel<T><<<grid, kSepWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
