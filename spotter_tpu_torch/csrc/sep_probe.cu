// A probe of what held the first msda_sep_sum kernel back: that kernel (one
// warp a query, its 32 lanes over hd = 32 channels; per point six broadcast
// operand loads, then up to four row loads behind `continue` branches) and
// three variants of it, fp32 rows only, each computing the same sums in the
// same order:
//
//   variant 0: the warp-per-query kernel as it was;
//   variant 1: the branches become predicated loads (a corner that is not
//              read loads nothing and adds nothing), so the compiler may
//              issue a point's four row loads together;
//   variant 2: all points' operands are loaded before any row (n_points <= 4);
//   variant 3: both;
//   variant 4: its loop with the tile's operands staged in shared memory
//              first, by coalesced loads, as the redesigned kernel stages them.
//
// If the time falls with 1 and 2, the kernel waited on dependent load chains
// (latency); if it falls with 4 alone, on its operand loads: six warp-wide
// 4-byte loads a (query, point), next to at most four 128-byte row loads.
// tools/sep_probe.py times them beside the redesigned kernel
// (csrc/msda_backends.cu) at the Deformable-DETR encoder's op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 64;
constexpr int kWarps = 8;
constexpr int kMaxPoints = 4;

// acc += one point's corner terms, in the order dy, dx
template <bool kPredicated>
__device__ __forceinline__ float sum_point(const float* __restrict__ rows_bh,
                                           const int* __restrict__ band_on, int x0, int y0,
                                           const float (&wx)[2], const float (&wy)[2], int c,
                                           bool lane_on, int lh, int lw, int hd, int r_band,
                                           float acc) {
  if (kPredicated) {
    float v[4];
    bool on[4];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = y0 + dy;
      bool row_on = y >= 0 && y < lh && wy[dy] != 0.0f;
      row_on = row_on && band_on[row_on ? y / r_band : 0] != 0;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = x0 + dx;
        const bool corner_on = row_on && x >= 0 && x < lw && wx[dx] != 0.0f && lane_on;
        on[2 * dy + dx] = corner_on;
        const long long cell = corner_on ? (long long)y * lw + x : 0;
        v[2 * dy + dx] = corner_on ? __ldg(rows_bh + cell * hd + c) : 0.0f;
      }
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float term = fmaf(__fmul_rn(wx[dx], v[2 * dy + dx]), wy[dy], acc);
        acc = on[2 * dy + dx] ? term : acc;
      }
    return acc;
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int y = y0 + dy;
    if (y < 0 || y >= lh || wy[dy] == 0.0f || band_on[y / r_band] == 0) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int x = x0 + dx;
      if (x < 0 || x >= lw || wx[dx] == 0.0f || !lane_on) continue;
      const float v = __ldg(rows_bh + ((long long)y * lw + x) * hd + c);
      acc = fmaf(__fmul_rn(wx[dx], v), wy[dy], acc);
    }
  }
  return acc;
}

template <bool kPredicated, bool kOperandsFirst, bool kSharedOperands>
__global__ void __launch_bounds__(kWarps * 32)
sep_variant_kernel(const float* __restrict__ rows, const int32_t* __restrict__ xi,
                   const float* __restrict__ xw0, const float* __restrict__ xw1,
                   const int32_t* __restrict__ yi, const float* __restrict__ yw0,
                   const float* __restrict__ yw1, const int32_t* __restrict__ mask,
                   float* __restrict__ out, int n_qt, int n_points, int lh, int lw, int hd,
                   int r_band, int n_bands) {
  extern __shared__ int smem[];  // the hit-table row, then (variant 4) the operands
  int* band_on = smem;
  const long long tile_row = (long long)blockIdx.y * n_qt + blockIdx.x;
  for (int i = threadIdx.x; i < n_bands; i += blockDim.x) {
    band_on[i] = __ldg(mask + tile_row * n_bands + i);
  }
  const long long op_tile = tile_row * n_points * kQTile;
  if (kSharedOperands) {  // [operand][point][query], like the redesigned kernel
    const int n_ops = n_points * kQTile;
    int* ops = smem + n_bands;
    for (int i = threadIdx.x; i < n_ops; i += blockDim.x) {
      ops[i] = __ldg(xi + op_tile + i);
      ops[n_ops + i] = __ldg(yi + op_tile + i);
      ops[2 * n_ops + i] = __float_as_int(__ldg(xw0 + op_tile + i));
      ops[3 * n_ops + i] = __float_as_int(__ldg(xw1 + op_tile + i));
      ops[4 * n_ops + i] = __float_as_int(__ldg(yw0 + op_tile + i));
      ops[5 * n_ops + i] = __float_as_int(__ldg(yw1 + op_tile + i));
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* rows_bh = rows + (long long)blockIdx.y * lh * lw * hd;
  for (int qi = warp; qi < kQTile; qi += kWarps) {
    float* out_q = out + (tile_row * kQTile + qi) * hd;
    for (int c0 = 0; c0 < hd; c0 += 32) {
      const int c = c0 + lane;
      const bool lane_on = c < hd;
      float acc = 0.0f;
      if (kOperandsFirst) {  // every point's six operands, then the rows
        int x0[kMaxPoints], y0[kMaxPoints];
        float wx[kMaxPoints][2], wy[kMaxPoints][2];
#pragma unroll
        for (int p = 0; p < kMaxPoints; ++p) {
          const long long o = op_tile + (long long)(p < n_points ? p : 0) * kQTile + qi;
          x0[p] = __ldg(xi + o);
          y0[p] = __ldg(yi + o);
          wx[p][0] = __ldg(xw0 + o);
          wx[p][1] = __ldg(xw1 + o);
          wy[p][0] = __ldg(yw0 + o);
          wy[p][1] = __ldg(yw1 + o);
        }
#pragma unroll
        for (int p = 0; p < kMaxPoints; ++p) {
          if (p < n_points) {
            acc = sum_point<kPredicated>(rows_bh, band_on, x0[p], y0[p], wx[p], wy[p], c,
                                         lane_on, lh, lw, hd, r_band, acc);
          }
        }
      } else if (kSharedOperands) {  // the first loop, the operands from shared memory
        const int n_ops = n_points * kQTile;
        const int* ops = smem + n_bands;
        for (int p = 0; p < n_points; ++p) {
          const int o = p * kQTile + qi;
          const float wx[2] = {__int_as_float(ops[2 * n_ops + o]),
                               __int_as_float(ops[3 * n_ops + o])};
          const float wy[2] = {__int_as_float(ops[4 * n_ops + o]),
                               __int_as_float(ops[5 * n_ops + o])};
          acc = sum_point<kPredicated>(rows_bh, band_on, ops[o], ops[n_ops + o], wx, wy, c,
                                       lane_on, lh, lw, hd, r_band, acc);
        }
      } else {  // the first loop: a point's operands, then its rows
        for (int p = 0; p < n_points; ++p) {
          const long long o = op_tile + (long long)p * kQTile + qi;
          const int x0 = __ldg(xi + o);
          const int y0 = __ldg(yi + o);
          const float wx[2] = {__ldg(xw0 + o), __ldg(xw1 + o)};
          const float wy[2] = {__ldg(yw0 + o), __ldg(yw1 + o)};
          acc = sum_point<kPredicated>(rows_bh, band_on, x0, y0, wx, wy, c, lane_on, lh, lw,
                                       hd, r_band, acc);
        }
      }
      if (lane_on) out_q[c] = acc;
    }
  }
}

template <bool kPredicated, bool kOperandsFirst, bool kSharedOperands = false>
int launch(const void* rows, const void* xi, const void* xw0, const void* xw1, const void* yi,
           const void* yw0, const void* yw1, const void* mask, void* out, int bh_count, int n_qt,
           int n_points, int lh, int lw, int hd, int r_band, int n_bands, void* stream) {
  const dim3 grid(n_qt, bh_count);
  const size_t smem = sizeof(int) * (n_bands + (kSharedOperands ? 6 * n_points * kQTile : 0));
  sep_variant_kernel<kPredicated, kOperandsFirst, kSharedOperands>
      <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rows), static_cast<const int32_t*>(xi),
          static_cast<const float*>(xw0), static_cast<const float*>(xw1),
          static_cast<const int32_t*>(yi), static_cast<const float*>(yw0),
          static_cast<const float*>(yw1), static_cast<const int32_t*>(mask),
          static_cast<float*>(out), n_qt, n_points, lh, lw, hd, r_band, n_bands);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: msda_sep_sum_f32's arguments and a
// variant (0-4, above). Returns the CUDA error of the launch (0 on success).
extern "C" int sep_probe_f32(const void* rows, const void* xi, const void* xw0, const void* xw1,
                             const void* yi, const void* yw0, const void* yw1, const void* mask,
                             void* out, int bh_count, int n_qt, int n_points, int lh, int lw,
                             int hd, int r_band, int n_bands, int variant, void* stream) {
  if (bh_count < 1 || bh_count > 65535 || n_qt < 1 || n_points < 1 || n_points > kMaxPoints ||
      r_band < 1 || n_bands != (lh + r_band - 1) / r_band || n_bands > 4 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                        const void*, const void*, const void*, void*, int, int, int, int, int,
                        int, int, int, void*);
  const Launch launches[5] = {&launch<false, false>, &launch<true, false>, &launch<false, true>,
                              &launch<true, true>, &launch<false, false, true>};
  const Launch fn = variant >= 0 && variant < 5 ? launches[variant] : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(rows, xi, xw0, xw1, yi, yw0, yw1, mask, out, bh_count, n_qt, n_points, lh, lw, hd,
            r_band, n_bands, stream);
}

extern "C" const char* sep_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
