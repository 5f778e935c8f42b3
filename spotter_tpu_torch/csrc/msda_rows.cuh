// Value-row loads and stores shared by the MSDA kernels whose threads each
// take one query and 4 channels (msda_sep_sum, msda_hd_gather_sum,
// msda_fused_sum): 4 channels of a row move as one 16-byte (fp32) or 8-byte
// (bf16) access when kVec (hd % 4 == 0 and the rows aligned to it), else as
// one access a channel below hd.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda_rows {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// rounds an fp32 value to T's precision (identity for fp32), so sums "in the
// value's dtype" round where the TPU kernel's bf16 arithmetic rounds
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 channels of one value row into v, as fp32; zeros where `on` is false
// (nothing is read then). The vector forms are predicated loads, so a caller
// can issue many of them with no branch between.
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

// 4 channels v (already in T's precision) to p: one 16-byte (fp32) or 8-byte
// (bf16) store when kVec, else one store a channel below hd
template <bool kVec>
__device__ __forceinline__ void store_quad(float* __restrict__ p, int c, int hd,
                                           const float (&v)[4]) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < hd) p[e] = v[e];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_quad(__nv_bfloat16* __restrict__ p, int c, int hd,
                                           const float (&v)[4]) {
  if (kVec) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
                        (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16;
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2])) |
                        (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[3])) << 16;
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < hd) p[e] = __float2bfloat16_rn(v[e]);
    }
  }
}

}  // namespace msda_rows
