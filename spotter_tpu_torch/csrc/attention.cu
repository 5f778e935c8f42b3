// Self-attention forward over the whole unmasked sequence (flash attention):
//
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :]) * v[b, j, h, :]
//
// with q pre-scaled by hd^-0.5, read and written in the JAX layout
// (B, S, H, hd). It replaces both TPU kernels of the ViT towers:
// spotter_tpu/models/layers.py::flash_self_attention (Pallas
// flash_attention, fp32 tensors) and ::_splash_self_attention (Pallas splash,
// bf16 tensors). The two compute the same function and differ only in their
// TPU block schedules, so here they are one kernel with two instantiations:
// flash_attn_fp32 and flash_attn_bf16. The bf16 one loads bf16, computes in
// fp32 and writes bf16.
//
// The TPU kernels pad S to their block size (512 or 768) and isolate the pad
// with segment ids. Nothing is padded here: keys >= S in the last key tile get
// a score of -inf (their rows are staged as zeros, so no garbage meets a zero
// weight), and query rows >= S are computed from zeros and never written.
//
// What bounds it on an H100: operations. At yolos-base (B = 8, S = 4301,
// H = 12, hd = 64) one launch does 4*B*H*S^2*hd = 455 GFLOP on 423 MB of q, k,
// v and output. The first design is simple, on CUDA cores in fp32 for both
// types: one block of 256 threads per (query tile of 64 rows, head, batch)
// walks the key tiles of 64 in order; q, k and v tiles are staged in shared
// memory as fp32; each thread owns a 4 x 4 block of scores (rows ty*4 + i,
// keys tx + 16*j) and a 4 x hd/16 block of the output (columns tx*4 + 64*g
// + c), and the softmax is online: the running row max and the thread's
// partial row sum stay in fp32 registers, the max is reduced over the 16
// lanes that share a row with shuffles, and the probabilities pass through
// shared memory to the P.V product. Row strides of the staged tiles are padded
// by 4 floats so the 16-byte shared loads of a warp hit distinct banks. wgmma,
// TMA and warp specialisation (the tensor-core rate the bf16 path needs) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 (tx) x 16 (ty)
constexpr int kPad = 4;        // floats added to each staged row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float component(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Rows [s0, s0 + rows) of one (b, h) slice into `dst` (fp32, row stride
// HD + kPad); rows at or past `s` are zeros. Consecutive threads take
// consecutive 4-element chunks of a row: coalesced reads, conflict-free writes.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base, long long stride_s, int s0,
                                           int s, int rows, float* __restrict__ dst) {
  constexpr int kChunks = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s0 + r < s) v = load4(base + (long long)(s0 + r) * stride_s + c);
    store4(dst + r * (HD + kPad) + c, v);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (HD + kPad) + kBQ * (kBK + kPad));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int s, int h_count, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
                  long long vss, long long vsh) {
  constexpr int kLd = HD + kPad;    // row stride of the staged q, k, v tiles
  constexpr int kPLd = kBK + kPad;  // row stride of the probability tile
  constexpr int kGroups = HD / 64;  // 4-column output groups per thread: 1 or 2
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kLd
  float* ks = qs + kBQ * kLd;                   // kBK x kLd
  float* vs = ks + kBK * kLd;                   // kBK x kLd
  float* ps = vs + kBK * kLd;                   // kBQ x kPLd

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* k_bh = k + (long long)b * ksb + (long long)h * ksh;
  const T* v_bh = v + (long long)b * vsb + (long long)h * vsh;

  stage_rows<T, HD>(q + (long long)b * qsb + (long long)h * qsh, qss, q0, s, kBQ, qs);

  float m[4], l[4], o[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < s; k0 += kBK) {
    __syncthreads();  // the last tile's k, v and p reads are done
    stage_rows<T, HD>(k_bh, kss, k0, s, kBK, ks);
    stage_rows<T, HD>(v_bh, vss, k0, s, kBK, vs);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fma4(qv[i], kv[j], sc[i][j]);
    }

    // keys past the sequence (last tile only) take no weight; key k0 is
    // always real, so every row's tile max is finite
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      m[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's keys only; summed over lanes at the end
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kPLd + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPLd + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c0 + cc) * kLd + tx * 4;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = component(pv[i], cc);
            o[i][4 * g + 0] = fmaf(p, vv.x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vv.y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vv.z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vv.w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty * 4 + i;
    if (row < s) {
      const float inv = 1.0f / lt;
      T* out_row = out + (((long long)b * s + row) * h_count + h) * HD + tx * 4;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        store4(out_row + 64 * g, make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
                                             o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv));
      }
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b_count, int s,
              int h_count, const long long* st, void* stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, h_count, b_count);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, h_count, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b_count, int s,
           int h_count, int hd, long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss, long long vsh,
           void* stream) {
  if (b_count < 1 || s < 1 || h_count < 1 || h_count > 65535 || b_count > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  if (hd == 64) return launch_hd<T, 64>(q, k, v, out, b_count, s, h_count, st, stream);
  if (hd == 128) return launch_hd<T, 128>(q, k, v, out, b_count, s, h_count, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. q, k, v are (B, S, H, hd) device
// arrays with unit stride over hd and the given element strides over b, s
// and h (each a multiple of 4, pointers 16-byte aligned for fp32 and 8-byte
// for bf16); out is a contiguous (B, S, H, hd) array of the same type. hd is
// 64 or 128. The stream is the caller's current CUDA stream. Each returns the
// CUDA error of the launch (0 on success); none synchronises or allocates.
extern "C" int flash_attn_fp32(const void* q, const void* k, const void* v, void* out,
                               int b_count, int s, int h_count, int hd, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               void* stream) {
  return launch<float>(q, k, v, out, b_count, s, h_count, hd, qsb, qss, qsh, ksb, kss, ksh, vsb,
                       vss, vsh, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v, void* out,
                               int b_count, int s, int h_count, int hd, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b_count, s, h_count, hd, qsb, qss, qsh, ksb, kss,
                               ksh, vsb, vss, vsh, stream);
}

extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
