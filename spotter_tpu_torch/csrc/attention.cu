// Self-attention forward over the whole unmasked sequence (flash attention):
//
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :]) * v[b, j, h, :]
//
// with q pre-scaled by hd^-0.5, read and written in the JAX layout
// (B, S, H, hd). It replaces both TPU kernels of the ViT towers:
// spotter_tpu/models/layers.py::flash_self_attention (Pallas
// flash_attention, fp32 tensors) and ::_splash_self_attention (Pallas splash,
// bf16 tensors). The two compute the same function and differ in their TPU
// block schedules; here they are two kernels, flash_attn_fp32 and
// flash_attn_bf16, because the bf16 one runs on the tensor cores.
//
// The TPU kernels pad S to their block size (512 or 768) and isolate the pad
// with segment ids. Nothing is padded here: keys >= S in the last key tile get
// a score of -inf (their rows arrive as zeros, so no garbage meets a zero
// weight), and query rows >= S are computed from zeros and never written.
//
// What bounds them on an H100: operations. At yolos-base (B = 8, S = 4301,
// H = 12, hd = 64) one launch does 4*B*H*S^2*hd = 455 GFLOP on 423 MB (fp32)
// of q, k, v and output.
//
// flash_attn_fp32, on CUDA cores in fp32 (455 GFLOP at 67 TFLOP/s: 6.8 ms):
// one block of 256 threads per (query tile of 64 rows, head, batch) walks the
// key tiles of 64 in order; q, k and v tiles are staged in shared memory;
// each thread owns a 4 x 4 block of scores (rows ty*4 + i, keys tx + 16*j)
// and a 4 x hd/16 block of the output (columns tx*4 + 64*g + c), and the
// softmax is online: the running row max and the thread's partial row sum
// stay in fp32 registers, the max is reduced over the 16 lanes that share a
// row with shuffles, and the probabilities pass through shared memory to the
// P.V product. Row strides of the staged tiles are padded by 4 floats so the
// 16-byte shared loads of a warp hit distinct banks.
//
// flash_attn_bf16, on the tensor cores (wgmma) with TMA loads. Two limits
// meet at hd = 64: the products (455 GFLOP at 989 TFLOP/s: 0.460 ms) and the
// softmax's exponentials, B*H*S^2 = 1.78 G of them at 16 MUFU.EX2 a clock an
// SM (132 SMs at 1.98 GHz): 0.425 ms, 92 % of the first. So a kernel that
// does not overlap one warpgroup's softmax with another's products cannot go
// below ~0.9 ms. A block owns 64 query rows of one (b, h) per consumer
// warpgroup (three at hd = 64, two at hd = 128) and one producer warp:
//
// - the producer, one thread of which issues TMA loads: the Q tile once,
//   then K and V tiles of 64 keys into a ring of 4 stages, each with a full
//   barrier for K, one for V, and an empty barrier that every consumer warp
//   releases; the tensor maps are 4-D (hd, H, S, B) over the caller's
//   strides, 128-byte swizzled, and zero-fill rows past S;
// - consumers of 64 query rows each. Per key tile, S = Q.K^T is wgmma
//   m64n64k16 from shared memory (K rows are hd-contiguous: K-major as they
//   arrive); the softmax is online in fp32 registers over the accumulator
//   fragment, with exp2 of (s - m) * log2(e) (one FFMA and one MUFU.EX2 a
//   score) and the row max and sum reduced over the 4 lanes of a quad; then
//   O += P.V is wgmma m64n64k16 with P from registers and V from shared
//   memory through the transpose bit (V is hd-contiguous, MN-major). P.V of
//   tile j is issued with Q.K^T of tile j + 1, in one commit group;
// - the consumers take turns at the tensor cores (named barriers 1, 2, ...,
//   round robin): one issues its products while the others compute their
//   exponentials, so the MUFU and tensor-core limits overlap instead of
//   adding up.
//
// The consumer's loop issues its wgmmas on a path without branches (the
// first and last tiles are peeled off), or ptxas serialises them. Measured
// slower on the H100 and not kept: a consumer's softmax overlapping its own
// P.V (a second commit group), larger key tiles with fewer consumers, and
// the loads issued by a consumer thread instead of a producer warp.
//
// Numerics: P in bf16 alone (8 significant bits) moves the output by up to
// ~2^-8 of its largest value at YOLOS's shapes, so P is split into two bf16
// terms, P = P_hi + P_lo (P_lo the rounding residue, ~2^-17 relative), and
// P.V is two wgmmas: 1.5x the tensor work (0.69 ms at hd = 64), for an output
// that differs from fp32 arithmetic by about one rounding of the output.
// The row sums use the fp32 P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 (tx) x 16 (ty)
constexpr int kPad = 4;        // floats added to each staged row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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


namespace tc {  // flash_attn_bf16: the tensor-core kernel

using namespace hopper;

constexpr int kTurnBarrier = 1;  // named barriers 1, 2, ...: consumer 0's, 1's, ... turn
constexpr float kLog2e = 1.4426950408889634f;

// The shape of a block at head width HD: kConsumers warpgroups of 64 query
// rows and one producer warp after them; kBN keys a tile (64: Q.K^T is one
// m64n64k16 wgmma per 16 columns of hd). A consumer keeps the scores
// (kBN / 2 registers), P as two bf16 terms (kBN / 2) and the output
// (HD / 2) live together while the products run, within what a scheduler's
// 16 K registers leave each of its warps (the 13 warps of three consumers
// and the producer put 4 on one: 128 a thread; 9 warps: 168).
// Three consumers at hd = 64 let two softmaxes run while one consumer's
// products do; at hd = 128 the output alone takes 64 registers, so two.
template <int HD>
struct Config {
  static constexpr int kChunks = HD / 64;  // 64-column chunks of a row
  static constexpr int kConsumers = HD == 64 ? 3 : 2;
  static constexpr int kBN = 64;
  static constexpr int kStages = 4;
  static constexpr int kBM = 64 * kConsumers;  // query rows a block
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
};

// Shared memory, each tile [64-column chunk][rows][64] bf16 as TMA writes it
// (128-byte rows in 8-row groups, so every tile starts 1024-byte aligned).
template <int HD>
struct alignas(1024) Smem {
  using C = Config<HD>;
  static constexpr int kChunks = C::kChunks;
  static constexpr int kBN = C::kBN;
  static constexpr int kStages = C::kStages;
  __nv_bfloat16 q[kChunks][C::kBM * 64];
  __nv_bfloat16 k[kStages][kChunks][kBN * 64];
  __nv_bfloat16 v[kStages][kChunks][kBN * 64];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];  // every consumer warp is done with the stage's K and V
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) -> bf16x2 hi = round(x, y) and lo = round of the residue.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  memcpy(&hi, &h, sizeof(hi));
  memcpy(&lo, &l, sizeof(lo));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  uint32_t r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

template <int HD>
__global__ void __launch_bounds__(Config<HD>::kThreads, 1)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out, int s, int h_count) {
  using S = Smem<HD>;
  constexpr int kChunks = S::kChunks;
  constexpr int kBN = S::kBN;
  constexpr int kStages = S::kStages;
  constexpr int kConsumers = Config<HD>::kConsumers;
  constexpr int kConsumerThreads = Config<HD>::kConsumerThreads;
  constexpr int kGroups = kBN / 8;  // 8-key column groups of the score fragment
  extern __shared__ char smem_raw[];
  S& sm = *reinterpret_cast<S*>(align_1024(smem_raw));

  // warp-uniform as far as the compiler can see, so the roles' paths are not
  // divergent; warpgroups 0 .. kConsumers - 1 consume, the warp after them loads
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int q0 = blockIdx.x * Config<HD>::kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (s + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == kConsumers) {  // producer
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q));
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.q[c], &q_map, &sm.q_full, 64 * c, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], sizeof(sm.k[0]));
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm.k[st][c], &k_map, &sm.k_full[st], 64 * c, h, j * kBN, b);
        }
        mbar_expect_tx(&sm.v_full[st], sizeof(sm.v[0]));
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm.v[st][c], &v_map, &sm.v_full[st], 64 * c, h, j * kBN, b);
        }
      }
    }
    return;
  }

  // consumer cw owns query rows q0 + 64 * cw .. + 63; within it, warp w rows
  // 16 w .. 16 w + 15, and lane (g = lane / 4, t = lane % 4) rows g and g + 8
  // of those, columns 8 i + 2 t and + 1 of each 8-column group i
  const int cw = warpgroup;
  const int tid = threadIdx.x - 128 * warpgroup;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  // a turn passes from consumer cw to cw + 1 (mod kConsumers); each barrier
  // joins the waiting consumer and the one handing it the turn
  const int my_turn = kTurnBarrier + cw;
  const int next_turn = kTurnBarrier + (cw + 1) % kConsumers;
  if (cw == kConsumers - 1) named_bar_arrive(kTurnBarrier, 256);  // consumer 0 goes first

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float sc[kBN / 2];  // scores of the current tile, then their exponentials
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.0f;
  uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];  // P of the previous tile, wgmma A fragments
  float m_run[2] = {-INFINITY, -INFINITY};         // rows g, g + 8: running max
  float l_run[2] = {0.0f, 0.0f};                   // this thread's share of the row sums

  mbar_wait(&sm.q_full, 0);
  uint64_t q_desc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) q_desc[c] = sw128_desc(&sm.q[c][cw * 64 * 64], 16);

  // The steps of a tile, each inlined where it is used, so the loop below
  // issues its wgmmas on a path without branches.
  auto issue_s = [&](int j) {  // S = Q . K^T of tile j, into sc
    const int st = j % kStages;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint64_t k_desc = sw128_desc(sm.k[st][c], 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 columns of hd a step: 32 bytes
        wgmma_m64n64k16_bf16_ss(sc, q_desc[c] + 2 * kk, k_desc + 2 * kk, (c | kk) != 0);
      }
    }
  };
  auto issue_pv = [&](int j) {  // O += (P_hi + P_lo) . V of tile j
    const int st = j % kStages;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {  // 16 keys a step: 2048 bytes
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t v_desc = sw128_desc(sm.v[st][c], kBN * 128) + 128 * kk;
        wgmma_m64n64k16_bf16_rs_tn(o[c], p_hi[kk], v_desc);
        wgmma_m64n64k16_bf16_rs_tn(o[c], p_lo[kk], v_desc);
      }
    }
  };
  // The online softmax of tile j's scores (complete in sc): sc becomes
  // exp(s - m), m and l move on, and alpha is the factor by which the output
  // accumulated so far must shrink.
  auto softmax = [&](int j, float (&alpha)[2]) {
    fence_operands(sc);
    const int k0 = j * kBN;
    if (k0 + kBN > s) {  // keys past the sequence take no weight; key k0 is real
#pragma unroll
      for (int i = 0; i < kGroups; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * i + 2 * t + (e & 1) >= s) sc[4 * i + e] = -INFINITY;
        }
    }
    float mx[2], mb[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part[kGroups];  // the row's max as a tree, not a chain of kBN / 4
#pragma unroll
      for (int i = 0; i < kGroups; ++i) part[i] = fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
#pragma unroll
      for (int stride = 1; stride < kGroups; stride *= 2)
#pragma unroll
        for (int i = 0; i + stride < kGroups; i += 2 * stride) {
          part[i] = fmaxf(part[i], part[i + stride]);
        }
      mx[r] = fmaxf(m_run[r], part[0]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_run[r] - mx[r]) * kLog2e);  // 0 on the first tile (m = -inf)
      m_run[r] = mx[r];
      mb[r] = mx[r] * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * i + e] = ex2(fmaf(sc[4 * i + e], kLog2e, -mb[e >> 1]));
        rs[e >> 1] += sc[4 * i + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
  };
  // Once the previous P.V is done: the output shrinks by alpha, and P of this
  // tile becomes the A fragments of the next P.V. A fragment of 16 keys kk
  // holds {row g, keys 2t, 2t + 1}, {row g + 8, same}, {row g, keys 8 + 2t,
  // + 1}, {row g + 8, same}: score groups 2 kk and 2 kk + 1.
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      fence_operands(o[c]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      fence_operands(p_hi[kk]);
      fence_operands(p_lo[kk]);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int base = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
        split_bf16x2(sc[base], sc[base + 1], p_hi[kk][f], p_lo[kk][f]);
      }
    }
  };

  // Each block of wgmmas is issued in this consumer's turn (named barrier
  // 1 + cw), which it then hands to the other: tile 0's Q.K^T alone, then
  // Q.K^T of tile j with P.V of tile j - 1, then the last P.V. The first and
  // last blocks are peeled off the loop, so no wgmma is issued under a
  // branch (ptxas serialises those). The softmax of tile j waits for the
  // whole block (P.V's registers are rescaled right after it), so the two
  // consumers' turns are what keep the tensor cores busy.
  float alpha[2];
  mbar_wait(&sm.k_full[0], 0);
  named_bar_sync(my_turn, 256);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  named_bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  softmax(0, alpha);
  rescale_and_pack(alpha);
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(&sm.k_full[j % kStages], (j / kStages) & 1);
    mbar_wait(&sm.v_full[(j - 1) % kStages], ((j - 1) / kStages) & 1);
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_commit();
    named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    mbar_arrive_per_warp(&sm.empty[(j - 1) % kStages]);  // this warp is done with j - 1
    softmax(j, alpha);
    rescale_and_pack(alpha);
  }
  mbar_wait(&sm.v_full[(n_tiles - 1) % kStages], ((n_tiles - 1) / kStages) & 1);
  named_bar_sync(my_turn, 256);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_commit();
  named_bar_arrive(next_turn, 256);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fence_operands(o[c]);
  if (cw == 0) named_bar_sync(kTurnBarrier, 256);  // the last consumer's last hand-over

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * cw + 16 * warp + g + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* dst = out + ((static_cast<long long>(b) * s + row) * h_count + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * i) =
            pack_bf16x2(o[c][4 * i + 2 * r] * inv[r], o[c][4 * i + 2 * r + 1] * inv[r]);
      }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b_count, int s,
              int h_count, const long long* st, void* stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    // dims innermost first (hd, H, S, B); strides of H, S, B in bytes
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(h_count),
                                static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b_count)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[3 * i + 2]) * 2,
                                   static_cast<cuuint64_t>(st[3 * i + 1]) * 2,
                                   static_cast<cuuint64_t>(st[3 * i]) * 2};
    const cuuint32_t rows = i == 0 ? Config<HD>::kBM : Config<HD>::kBN;  // q, or k and v
    const cuuint32_t box[4] = {64, 1, rows, 1};
    const int err = encode_tiled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, bases[i], dims,
                                 strides, box);
    if (err != 0) return err;
  }
  constexpr size_t smem = sizeof(Smem<HD>) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBM = Config<HD>::kBM;
  const dim3 grid((s + kBM - 1) / kBM, h_count, b_count);
  flash_attn_bf16_kernel<HD><<<grid, Config<HD>::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), s, h_count);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, int b_count, int s,
           int h_count, int hd, const long long* st, void* stream) {
  if (b_count < 1 || s < 1 || h_count < 1 || h_count > 65535 || b_count > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 64) return launch_hd<64>(q, k, v, out, b_count, s, h_count, st, stream);
  if (hd == 128) return launch_hd<128>(q, k, v, out, b_count, s, h_count, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// Plain C interface, loaded with ctypes. q, k, v are (B, S, H, hd) device
// arrays with unit stride over hd and the given element strides over b, s
// and h; out is a contiguous (B, S, H, hd) array of the same type. hd is 64
// or 128. fp32: strides multiples of 4, pointers 16-byte aligned. bf16 (TMA):
// strides multiples of 8 (16 bytes), pointers 16-byte aligned. The stream is
// the caller's current CUDA stream. Each returns the error of the launch or
// of its tensor maps (0 on success); none synchronises or allocates.
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
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return tc::launch(q, k, v, out, b_count, s, h_count, hd, st, stream);
}

extern "C" const char* attention_error_string(int code) { return hopper::error_string(code); }
