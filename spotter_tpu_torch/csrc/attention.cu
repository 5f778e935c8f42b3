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
// flash_attn_bf16, both on the tensor cores (wgmma fed by TMA).
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
// flash_attn_fp32, split TF32 on the tensor cores. TF32 keeps 11 significant
// bits, so one TF32 product moves a score of ~4 by ~2^-9 and the softmax
// weights by ~1e-3, far past the fp32 gate (2e-5 of the largest output).
// Each operand is split into two TF32 terms, x = hi + lo (hi rounded to
// nearest, lo the exact fp32 residue, whose top 11 bits the tensor cores
// read), and each product takes three passes: hi.hi + hi.lo + lo.hi, for a
// relative error of ~2^-21 a product, within fp32's own rounding of the
// sums (CUTLASS's "3xTF32"; a TPU reaches fp32 the same way with several
// bf16 passes). `tools/attention_rounding.py --precision fp32` replays the
// arithmetic in float64 on the CPU: one term in either product fails the
// gate, three in both stay under a tenth of it. So this is fp32 arithmetic,
// not "TF32 on": PyTorch's float32 policy (TF32 off) is about its own
// matmuls rounding silently to one term, which nothing here does.
//
// Its bounds at yolos-base: on the CUDA cores 455 GFLOP at 67 TFLOP/s,
// 6.785 ms (what the kernel this one replaced could at best reach); split
// TF32 three passes at 495 TFLOP/s, 2.755 ms; the exponentials (1.78 G) take
// 0.425 ms beside them and overlap. Its design:
//
// - A split pass first (split_kv_tf32): it reads the caller's strided k and
//   v once and writes k_hi, k_lo (B*H, S, hd) and v^T_hi, v^T_lo (B*H, hd,
//   S_pad), S_pad = S rounded up to 8, into scratch the wrapper allocates.
//   TF32 wgmma takes both operands K-major only (no transpose bit for 32-bit
//   types), so P.V needs v^T. Within each group of 8 keys v^T is stored in
//   the key order 0, 2, 4, 6, 1, 3, 5, 7: a thread's scores of 8 keys are
//   its accumulator columns 2t and 2t + 1, and a TF32 A fragment from
//   registers holds columns t and t + 4, so in that order the scores are the
//   next product's A fragments as they stand (no shuffles, no round trip
//   through shared memory). ~0.63 GB of traffic at yolos-base, ~0.19 ms.
// - The main kernel: a producer warp, one thread of which issues TMA loads:
//   the Q tile once, then the hi and lo terms of K (64 keys x hd) and of v^T
//   (hd x 64 keys) into a ring of 2 stages, each half with its full barrier
//   and its empty barrier (K is free once S = Q.K^T of its tile is done, v^T
//   once P.V is), so each half is loaded a whole tile ahead.
// - Consumer warpgroups of 64 query rows (two at hd = 64; one with 32-key
//   tiles at hd = 128, where Q's terms and one stage take twice the room)
//   take turns at the tensor cores, as the bf16 kernel's do: one consumer's
//   softmax runs while the other's products do. Each splits its Q rows in
//   shared memory once (hi in place, lo beside it). Per key tile: S is three
//   wgmma m64nNk8 tf32 per 8 columns of hd (Q_hi.K_lo, Q_lo.K_hi, then
//   Q_hi.K_hi); the online softmax in fp32 with exp2 (the log2(e) scale and
//   the max folded into one FFMA); P = P_hi + P_lo in registers; then the
//   tile's P.V into a fresh accumulator (P_lo.V_hi, P_hi.V_lo, then
//   P_hi.V_hi), which the fp32 registers add to the rescaled output.
// - Accuracy of the sums: the tensor cores add a wgmma's products into its
//   accumulator with truncation, so a running P.V over all of S (~1,600
//   wgmmas at S = 4301) drifted to 2.4e-5 of the largest output, past the
//   gate, on the H100. Hence a fresh P.V accumulator a tile (24 wgmmas) and
//   the small passes first, while a sum is still small.
// - Shared memory: Q's two terms (32 KB a consumer) and two stages of 64 KB
//   (K_hi, K_lo, v^T_hi, v^T_lo at 16 KB each): 192 KB, one block an SM.
//   Registers: P's two terms, the tile's P.V and the output (32 each at hd
//   64) live together while P.V runs, within the 168 a thread that 9 warps
//   leave (4 on one scheduler's 16 K would leave 128, so not 3 consumers).
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
// Both consumers' loops issue their wgmmas on a path without branches (the
// first and last tiles are peeled off), or ptxas serialises them. Measured
// slower on the H100 and not kept (bf16): a consumer's softmax overlapping
// its own P.V (a second commit group), larger key tiles with fewer
// consumers, and the loads issued by a consumer thread instead of a
// producer warp.
//
// Numerics of the bf16 kernel: P in bf16 alone (8 significant bits) moves
// the output by up to ~2^-8 of its largest value at YOLOS's shapes, so P is
// split into two bf16 terms, P = P_hi + P_lo (P_lo the rounding residue,
// ~2^-17 relative), and P.V is two wgmmas: 1.5x the tensor work (0.69 ms at
// hd = 64), for an output that differs from fp32 arithmetic by about one
// rounding of the output. The row sums use the fp32 P (both kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace


namespace tf {  // flash_attn_fp32: split TF32 on the tensor cores

using namespace hopper;

constexpr int kTurnBarrier = 1;   // named barriers 1, 2: consumer 0's, 1's turn
constexpr int kQSplitBarrier = 4;  // 4 + cw: consumer cw's warps, Q split
constexpr int kSplitKeys = 32;     // keys a block of the split pass
constexpr int kSplitThreads = 256;

// Position p of a group of 8 keys in v^T holds key (p % 4) * 2 + p / 4:
// keys 0, 2, 4, 6, 1, 3, 5, 7 (ops/attention.py VT_KEY_ORDER).
__host__ __device__ constexpr int vt_key(int p) { return (p & 3) * 2 + (p >> 2); }

// The shape of a block at head width HD: kConsumers warpgroups of 64 query
// rows and one producer warp after them; kBN keys a tile.
template <int HD>
struct Config {
  static constexpr int kChunks = HD / 32;  // 32-float (128-byte) chunks of a q or k row
  static constexpr int kConsumers = HD == 64 ? 2 : 1;
  static constexpr int kBN = HD == 64 ? 64 : 32;
  static constexpr int kKeyChunks = kBN / 32;  // 32-key chunks of a v^T row
  static constexpr int kStages = 2;
  static constexpr int kBM = 64 * kConsumers;  // query rows a block
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
};

// Shared memory, each tile [32-column chunk][rows][32] fp32 as TMA writes it
// (128-byte rows in 8-row groups, so every tile starts 1024-byte aligned).
template <int HD>
struct alignas(1024) Smem {
  using C = Config<HD>;
  float q_hi[C::kChunks][C::kBM * 32];  // q as it lands, then its tf32 part
  float q_lo[C::kChunks][C::kBM * 32];
  float k_hi[C::kStages][C::kChunks][C::kBN * 32];
  float k_lo[C::kStages][C::kChunks][C::kBN * 32];
  float vt_hi[C::kStages][C::kKeyChunks][HD * 32];
  float vt_lo[C::kStages][C::kKeyChunks][HD * 32];
  uint64_t q_full;
  uint64_t k_full[C::kStages];
  uint64_t v_full[C::kStages];
  uint64_t k_empty[C::kStages];  // every consumer warp is done with the stage's K
  uint64_t v_empty[C::kStages];  // ... with its v^T
};

// S (+)= A . B over one 8-column k-step, at the tile's key width
__device__ __forceinline__ void mma_s(float (&d)[32], uint64_t a, uint64_t b, bool acc) {
  wgmma_m64n64k8_tf32_ss(d, a, b, acc);
}
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t a, uint64_t b, bool acc) {
  wgmma_m64n32k8_tf32_ss(d, a, b, acc);
}

template <int HD>
__global__ void __launch_bounds__(Config<HD>::kThreads, 1)
flash_attn_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_hi_map,
                       const __grid_constant__ CUtensorMap k_lo_map,
                       const __grid_constant__ CUtensorMap vt_hi_map,
                       const __grid_constant__ CUtensorMap vt_lo_map, float* __restrict__ out,
                       int s, int h_count) {
  using C = Config<HD>;
  using S = Smem<HD>;
  constexpr int kChunks = C::kChunks;
  constexpr int kBN = C::kBN;
  constexpr int kStages = C::kStages;
  constexpr int kConsumers = C::kConsumers;
  constexpr int kGroups = kBN / 8;   // 8-key column groups of the score fragment
  constexpr int kNChunks = HD / 64;  // 64-column chunks of the output
  extern __shared__ char smem_raw[];
  S& sm = *reinterpret_cast<S*>(align_1024(smem_raw));

  // warp-uniform as far as the compiler can see, so the roles' paths are not
  // divergent; warpgroups 0 .. kConsumers - 1 consume, the warp after them loads
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int q0 = blockIdx.x * C::kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * h_count + h;
  const int n_tiles = (s + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.k_empty[st], C::kConsumerThreads / 32);  // one arrival a consumer warp
      mbar_init(&sm.v_empty[st], C::kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == kConsumers) {  // producer
    if (threadIdx.x == C::kConsumerThreads) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q_hi));
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.q_hi[c], &q_map, &sm.q_full, 32 * c, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], free_parity);
        mbar_expect_tx(&sm.k_full[st], 2 * sizeof(sm.k_hi[0]));
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_3d(sm.k_hi[st][c], &k_hi_map, &sm.k_full[st], 32 * c, j * kBN, bh);
          tma_load_3d(sm.k_lo[st][c], &k_lo_map, &sm.k_full[st], 32 * c, j * kBN, bh);
        }
        mbar_wait(&sm.v_empty[st], free_parity);
        mbar_expect_tx(&sm.v_full[st], 2 * sizeof(sm.vt_hi[0]));
#pragma unroll
        for (int kc = 0; kc < C::kKeyChunks; ++kc) {
          tma_load_3d(sm.vt_hi[st][kc], &vt_hi_map, &sm.v_full[st], j * kBN + 32 * kc, 0, bh);
          tma_load_3d(sm.vt_lo[st][kc], &vt_lo_map, &sm.v_full[st], j * kBN + 32 * kc, 0, bh);
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

  // Q's rows of this consumer into two tf32 terms: hi in place, lo beside it
  // (an elementwise split, so the swizzle TMA wrote holds for both)
  mbar_wait(&sm.q_full, 0);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4* hi = reinterpret_cast<float4*>(&sm.q_hi[c][cw * 64 * 32]);
    float4* lo = reinterpret_cast<float4*>(&sm.q_lo[c][cw * 64 * 32]);
#pragma unroll
    for (int i = tid; i < 64 * 32 / 4; i += 128) {
      const float4 x = hi[i];
      uint32_t h4[4], l4[4];
      split_tf32(x.x, h4[0], l4[0]);
      split_tf32(x.y, h4[1], l4[1]);
      split_tf32(x.z, h4[2], l4[2]);
      split_tf32(x.w, h4[3], l4[3]);
      hi[i] = make_float4(__uint_as_float(h4[0]), __uint_as_float(h4[1]), __uint_as_float(h4[2]),
                          __uint_as_float(h4[3]));
      lo[i] = make_float4(__uint_as_float(l4[0]), __uint_as_float(l4[1]), __uint_as_float(l4[2]),
                          __uint_as_float(l4[3]));
    }
  }
  fence_proxy_async_shared();  // the split's stores, before wgmma reads them
  named_bar_sync(kQSplitBarrier + cw, 128);

  // a turn passes from consumer cw to cw + 1 (mod kConsumers); each barrier
  // joins the waiting consumer and the one handing it the turn
  const int my_turn = kTurnBarrier + cw;
  const int next_turn = kTurnBarrier + (cw + 1) % kConsumers;
  auto take_turn = [&]() {
    if constexpr (kConsumers > 1) named_bar_sync(my_turn, 256);
  };
  auto pass_turn = [&]() {
    if constexpr (kConsumers > 1) named_bar_arrive(next_turn, 256);
  };
  if constexpr (kConsumers > 1) {
    if (cw == kConsumers - 1) named_bar_arrive(kTurnBarrier, 256);  // consumer 0 goes first
  }

  float o[kNChunks][32];       // the output so far, rescaled as the max moves
  float o_tile[kNChunks][32];  // P.V of the current tile
#pragma unroll
  for (int c = 0; c < kNChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[c][i] = 0.0f;
      o_tile[c][i] = 0.0f;
    }
  float sc[kBN / 2];  // scores of the current tile, then their exponentials
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.0f;
  // P of the current tile, as A fragments of its 8-key steps (tf32 bits)
  uint32_t p_hi[kGroups][4], p_lo[kGroups][4];
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the row sums

  uint64_t qh_desc[kChunks], ql_desc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    qh_desc[c] = sw128_desc(&sm.q_hi[c][cw * 64 * 32], 16);
    ql_desc[c] = sw128_desc(&sm.q_lo[c][cw * 64 * 32], 16);
  }

  // The steps of a tile, each inlined where it is used, so the loop below
  // issues its wgmmas on a path without branches.
  // The tensor cores add each wgmma's products into the accumulator with
  // truncation, so every wgmma that adds into a large sum costs a few bits
  // of it: the small passes go in first, while the sum is small, and P.V
  // sums one tile at a time (24 wgmmas at hd 64, not ~1,600 over S = 4301)
  // before the fp32 registers add it to the output, rounded.
  auto issue_s = [&](int j) {  // S = Q . K^T of tile j, into sc: lo passes, then hi.hi
    const int st = j % kStages;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint64_t kh = sw128_desc(sm.k_hi[st][c], 16);
      const uint64_t kl = sw128_desc(sm.k_lo[st][c], 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 8 columns of hd a step: 32 bytes
        mma_s(sc, qh_desc[c] + 2 * kk, kl + 2 * kk, (c | kk) != 0);
        mma_s(sc, ql_desc[c] + 2 * kk, kh + 2 * kk, true);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint64_t kh = sw128_desc(sm.k_hi[st][c], 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_s(sc, qh_desc[c] + 2 * kk, kh + 2 * kk, true);
    }
  };
  auto issue_pv = [&](int j) {  // o_tile = P . V of tile j: lo passes, then hi.hi
    const int st = j % kStages;
#pragma unroll
    for (int nc = 0; nc < kNChunks; ++nc) {
#pragma unroll
      for (int kc = 0; kc < C::kKeyChunks; ++kc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 8 keys a step: 32 bytes of a v^T row
          const int ks = 4 * kc + kk;
          const uint64_t vh = sw128_desc(&sm.vt_hi[st][kc][nc * 64 * 32], 16) + 2 * kk;
          const uint64_t vl = sw128_desc(&sm.vt_lo[st][kc][nc * 64 * 32], 16) + 2 * kk;
          wgmma_m64n64k8_tf32_rs(o_tile[nc], p_lo[ks], vh, ks != 0);
          wgmma_m64n64k8_tf32_rs(o_tile[nc], p_hi[ks], vl, true);
        }
#pragma unroll
      for (int kc = 0; kc < C::kKeyChunks; ++kc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t vh = sw128_desc(&sm.vt_hi[st][kc][nc * 64 * 32], 16) + 2 * kk;
          wgmma_m64n64k8_tf32_rs(o_tile[nc], p_hi[4 * kc + kk], vh, true);
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
  // P of this tile becomes the A fragments of its P.V. The 8-key step i
  // holds {row g, col t}, {row g + 8, col t}, {row g, col t + 4}, {row g + 8,
  // col t + 4}; in v^T's key order columns t and t + 4 are keys 2t and
  // 2t + 1, which are this thread's scores 4i, 4i + 2 (rows g, g + 8, key
  // 2t) and 4i + 1, 4i + 3 (key 2t + 1).
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      fence_operands(p_hi[i]);
      fence_operands(p_lo[i]);
      split_tf32(sc[4 * i + 0], p_hi[i][0], p_lo[i][0]);
      split_tf32(sc[4 * i + 2], p_hi[i][1], p_lo[i][1]);
      split_tf32(sc[4 * i + 1], p_hi[i][2], p_lo[i][2]);
      split_tf32(sc[4 * i + 3], p_hi[i][3], p_lo[i][3]);
    }
  };
  // Once the tile's P.V is done: the output so far shrinks by alpha and
  // takes the tile's sum, in fp32 (rounded to nearest).
  auto merge = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < kNChunks; ++c) {
      fence_operands(o_tile[c]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = fmaf(o[c][i], alpha[(i >> 1) & 1], o_tile[c][i]);
    }
  };

  // Per tile two blocks of wgmmas, each issued in this consumer's turn,
  // which it then hands on: Q.K^T, then (after the softmax) P.V. A stage's K
  // is released once its Q.K^T is done, its v^T once its P.V is. While one
  // consumer's softmax runs, the other's products keep the tensor cores busy.
  float alpha[2];
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(&sm.k_full[st], parity);
    take_turn();
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    mbar_arrive_per_warp(&sm.k_empty[st]);
    softmax(j, alpha);
    pack();
    mbar_wait(&sm.v_full[st], parity);
    take_turn();
    wgmma_fence();
    issue_pv(j);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    mbar_arrive_per_warp(&sm.v_empty[st]);
    merge(alpha);
  }
  if constexpr (kConsumers > 1) {
    if (cw == 0) named_bar_sync(kTurnBarrier, 256);  // the last consumer's last hand-over
  }

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
    float* dst = out + ((static_cast<long long>(b) * s + row) * h_count + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < kNChunks; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * i) =
            make_float2(o[c][4 * i + 2 * r] * inv[r], o[c][4 * i + 2 * r + 1] * inv[r]);
      }
  }
}

// The split pass: k, v (B, S, H, hd) over the caller's strides -> k_hi, k_lo
// (B*H, S, hd) and v^T_hi, v^T_lo (B*H, hd, s_pad) in v^T's key order, each
// x = hi + lo exactly (split_tf32); v^T's keys from S to s_pad are zeros.
// One block a 32-key slice of one (b, h): K rows straight through, v's rows
// transposed through shared memory (a padded row per key: conflict-free
// column reads), so reads and writes are coalesced.
template <int HD>
__global__ void __launch_bounds__(kSplitThreads)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ k_hi,
                float* __restrict__ k_lo, float* __restrict__ vt_hi, float* __restrict__ vt_lo,
                int s, int s_pad, int h_count, long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh) {
  constexpr int kQuads = HD / 4;
  __shared__ float vs[kSplitKeys][HD + 1];
  const int s0 = blockIdx.x * kSplitKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * h_count + h;
  const float* k_bh = k + b * ksb + h * ksh;
  const float* v_bh = v + b * vsb + h * vsh;
  for (int i = threadIdx.x; i < kSplitKeys * kQuads; i += kSplitThreads) {
    const int r = i / kQuads;
    const int c = (i % kQuads) * 4;
    const int key = s0 + r;
    float4 vv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (key < s) {
      const float4 kv = *reinterpret_cast<const float4*>(k_bh + key * kss + c);
      uint32_t hi[4], lo[4];
      split_tf32(kv.x, hi[0], lo[0]);
      split_tf32(kv.y, hi[1], lo[1]);
      split_tf32(kv.z, hi[2], lo[2]);
      split_tf32(kv.w, hi[3], lo[3]);
      const long long o = (bh * s + key) * HD + c;
      *reinterpret_cast<uint4*>(k_hi + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(k_lo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      vv = *reinterpret_cast<const float4*>(v_bh + key * vss + c);
    }
    vs[r][c] = vv.x;
    vs[r][c + 1] = vv.y;
    vs[r][c + 2] = vv.z;
    vs[r][c + 3] = vv.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HD * kSplitKeys; i += kSplitThreads) {
    const int d = i / kSplitKeys;
    const int p = i % kSplitKeys;
    if (s0 + p >= s_pad) continue;
    uint32_t hi, lo;
    split_tf32(vs[(p & ~7) | vt_key(p & 7)][d], hi, lo);
    const long long o = (bh * HD + d) * s_pad + s0 + p;
    vt_hi[o] = __uint_as_float(hi);
    vt_lo[o] = __uint_as_float(lo);
  }
}

template <int HD>
int launch_hd(const float* q, const float* k_hi, const float* k_lo, const float* vt_hi,
              const float* vt_lo, float* out, int b_count, int s, int h_count, int s_pad,
              const long long* qst, void* stream) {
  using C = Config<HD>;
  const cuuint64_t bh = static_cast<cuuint64_t>(b_count) * h_count;
  CUtensorMap maps[5];
  {  // q: (hd, H, S, B) over the caller's strides, a box of the block's rows
    const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(h_count), static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(b_count)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(qst[2]) * 4,
                                   static_cast<cuuint64_t>(qst[1]) * 4,
                                   static_cast<cuuint64_t>(qst[0]) * 4};
    const cuuint32_t box[4] = {32, 1, C::kBM, 1};
    const int err = encode_tiled(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, dims, strides,
                                 box);
    if (err != 0) return err;
  }
  const float* k_terms[2] = {k_hi, k_lo};
  for (int i = 0; i < 2; ++i) {  // k terms: (hd, S, B*H), a box of kBN keys
    const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(s), bh};
    const cuuint64_t strides[2] = {HD * 4, static_cast<cuuint64_t>(s) * HD * 4};
    const cuuint32_t box[3] = {32, C::kBN, 1};
    const int err = encode_tiled(&maps[1 + i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, k_terms[i],
                                 dims, strides, box);
    if (err != 0) return err;
  }
  const float* vt_terms[2] = {vt_hi, vt_lo};
  for (int i = 0; i < 2; ++i) {  // v^T terms: (s_pad, hd, B*H), a box of 32 keys x hd
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(s_pad), HD, bh};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_pad) * 4,
                                   static_cast<cuuint64_t>(s_pad) * HD * 4};
    const cuuint32_t box[3] = {32, HD, 1};
    const int err = encode_tiled(&maps[3 + i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, vt_terms[i],
                                 dims, strides, box);
    if (err != 0) return err;
  }
  constexpr size_t smem = sizeof(Smem<HD>) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(flash_attn_tf32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + C::kBM - 1) / C::kBM, h_count, b_count);
  flash_attn_tf32_kernel<HD><<<grid, C::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], out, s, h_count);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int b_count, int s, int h_count, int s_pad) {
  return b_count >= 1 && s >= 1 && h_count >= 1 && h_count <= 65535 && b_count <= 65535 &&
         static_cast<long long>(b_count) * h_count <= INT32_MAX && s_pad == (s + 7) / 8 * 8;
}

int launch(const void* q, const void* k_hi, const void* k_lo, const void* vt_hi,
           const void* vt_lo, void* out, int b_count, int s, int h_count, int hd, int s_pad,
           const long long* qst, void* stream) {
  if (!valid_shape(b_count, s, h_count, s_pad)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (hd == 64) {
    return launch_hd<64>(f(q), f(k_hi), f(k_lo), f(vt_hi), f(vt_lo), static_cast<float*>(out),
                         b_count, s, h_count, s_pad, qst, stream);
  }
  if (hd == 128) {
    return launch_hd<128>(f(q), f(k_hi), f(k_lo), f(vt_hi), f(vt_lo), static_cast<float*>(out),
                          b_count, s, h_count, s_pad, qst, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_split_hd(const float* k, const float* v, float* k_hi, float* k_lo, float* vt_hi,
                    float* vt_lo, int b_count, int s, int h_count, int s_pad,
                    const long long* st, void* stream) {
  const dim3 grid((s_pad + kSplitKeys - 1) / kSplitKeys, h_count, b_count);
  split_kv_kernel<HD><<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k, v, k_hi, k_lo, vt_hi, vt_lo, s, s_pad, h_count, st[0], st[1], st[2], st[3], st[4],
      st[5]);
  return static_cast<int>(cudaGetLastError());
}

int launch_split(const void* k, const void* v, void* k_hi, void* k_lo, void* vt_hi, void* vt_lo,
                 int b_count, int s, int h_count, int hd, int s_pad, const long long* st,
                 void* stream) {
  if (!valid_shape(b_count, s, h_count, s_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* out[4] = {static_cast<float*>(k_hi), static_cast<float*>(k_lo),
                   static_cast<float*>(vt_hi), static_cast<float*>(vt_lo)};
  if (hd == 64) {
    return launch_split_hd<64>(kf, vf, out[0], out[1], out[2], out[3], b_count, s, h_count,
                               s_pad, st, stream);
  }
  if (hd == 128) {
    return launch_split_hd<128>(kf, vf, out[0], out[1], out[2], out[3], b_count, s, h_count,
                                s_pad, st, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tf


namespace tc {  // flash_attn_bf16: the tensor-core kernel

using namespace hopper;

constexpr int kTurnBarrier = 1;  // named barriers 1, 2, ...: consumer 0's, 1's, ... turn

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

// Plain C interface, loaded with ctypes. Pointers are device pointers; the
// stream is the caller's current CUDA stream. Each returns the error of the
// launch or of its tensor maps (0 on success); none synchronises or
// allocates. hd is 64 or 128; strides are in elements, over (b, s, h), in
// multiples of 16 bytes (4 fp32, 8 bf16), with unit stride over hd and
// 16-byte aligned pointers.
//
// split_kv_tf32: k, v fp32 (B, S, H, hd) -> k_hi, k_lo (B*H, S, hd) and
// vt_hi, vt_lo (B*H, hd, s_pad), s_pad = S rounded up to 8, contiguous.
extern "C" int split_kv_tf32(const void* k, const void* v, void* k_hi, void* k_lo, void* vt_hi,
                             void* vt_lo, int b_count, int s, int h_count, int hd, int s_pad,
                             long long ksb, long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, void* stream) {
  const long long st[6] = {ksb, kss, ksh, vsb, vss, vsh};
  return tf::launch_split(k, v, k_hi, k_lo, vt_hi, vt_lo, b_count, s, h_count, hd, s_pad, st,
                          stream);
}

// flash_attn_fp32: q fp32 (B, S, H, hd) over its strides and split_kv_tf32's
// four terms of k and v -> out, a contiguous fp32 (B, S, H, hd).
extern "C" int flash_attn_fp32(const void* q, const void* k_hi, const void* k_lo,
                               const void* vt_hi, const void* vt_lo, void* out, int b_count,
                               int s, int h_count, int hd, int s_pad, long long qsb,
                               long long qss, long long qsh, void* stream) {
  const long long qst[3] = {qsb, qss, qsh};
  return tf::launch(q, k_hi, k_lo, vt_hi, vt_lo, out, b_count, s, h_count, hd, s_pad, qst,
                    stream);
}

// flash_attn_bf16: q, k, v bf16 (B, S, H, hd) over their strides -> out, a
// contiguous bf16 (B, S, H, hd).
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v, void* out,
                               int b_count, int s, int h_count, int hd, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return tc::launch(q, k, v, out, b_count, s, h_count, hd, st, stream);
}

extern "C" const char* attention_error_string(int code) { return hopper::error_string(code); }
