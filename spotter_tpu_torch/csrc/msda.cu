// Multiscale deformable attention (MSDA) sampling: three kernels that compute
// the same weighted row gather-sum, with more of the work inside each.
//
//     out[b, q, h, :] = sum_j w[b, q, h, j] * value[b, idx[b, q, h, j], h, :]
//
// accumulated and returned in fp32, over the J = levels * points * corners
// sample terms of each (b, query, head). The value is read where the model
// holds it, (B, S, H, hd): the row of (b, s, h) starts at ((b*S + s)*H + h)*hd,
// offsets 64-bit. The output is written in the model's (B, Q, H, hd) layout.
// So no call site copies the value into a per-head layout or permutes the
// output back.
//
// 1. msda_gather_sum takes idx/w (B*H, Q, J) from the plain-torch corner
//    prep (spotter_tpu_torch/ops/msda.py::prepare_msda_gather). It replaces
//    spotter_tpu/ops/msda.py::pallas_onehot_sampling_merged.
// 2. msda_loc_sum takes the raw sample coordinates loc (B, Q, H, LP, 2) and
//    attention weights attn (B, Q, H, LP), read in place, and does the
//    corner prep (_corner_terms: floor, bilinear weights, validity, clamped
//    indices) itself. It replaces pallas_onehot_sampling_merged_loc.
// 3. msda_fused_sum takes the decoder hidden states and the per-head
//    sampling-offset and attention-weight projections, and computes the two
//    projections, the softmax over each head's samples and the location
//    arithmetic (xy = base + offsets * scale) before the same walk. It
//    replaces pallas_msda_fused.
//
// The TPU kernels build one-hot tiles and contract them on the MXU because
// the TPU has no fast gather; their level padding to S_TILE, locality sort,
// block-sparse hit tables and Q_TILE padding all serve that workaround.
// Hopper gathers rows directly, so none of it is carried over: no query is
// padded, and every output row is a real query.
//
// What bounds them on an H100: memory. At the RT-DETR decoder shapes (B*H =
// 8*B, S = 8400, hd = 32, Q = 300, LP = 12 samples per query-head) the value
// rows dominate the traffic (1.07 MB fp32 per head), against ~59 MFLOP of
// gather FMAs at B = 8. The fused kernel's prologue adds 2*D*3*LP = 18 kFLOP
// per (b*h, query), ~354 MFLOP at B = 8: >= 5.3 us at the 67 TFLOP/s fp32
// rate, below the 13.4 us bytes bound, so the CUDA cores suffice. The rows
// of one head stay in the 50 MB L2 while its queries run, so repeat reads
// are L2 hits.
//
// Design, one shape for all three: a block owns one (b, h) and a tile of
// kQTile = 32 queries (no query is padded, the ragged last tile is masked).
// It first puts each of its queries' terms in shared memory, samples then
// corners: (row offset, weight) pairs, where the offset is -1 for a term
// that loads nothing (an index outside [0, S), a weight of 0), so each
// term's checks and its row offset (an int) are worked out once, not once
// per thread that reads its row; padded to a multiple of kTermChunk, at an odd
// stride (no bank conflicts between the queries of a warp). Then walk_tile:
// - msda_gather_sum copies the tile's idx/w, which lie contiguous for one
//   b*h, with coalesced loads (16 bytes where J % 4 == 0 and aligned), a
//   thread's loads issued before its stores;
// - msda_loc_sum gives a thread a sample at a time (consecutive threads
//   take consecutive samples: sample l of a query-head reads the float2 at
//   2l of its loc and its attention weight), loads all of a thread's
//   samples first, then computes their corners (corner_terms);
// - msda_fused_sum stages its head's weight slices and the tile's hidden
//   states, runs the projections, the softmax and the locations, and then
//   the corners as the loc kernel does (its four phases below).
// walk_tile gives a thread one (query, 4 channels) (8 threads cover a
// 128-byte fp32 row at hd = 32, a warp 4 queries). For each chunk of
// kTermChunk terms it issues every row load first (16-byte loads for fp32
// rows, 8-byte for bf16, msda_rows::load_quad), each predicated on its
// offset, with no branch between them; a term not loaded is 0 and adds
// exactly nothing, so a bad index can never read out of bounds. Then the
// FMAs, fmaf(w, v, acc) from 0 in term order. The three kernels share that
// walk and its order, so on the same terms their fp32 outputs are equal bit
// for bit. ptxas keeps the loads first in the fused kernel (80 registers);
// in the gather-sum and loc kernels it interleaves them with the FMAs and
// holds more warps an SM instead: on the card, loads issued unconditionally
// or through inline PTX were scheduled the same way, and forcing them first
// (__launch_bounds__ with 2 or 4 blocks an SM) lost at the Deformable-DETR
// encoder op. The corner arithmetic uses round-to-nearest
// intrinsics (no FMA contraction) so that it rounds exactly as the plain
// torch version does, which matters for the discrete method's nearest-cell
// rounding. hd % 4 != 0 (or rows not aligned to 4 channels) takes scalar
// loads.
//
// The fused kernel's block (256 threads) runs four phases:
// - staging: the head's weight slices (D x 3*LP fp32, 36 KB at D = 256,
//   LP = 12) by cp.async, in flight while the tile's hidden states are
//   loaded 16 bytes at a time and stored transposed to (D, kQTile);
// - the prologue, register-blocked: a thread owns 4 queries x one sample's
//   three columns (x offset, y offset, logit) and walks d outermost, one
//   float4 of hidden states and three weights a d step for 12 FMAs (0.58
//   shared-memory reads a FMA, not 2). Each output
//   stays one fp32 FMA chain in d order from 0, then + bias: no tensor
//   cores, split K or reordered d, since the plain version
//   (fused_prologue_reference) sums in this order and the discrete method
//   needs the sample locations equal bit for bit;
// - softmax, locations and corners: a warp a query, a lane a sample
//   (corner_terms, as in the loc kernel); the query's terms go to shared
//   memory, where the weights were;
// - walk_tile.
// One-pass mode (SPOTTER_TPU_MSDA_PRECISION=default, the TPU's one bf16 MXU
// pass): every kernel has a kOnePass instantiation, reached through the
// `*_onepass` entry points. It rounds each term's weight to bf16 where the
// term is staged (make_term) and each value element to bf16 in the walk
// (identity for bf16 rows), so each product is exact in fp32 and the sums
// stay fp32 as before; the fused kernel also rounds the hidden states as it
// stages them and the two projections' weights as the prologue reads them
// (products exact, fp32 sums, the bias added in fp32). The TPU rounds a
// one-hot entry instead, the sum of one query's term weights that land on
// one source row within a level: where two terms of one (query, head,
// level) share a row, the two differ by at most a bf16 rounding of each of
// those weights (tests/test_torch_precision_msda.py bounds it). fp32 rows
// are rounded in registers, not cast to bf16 first: that would add a pass
// over the value and an allocation a call, and the walk keeps its 128-bit
// loads.
//
// On an H100 80GB HBM3 at 700 W, at RT-DETR's decoder op at B = 8, the
// gather-sum and loc kernels take ~0.03 ms (2.1-2.3x their bounds) and the
// fused one ~0.068 (5x: every block copies its head's 36 KB of weights and
// its tile's 32 KB of hidden states from L2, 72 KB of shared memory allow 3
// blocks an SM, and 96 of 256 threads run the prologue). Of 16-, 32- and
// 64-query tiles (tools/fused_tile_probe.py builds the other two), 32 is
// within 2 % of the fastest for all three kernels at B = 1 and 8, but for
// the gather-sum at B = 8, where 64 is ~8 % faster. At Deformable-DETR's
// encoder op (37,150 queries x 64 terms) the gather-sum and loc kernels
// take ~1.2-1.3 ms (2.3x and 3.9x their bounds; ~1.5-1.6 ms while each
// thread checked each term and formed its 64-bit row address itself): each
// term still costs a warp a shared-memory read and four 128-byte row
// wavefronts in L1, ~1 ms of the load/store pipe at that size. The first gather-sum and loc kernels (a warp
// a query, a lane a channel; per term two shuffles, a branch and one
// dependent 4-byte load) took 0.045 and 0.057 ms at B = 8, and ~4 ms an
// encoder op. PERF.md has the runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msda_rows.cuh"

namespace {

using msda_rows::load_quad;
using msda_rows::round_to;
using msda_rows::store_quad;

// an operand of the one-pass mode's products: rounded to bf16 when
// kOnePass, else as it is
template <bool kOnePass>
__device__ __forceinline__ float pass_operand(float v) {
  return kOnePass ? round_to<__nv_bfloat16>(v) : v;
}

// queries of one block, all three kernels (tools/fused_tile_probe.py times
// 16 and 64 beside it)
#ifndef MSDA_Q_TILE
#define MSDA_Q_TILE 32
#endif
constexpr int kQTile = MSDA_Q_TILE;
constexpr int kThreads = kQTile >= 32 ? 256 : 128;
constexpr int kFusedRowBlock = 4;  // queries of a prologue thread's micro-tile
constexpr int kFusedHsPad = 4;  // hs_t's row pad: each d's queries stay 16-byte aligned
constexpr int kTermChunk = 8;  // terms whose rows a walk thread loads before it sums them
constexpr int kMaxSamples = 32;  // samples a query-head
constexpr int kMaxTerms = 4 * kMaxSamples;  // corners of kMaxSamples bilinear samples
// loads a thread issues at most before it stages them: the loc kernel's
// samples (one float2 and one weight each), the gather-sum kernel's runs of
// 4 (index, weight) pairs
constexpr int kPrepRounds = kQTile * kMaxSamples / kThreads;
constexpr int kStageRounds = kQTile * kMaxTerms / 4 / kThreads;

// A query's terms in shared memory: its n_terms terms padded to a multiple
// of kTermChunk, at an odd stride (the queries a warp reads at once sit in
// distinct banks). A term is .x, the row's element offset from the (b, 0,
// h) row, or -1 where nothing is loaded (an index outside [0, S), a weight
// of 0, or padding), and .y the weight's bits: each term's checks and
// offset are worked out once, not once per thread that reads its row.
__host__ __device__ inline int padded_terms(int n_terms) {
  return (n_terms + kTermChunk - 1) / kTermChunk * kTermChunk;
}
__host__ __device__ inline int term_stride(int n_terms) { return padded_terms(n_terms) | 1; }

// the weight rounded to bf16 first in the one-pass mode
template <bool kOnePass>
__device__ __forceinline__ int2 make_term(int idx, float w, int s, int row_stride) {
  w = pass_operand<kOnePass>(w);
  const bool on = static_cast<unsigned>(idx) < static_cast<unsigned>(s) && w != 0.0f;
  return make_int2(on ? idx * row_stride : -1, __float_as_int(w));
}

// the padding terms of a tile's nq queries (nothing loaded, weight 0)
__device__ __forceinline__ void pad_terms(int2* __restrict__ terms, int stride, int n_terms,
                                          int nq) {
  const int pad = padded_terms(n_terms) - n_terms;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < nq * pad; i += blockDim.x) {
    terms[i / pad * stride + n_terms + i % pad] = make_int2(-1, 0);
  }
}

// The walk all three kernels end with. A tile's nq queries hold their terms
// in shared memory, query r's at terms + r * stride, samples then corners
// (make_term, padded). A thread takes one (query, 4 channels); for
// kTermChunk terms at a time it issues every row load first, each
// predicated on its offset, with no branch between them; then the FMAs in
// term order, fmaf(w, v, acc) from 0 (a term not loaded is 0 and adds
// exactly nothing). value_bh points at the (b, 0, h) row and out_tile at the
// tile's first (b, q, h) output row; both step row_stride = H * hd elements
// a row. kOnePass rounds each loaded fp32 value to bf16 before its FMA (the
// staged weights are already rounded; bf16 rows need nothing).
template <typename T, bool kVec, bool kOnePass>
__device__ __forceinline__ void walk_tile(const int2* __restrict__ terms, int stride,
                                          int n_terms, int nq, const T* __restrict__ value_bh,
                                          int hd, int row_stride, float* __restrict__ out_tile) {
  const int quads = (hd + 3) / 4;
  for (int item = threadIdx.x; item < nq * quads; item += blockDim.x) {
    const int r = item / quads;
    const int c = (item % quads) * 4;
    const int2* t_q = terms + r * stride;
    const T* rows_c = value_bh + c;
    float sum4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t0 = 0; t0 < n_terms; t0 += kTermChunk) {
      float v[kTermChunk][4];
      float wt[kTermChunk];
#pragma unroll
      for (int k = 0; k < kTermChunk; ++k) {
        const int2 tk = t_q[t0 + k];
        wt[k] = __int_as_float(tk.y);
        load_quad<T, kVec>(rows_c + max(tk.x, 0), c, hd, tk.x >= 0, v[k]);
        if (kOnePass && sizeof(T) == 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[k][e] = pass_operand<true>(v[k][e]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTermChunk; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum4[e] = fmaf(wt[k], v[k][e], sum4[e]);
    }
    store_quad<kVec>(out_tile + (long long)r * row_stride + c, c, hd, sum4);
  }
}

// One sample's corner terms, the port of spotter_tpu.ops.msda._corner_terms:
// global row indices (level-local index + level offset) and folded weights.
// "default": the four bilinear corners (dy, dx) in (0,0), (0,1), (1,0),
// (1,1) order, align_corners=False, out-of-range corners weight 0 with
// clamped indices. "discrete": the one nearest cell, clamped, weight a.
__device__ __forceinline__ void corner_terms(float x, float y, float a, float lw, float lh,
                                             int off, bool discrete, int (&idx)[4],
                                             float (&w)[4]) {
  if (discrete) {
    const float cx = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(x, lw), 0.5f)), 0.0f), lw - 1.0f);
    const float cy = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(y, lh), 0.5f)), 0.0f), lh - 1.0f);
    idx[0] = (int)__fadd_rn(__fmul_rn(cy, lw), cx) + off;
    w[0] = a;
    return;
  }
  const float gx = __fsub_rn(__fmul_rn(x, lw), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(y, lh), 0.5f);
  const float x0 = floorf(gx);
  const float y0 = floorf(gy);
  const float fx = __fsub_rn(gx, x0);
  const float fy = __fsub_rn(gy, y0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float xc = x0 + dx;
    const float yc = y0 + dy;
    const bool valid = xc >= 0.0f && xc <= lw - 1.0f && yc >= 0.0f && yc <= lh - 1.0f;
    const float wx = dx ? fx : __fsub_rn(1.0f, fx);
    const float wy = dy ? fy : __fsub_rn(1.0f, fy);
    w[k] = valid ? __fmul_rn(__fmul_rn(wx, wy), a) : 0.0f;
    const float yi = fminf(fmaxf(yc, 0.0f), lh - 1.0f);
    const float xi = fminf(fmaxf(xc, 0.0f), lw - 1.0f);
    idx[k] = (int)__fadd_rn(__fmul_rn(yi, lw), xi) + off;
  }
}

// a sample's n_corners terms (corner_terms' first n_corners) into t
template <bool kOnePass>
__device__ __forceinline__ void put_terms(int2* t, int n_corners, const int (&idx)[4],
                                          const float (&w)[4], int s, int row_stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n_corners) t[k] = make_term<kOnePass>(idx[k], w[k], s, row_stride);
  }
}

template <typename T, bool kVec, bool kOnePass>
__global__ void __launch_bounds__(kThreads)
msda_gather_sum_kernel(const T* __restrict__ value, const int32_t* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out, int h_count,
                       int s, int hd, int q, int j) {
  extern __shared__ int2 terms[];  // kQTile rows of term_stride(j) terms
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, q - q0);
  const int stride = term_stride(j);
  const int row_stride = h_count * hd;  // the launcher checks S * H * hd < 2**31

  // the tile's idx/w: nq * j contiguous words each, copied once with
  // coalesced loads, 16 bytes at a time where every query's run of j starts
  // 16-byte aligned, a thread's loads all issued before its stores
  const long long first = ((b * h_count + h) * q + q0) * (long long)j;
  const int32_t* idx_t = idx + first;
  const float* w_t = w + first;
  const int n = nq * j;
  if (j % 4 == 0 && reinterpret_cast<uintptr_t>(idx_t) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w_t) % 16 == 0) {
    int4 iv[kStageRounds];
    float4 wv[kStageRounds];
#pragma unroll
    for (int k = 0; k < kStageRounds; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n / 4) {
        iv[k] = __ldg(reinterpret_cast<const int4*>(idx_t) + i);
        wv[k] = __ldg(reinterpret_cast<const float4*>(w_t) + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageRounds; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n / 4) {
        const int r = 4 * i / j, c = 4 * i % j;  // the four lie in one query's run
        int2* t = terms + r * stride + c;
        t[0] = make_term<kOnePass>(iv[k].x, wv[k].x, s, row_stride);
        t[1] = make_term<kOnePass>(iv[k].y, wv[k].y, s, row_stride);
        t[2] = make_term<kOnePass>(iv[k].z, wv[k].z, s, row_stride);
        t[3] = make_term<kOnePass>(iv[k].w, wv[k].w, s, row_stride);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      terms[i / j * stride + i % j] =
          make_term<kOnePass>(__ldg(idx_t + i), __ldg(w_t + i), s, row_stride);
    }
  }
  pad_terms(terms, stride, j, nq);
  __syncthreads();

  const T* value_bh = value + (b * s * h_count + h) * (long long)hd;
  float* out_tile = out + ((b * q + q0) * h_count + h) * (long long)hd;
  walk_tile<T, kVec, kOnePass>(terms, stride, j, nq, value_bh, hd, row_stride, out_tile);
}

template <typename T, bool kVec, bool kOnePass>
__global__ void __launch_bounds__(kThreads)
msda_loc_sum_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, const float* __restrict__ lvl_h,
                    const float* __restrict__ lvl_w, const int32_t* __restrict__ lvl_off,
                    float* __restrict__ out, int h_count, int s, int hd, int q, int lp,
                    int discrete) {
  extern __shared__ int2 terms[];  // kQTile rows of term_stride(lp * corners) terms
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, q - q0);
  const int n_corners = discrete ? 1 : 4;
  const int stride = term_stride(lp * n_corners);
  const int row_stride = h_count * hd;  // the launcher checks S * H * hd < 2**31

  // the corner prep, a thread a sample at a time (consecutive threads take
  // consecutive samples of a query-head, whose loc (LP, 2) and attn (LP)
  // lie contiguous, read in place): all of a thread's loc float2s and
  // attention weights are loaded before it computes any sample's corners
  const int n_samples = nq * lp;
  float2 xy[kPrepRounds];
  float a[kPrepRounds];
#pragma unroll
  for (int k = 0; k < kPrepRounds; ++k) {
    const int i = threadIdx.x + k * kThreads;
    xy[k] = make_float2(0.0f, 0.0f);
    a[k] = 0.0f;
    if (i < n_samples) {
      const int r = i / lp, l = i - r * lp;
      const long long qh = (b * q + q0 + r) * h_count + h;  // the (b, q, h) of query r
      xy[k] = __ldg(reinterpret_cast<const float2*>(loc) + qh * lp + l);
      a[k] = __ldg(attn + qh * lp + l);
    }
  }
#pragma unroll
  for (int k = 0; k < kPrepRounds; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n_samples) {
      const int r = i / lp, l = i - r * lp;
      int idx[4];
      float w[4];
      corner_terms(xy[k].x, xy[k].y, a[k], __ldg(lvl_w + l), __ldg(lvl_h + l),
                   __ldg(lvl_off + l), discrete != 0, idx, w);
      put_terms<kOnePass>(terms + r * stride + l * n_corners, n_corners, idx, w, s, row_stride);
    }
  }
  pad_terms(terms, stride, lp * n_corners, nq);
  __syncthreads();

  const T* value_bh = value + (b * s * h_count + h) * (long long)hd;
  float* out_tile = out + ((b * q + q0) * h_count + h) * (long long)hd;
  walk_tile<T, kVec, kOnePass>(terms, stride, lp * n_corners, nq, value_bh, hd, row_stride,
                               out_tile);
}

// The fused block's shared memory, in floats, two regions reused between
// phases: A holds the head's two weight slices as they lie in memory, w_off's
// (d x 2*LP) then w_att's (d x LP), for the prologue, then the tile's terms
// (kQTile rows of term_stride(4 * LP) terms); B holds the
// tile's hidden states transposed, hs_t (d x (kQTile + 4): each d's queries
// 16-byte aligned), then the prologue's outputs p_s (kQTile x 3*LP).
__host__ __device__ inline int larger(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int fused_region_a(int d, int lp) {
  return (larger(d * 3 * lp, 2 * kQTile * term_stride(4 * lp)) + 3) / 4 * 4;
}

__host__ __device__ inline int fused_region_b(int d, int lp) {
  return larger(d * (kQTile + kFusedHsPad), kQTile * 3 * lp);
}

// 16 bytes from device memory to shared memory without a register (cp.async;
// complete after cp_async_wait_all and, for other threads, a __syncthreads)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n floats from src to dst: cp.async 16 bytes at a time when both are
// 16-byte aligned and n is a multiple of 4, else one load a float
__device__ __forceinline__ void stage_copy(float* __restrict__ dst, const float* __restrict__ src,
                                           int n, int tid, int n_threads) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    for (int i = 4 * tid; i < n; i += 4 * n_threads) cp_async16(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += n_threads) dst[i] = __ldg(src + i);
  }
}

template <typename T, bool kVec, bool kOnePass>
__global__ void __launch_bounds__(kThreads, 2)
msda_fused_sum_kernel(const T* __restrict__ value, const float* __restrict__ hs,
                      const float* __restrict__ w_off, const float* __restrict__ b_off,
                      const float* __restrict__ w_att, const float* __restrict__ b_att,
                      const float* __restrict__ base, const float* __restrict__ scale,
                      const float* __restrict__ lvl_h, const float* __restrict__ lvl_w,
                      const int32_t* __restrict__ lvl_off, float* __restrict__ out,
                      int h_count, int s, int hd, int q, int d, int lp, int discrete) {
  extern __shared__ __align__(16) float smem[];
  const int nc = 3 * lp;  // offset x lanes, offset y lanes, attention logits
  constexpr int kHsStride = kQTile + kFusedHsPad;
  float* wo_s = smem;  // (d, 2*LP)
  float* wa_s = smem + d * 2 * lp;  // (d, LP)
  int2* terms = reinterpret_cast<int2*>(smem);
  float* hs_t = smem + fused_region_a(d, lp);
  float* p_s = hs_t;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, q - q0);
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;

  // staging: the head's weight slices by cp.async, in flight while the
  // tile's hidden states are loaded and stored transposed (consecutive
  // threads take consecutive queries, so the transposed stores hit distinct
  // banks)
  stage_copy(wo_s, w_off + (long long)h * d * 2 * lp, d * 2 * lp, tid, n_threads);
  stage_copy(wa_s, w_att + (long long)h * d * lp, d * lp, tid, n_threads);
  const float* hs_tile = hs + ((long long)b * q + q0) * d;
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0) {
#pragma unroll 4
    for (int i = tid; i < kQTile * (d / 4); i += n_threads) {
      const int r = i % kQTile, k = i / kQTile;
      if (r < nq) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(hs_tile + (long long)r * d) + k);
        hs_t[(4 * k) * kHsStride + r] = pass_operand<kOnePass>(x.x);
        hs_t[(4 * k + 1) * kHsStride + r] = pass_operand<kOnePass>(x.y);
        hs_t[(4 * k + 2) * kHsStride + r] = pass_operand<kOnePass>(x.z);
        hs_t[(4 * k + 3) * kHsStride + r] = pass_operand<kOnePass>(x.w);
      }
    }
  } else {
    for (int i = tid; i < kQTile * d; i += n_threads) {
      const int r = i % kQTile, dd = i / kQTile;
      if (r < nq) hs_t[dd * kHsStride + r] = pass_operand<kOnePass>(__ldg(hs_tile + (long long)r * d + dd));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // prologue, register-blocked: a thread owns kFusedRowBlock queries x one
  // sample's three columns (its x offset, y offset and attention logit) and
  // walks d outermost, each output one fp32 FMA chain in d order from 0 (the
  // plain version's order: the sample locations must agree bit for bit); a
  // d step reads one float4 of hs_t and three weights (consecutive threads,
  // consecutive words) for 12 FMAs. The launcher checks that every
  // micro-tile has a thread. Queries past nq compute on whatever hs_t holds
  // there and are never stored.
  const bool has_tile = tid < (kQTile / kFusedRowBlock) * lp;
  const int rg = tid / lp, l = tid % lp;
  float acc[kFusedRowBlock][3];
#pragma unroll
  for (int i = 0; i < kFusedRowBlock; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[i][k] = 0.0f;
  if (has_tile) {
    const float* h_col = hs_t + rg * kFusedRowBlock;
    const float* wx = wo_s + l;
    const float* wy = wo_s + lp + l;
    const float* wl = wa_s + l;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float4 hv = *reinterpret_cast<const float4*>(h_col + dd * kHsStride);
      const float hq[kFusedRowBlock] = {hv.x, hv.y, hv.z, hv.w};
      // the one-pass mode rounds the weights here (hs_t was rounded as staged)
      const float wv[3] = {pass_operand<kOnePass>(wx[dd * 2 * lp]),
                           pass_operand<kOnePass>(wy[dd * 2 * lp]),
                           pass_operand<kOnePass>(wl[dd * lp])};
#pragma unroll
      for (int i = 0; i < kFusedRowBlock; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[i][k] = fmaf(hq[i], wv[k], acc[i][k]);
    }
  }
  __syncthreads();  // hs_t and the weights are read: p_s and the terms take their places
  if (has_tile) {
    const float bias[3] = {__ldg(b_off + h * 2 * lp + l), __ldg(b_off + h * 2 * lp + lp + l),
                           __ldg(b_att + h * lp + l)};
#pragma unroll
    for (int i = 0; i < kFusedRowBlock; ++i) {
      const int r = rg * kFusedRowBlock + i;
      if (r < nq) {
#pragma unroll
        for (int k = 0; k < 3; ++k) p_s[r * nc + k * lp + l] = acc[i][k] + bias[k];
      }
    }
  }
  __syncthreads();

  // softmax, locations and corners: a warp a query, a lane a sample, as the
  // loc kernel computes them (corner_terms); each query's terms, samples
  // then corners, go to shared memory for the walk
  const int lane = tid & 31;
  const int n_corners = discrete ? 1 : 4;
  const int stride = term_stride(lp * n_corners);
  for (int r = tid >> 5; r < nq; r += n_threads >> 5) {
    const float* p_q = p_s + r * nc;
    const float logit = lane < lp ? p_q[2 * lp + lane] : -INFINITY;
    float m = logit;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = lane < lp ? expf(logit - m) : 0.0f;
    float sum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < lp) {
      const long long bq = ((long long)b * q + q0 + r) * 2 * lp;
      const float x = __fadd_rn(__ldg(base + bq + lane), __fmul_rn(p_q[lane], __ldg(scale + bq + lane)));
      const float y = __fadd_rn(__ldg(base + bq + lp + lane),
                                __fmul_rn(p_q[lp + lane], __ldg(scale + bq + lp + lane)));
      int idx[4];
      float w[4];
      corner_terms(x, y, e / sum, __ldg(lvl_w + lane), __ldg(lvl_h + lane), __ldg(lvl_off + lane),
                   discrete != 0, idx, w);
      put_terms<kOnePass>(terms + r * stride + lane * n_corners, n_corners, idx, w, s,
                          h_count * hd);
    }
  }
  pad_terms(terms, stride, lp * n_corners, nq);
  __syncthreads();

  const T* value_bh = value + ((long long)b * s * h_count + h) * hd;
  float* out_tile = out + (((long long)b * q + q0) * h_count + h) * hd;
  walk_tile<T, kVec, kOnePass>(terms, stride, lp * n_corners, nq, value_bh, hd, h_count * hd,
                               out_tile);
}

// shapes every launcher checks: a grid of (query tiles, H, B), and a row's
// element offset within one image (its S * H * hd) an int
bool bad_grid(int b_count, int h_count, int s, int hd, int q) {
  return b_count < 1 || b_count > 65535 || h_count < 1 || h_count > 65535 || s < 1 || hd < 1 ||
         q < 1 || (long long)s * h_count * hd >= (1LL << 31);
}

template <typename T>
bool vector_rows(const void* value, const void* out, int hd) {
  return hd % 4 == 0 && reinterpret_cast<uintptr_t>(value) % (4 * sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

dim3 tile_grid(int b_count, int h_count, int q) {
  return dim3((q + kQTile - 1) / kQTile, h_count, b_count);
}

// the kernel's dynamic shared memory, raising the 48 KB default where needed
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool kOnePass>
int launch_gather(const void* value, const void* idx, const void* w, void* out, int b_count,
                  int h_count, int s, int hd, int q, int j, void* stream) {
  if (bad_grid(b_count, h_count, s, hd, q) || j < 1 || j > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vector_rows<T>(value, out, hd) ? &msda_gather_sum_kernel<T, true, kOnePass>
                                               : &msda_gather_sum_kernel<T, false, kOnePass>;
  const size_t smem = sizeof(int2) * kQTile * term_stride(j);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tile_grid(b_count, h_count, q), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(value), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), h_count, s, hd, q, j);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kOnePass>
int launch_loc(const void* value, const void* loc, const void* attn, const void* lvl_h,
               const void* lvl_w, const void* lvl_off, void* out, int b_count, int h_count,
               int s, int hd, int q, int lp, int discrete, void* stream) {
  // one lane a sample; loc read as float2
  if (bad_grid(b_count, h_count, s, hd, q) || lp < 1 || lp > kMaxSamples ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vector_rows<T>(value, out, hd) ? &msda_loc_sum_kernel<T, true, kOnePass>
                                               : &msda_loc_sum_kernel<T, false, kOnePass>;
  const size_t smem = sizeof(int2) * kQTile * term_stride(lp * (discrete ? 1 : 4));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tile_grid(b_count, h_count, q), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(lvl_h),
      static_cast<const float*>(lvl_w), static_cast<const int32_t*>(lvl_off),
      static_cast<float*>(out), h_count, s, hd, q, lp, discrete);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kOnePass>
int launch_fused(const void* value, const void* hs, const void* w_off, const void* b_off,
                 const void* w_att, const void* b_att, const void* base, const void* scale,
                 const void* lvl_h, const void* lvl_w, const void* lvl_off, void* out,
                 int b_count, int h_count, int s, int hd, int q, int d, int lp, int discrete,
                 void* stream) {
  // every prologue micro-tile (4 queries x one sample) needs a thread: at
  // the 32-query tile, LP <= 32
  if (bad_grid(b_count, h_count, s, hd, q) || lp < 1 || lp > kMaxSamples ||
      kQTile / kFusedRowBlock * lp > kThreads || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vector_rows<T>(value, out, hd) ? &msda_fused_sum_kernel<T, true, kOnePass>
                                               : &msda_fused_sum_kernel<T, false, kOnePass>;
  const size_t smem = sizeof(float) * ((size_t)fused_region_a(d, lp) + fused_region_b(d, lp));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tile_grid(b_count, h_count, q), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(value), static_cast<const float*>(hs),
      static_cast<const float*>(w_off), static_cast<const float*>(b_off),
      static_cast<const float*>(w_att), static_cast<const float*>(b_att),
      static_cast<const float*>(base), static_cast<const float*>(scale),
      static_cast<const float*>(lvl_h), static_cast<const float*>(lvl_w),
      static_cast<const int32_t*>(lvl_off), static_cast<float*>(out), h_count, s, hd, q, d, lp,
      discrete);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers; the
// stream is the caller's current CUDA stream. value is (B, S, H, hd) and out
// (B, Q, H, hd) fp32 in every entry. Each kernel has four entries: f32 or
// bf16 rows, and the one-pass mode (`_onepass`). Each returns the CUDA error
// of the launch (0 on success). None synchronises or allocates.
#define MSDA_GATHER_ENTRY(NAME, T, ONE_PASS)                                                   \
  extern "C" int NAME(const void* value, const void* idx, const void* w, void* out,           \
                      int b_count, int h_count, int s, int hd, int q, int j, void* stream) {  \
    return launch_gather<T, ONE_PASS>(value, idx, w, out, b_count, h_count, s, hd, q, j,      \
                                      stream);                                                \
  }
MSDA_GATHER_ENTRY(msda_gather_sum_f32, float, false)
MSDA_GATHER_ENTRY(msda_gather_sum_bf16, __nv_bfloat16, false)
MSDA_GATHER_ENTRY(msda_gather_sum_f32_onepass, float, true)
MSDA_GATHER_ENTRY(msda_gather_sum_bf16_onepass, __nv_bfloat16, true)

#define MSDA_LOC_ENTRY(NAME, T, ONE_PASS)                                                      \
  extern "C" int NAME(const void* value, const void* loc, const void* attn,                   \
                      const void* lvl_h, const void* lvl_w, const void* lvl_off, void* out,   \
                      int b_count, int h_count, int s, int hd, int q, int lp, int discrete,   \
                      void* stream) {                                                         \
    return launch_loc<T, ONE_PASS>(value, loc, attn, lvl_h, lvl_w, lvl_off, out, b_count,     \
                                   h_count, s, hd, q, lp, discrete, stream);                  \
  }
MSDA_LOC_ENTRY(msda_loc_sum_f32, float, false)
MSDA_LOC_ENTRY(msda_loc_sum_bf16, __nv_bfloat16, false)
MSDA_LOC_ENTRY(msda_loc_sum_f32_onepass, float, true)
MSDA_LOC_ENTRY(msda_loc_sum_bf16_onepass, __nv_bfloat16, true)

#define MSDA_FUSED_ENTRY(NAME, T, ONE_PASS)                                                    \
  extern "C" int NAME(const void* value, const void* hs, const void* w_off, const void* b_off, \
                      const void* w_att, const void* b_att, const void* base,                 \
                      const void* scale, const void* lvl_h, const void* lvl_w,                \
                      const void* lvl_off, void* out, int b_count, int h_count, int s,        \
                      int hd, int q, int d, int lp, int discrete, void* stream) {             \
    return launch_fused<T, ONE_PASS>(value, hs, w_off, b_off, w_att, b_att, base, scale,      \
                                     lvl_h, lvl_w, lvl_off, out, b_count, h_count, s, hd, q,  \
                                     d, lp, discrete, stream);                                \
  }
MSDA_FUSED_ENTRY(msda_fused_sum_f32, float, false)
MSDA_FUSED_ENTRY(msda_fused_sum_bf16, __nv_bfloat16, false)
MSDA_FUSED_ENTRY(msda_fused_sum_f32_onepass, float, true)
MSDA_FUSED_ENTRY(msda_fused_sum_bf16_onepass, __nv_bfloat16, true)

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
