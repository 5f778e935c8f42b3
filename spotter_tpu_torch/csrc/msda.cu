// Multiscale deformable attention (MSDA) sampling: three kernels that compute
// the same weighted row gather-sum, with more of the work inside each.
//
//     out[bh, q, :] = sum_j w[bh, q, j] * rows[bh, idx[bh, q, j], :]
//
// accumulated and returned in fp32, over the J = levels * points * corners
// sample terms of each (b*h, query).
//
// 1. msda_gather_sum takes idx/w from the plain-torch corner prep
//    (spotter_tpu_torch/ops/msda.py::prepare_msda_gather). It replaces
//    spotter_tpu/ops/msda.py::pallas_onehot_sampling_merged.
// 2. msda_loc_sum takes the raw sample coordinates and attention weights and
//    does the corner prep (_corner_terms: floor, bilinear weights, validity,
//    clamped indices) itself. It replaces pallas_onehot_sampling_merged_loc.
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
// Design of the gather-sum and loc kernels, first and simple: one warp per
// (bh, q), the 32 lanes over hd (hd = 32 on this model: one lane per
// channel, so each sample term is one coalesced 128-byte row read followed
// by an fp32 FMA; hd != 32 loops over channels in steps of 32). In the loc
// kernel, lane l < LP computes sample l's corners (one, or four) in
// registers, and the walk broadcasts each corner's (idx, w) to all lanes
// with a shuffle. An index < 0 or >= S is skipped, so a bad index can never
// read out of bounds. The corner arithmetic uses round-to-nearest
// intrinsics (no FMA contraction) so that it rounds exactly as the plain
// torch version does, which matters for the discrete method's nearest-cell
// rounding.
//
// The fused kernel's block owns one (b, h) and a tile of kFusedQTile = 32
// queries, 256 threads (no query is padded, the ragged last tile is
// masked), in four phases:
// - staging: the head's weight slices (D x 3*LP fp32, 36 KB at D = 256,
//   LP = 12) by cp.async, in flight while the tile's hidden states are
//   loaded 16 bytes at a time and stored transposed to (D, kFusedQTile);
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
// - the walk: a thread a (query, 4 channels) with 16-byte row loads, every
//   load of a chunk of 8 terms issued before its FMAs, predicated on an
//   index in [0, S) and a non-zero weight; the FMAs in term order (samples,
//   then corners), fmaf(w, v, acc), as the loc kernel sums.
// On an H100 80GB HBM3 at 700 W the op takes ~0.069 ms at B = 8 (5x its
// 0.0134 ms bytes bound) and ~0.024 ms at B = 1; 32-query tiles beat 16 and
// 64 at both (tools/fused_tile_probe.py). The first fused kernel (one prologue output a thread, two
// shared-memory reads a FMA; the walk one warp a query, each term a shuffle
// pair and a branch before a 4-byte load) took 0.238 ms at B = 8, 18x its
// bound. What holds it back now: every block copies its head's 36 KB of
// weights and its tile's 32 KB of hidden states from L2 (640 blocks at B =
// 8), 72 KB of shared memory allow 3 blocks an SM, and 96 of a block's 256
// threads run the prologue. PERF.md has the runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msda_rows.cuh"

namespace {

using msda_rows::load_quad;
using msda_rows::store_quad;

constexpr int kWarpsPerBlock = 4;
// queries of one fused block: 32 was the fastest of 16, 32 and 64 at B = 1
// and 8 (tools/fused_tile_probe.py builds the other two)
#ifndef MSDA_FUSED_Q_TILE
#define MSDA_FUSED_Q_TILE 32
#endif
constexpr int kFusedQTile = MSDA_FUSED_Q_TILE;
constexpr int kFusedThreads = kFusedQTile >= 32 ? 256 : 128;
constexpr int kFusedRowBlock = 4;  // queries of a prologue thread's micro-tile
constexpr int kFusedHsPad = 4;  // hs_t's row pad: each d's queries stay 16-byte aligned
constexpr int kFusedTermChunk = 8;  // terms whose rows a walk thread loads before it sums them

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Weighted sum over `n_samples` samples of `n_corners` terms each, held by
// lane l < n_samples in idx[]/w[]; the warp writes out_q[0:hd].
template <typename T>
__device__ __forceinline__ void walk_terms(const T* __restrict__ rows_bh, int s, int hd,
                                           float* __restrict__ out_q, int lane, int n_samples,
                                           int n_corners, const int (&idx)[4],
                                           const float (&w)[4]) {
  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool lane_on = c < hd;
    float acc = 0.0f;
    for (int l = 0; l < n_samples; ++l) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n_corners) {
          const int sk = __shfl_sync(0xffffffffu, idx[k], l);
          const float wk = __shfl_sync(0xffffffffu, w[k], l);
          if (lane_on && sk >= 0 && sk < s) {
            acc = fmaf(wk, load_as_float(rows_bh + (long long)sk * hd + c), acc);
          }
        }
      }
    }
    if (lane_on) out_q[c] = acc;
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

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_gather_sum_kernel(const T* __restrict__ rows, const int32_t* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int bh_count, int s, int hd, int q, int j) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)bh_count * q) return;  // whole warp exits together
  const long long bh = warp / q;

  const int32_t* idx_q = idx + warp * j;
  const float* w_q = w + warp * j;
  const T* rows_bh = rows + bh * (long long)s * hd;
  float* out_q = out + warp * hd;

  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool lane_on = c < hd;
    float acc = 0.0f;
    for (int j0 = 0; j0 < j; j0 += 32) {
      const int jj = j0 + lane;
      int32_t my_s = -1;
      float my_w = 0.0f;
      if (jj < j) {
        my_s = __ldg(idx_q + jj);
        my_w = __ldg(w_q + jj);
      }
      const int n = min(32, j - j0);
      for (int k = 0; k < n; ++k) {
        const int32_t sk = __shfl_sync(0xffffffffu, my_s, k);
        const float wk = __shfl_sync(0xffffffffu, my_w, k);
        if (lane_on && sk >= 0 && sk < s) {
          acc = fmaf(wk, load_as_float(rows_bh + (long long)sk * hd + c), acc);
        }
      }
    }
    if (lane_on) out_q[c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_loc_sum_kernel(const T* __restrict__ rows, const float* __restrict__ xy,
                    const float* __restrict__ attn, const float* __restrict__ lvl_h,
                    const float* __restrict__ lvl_w, const int32_t* __restrict__ lvl_off,
                    float* __restrict__ out, int bh_count, int s, int hd, int q, int lp,
                    int discrete) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)bh_count * q) return;  // whole warp exits together
  const long long bh = warp / q;

  int idx[4] = {-1, -1, -1, -1};
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < lp) {
    const float* xy_q = xy + warp * 2 * lp;
    corner_terms(__ldg(xy_q + lane), __ldg(xy_q + lp + lane), __ldg(attn + warp * lp + lane),
                 __ldg(lvl_w + lane), __ldg(lvl_h + lane), __ldg(lvl_off + lane),
                 discrete != 0, idx, w);
  }
  walk_terms(rows + bh * (long long)s * hd, s, hd, out + warp * hd, lane, lp,
             discrete ? 1 : 4, idx, w);
}

// The fused block's shared memory, in floats, two regions reused between
// phases: A holds the head's two weight slices as they lie in memory, w_off's
// (d x 2*LP) then w_att's (d x LP), for the prologue, then the tile's terms
// (kFusedQTile rows of fused_term_stride (index, weight) pairs); B holds the
// tile's hidden states transposed, hs_t (d x (kFusedQTile + 4): each d's queries
// 16-byte aligned), then the prologue's outputs p_s (kFusedQTile x 3*LP).
__host__ __device__ inline int fused_term_stride(int lp) { return 4 * lp + 1; }  // odd: no bank conflicts

__host__ __device__ inline int larger(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int fused_region_a(int d, int lp) {
  return (larger(d * 3 * lp, 2 * kFusedQTile * fused_term_stride(lp)) + 3) / 4 * 4;
}

__host__ __device__ inline int fused_region_b(int d, int lp) {
  return larger(d * (kFusedQTile + kFusedHsPad), kFusedQTile * 3 * lp);
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kFusedThreads, 2)
msda_fused_sum_kernel(const T* __restrict__ rows, const float* __restrict__ hs,
                      const float* __restrict__ w_off, const float* __restrict__ b_off,
                      const float* __restrict__ w_att, const float* __restrict__ b_att,
                      const float* __restrict__ base, const float* __restrict__ scale,
                      const float* __restrict__ lvl_h, const float* __restrict__ lvl_w,
                      const int32_t* __restrict__ lvl_off, float* __restrict__ out,
                      int h_count, int s, int hd, int q, int d, int lp, int discrete) {
  extern __shared__ __align__(16) float smem[];
  const int nc = 3 * lp;  // offset x lanes, offset y lanes, attention logits
  constexpr int kHsStride = kFusedQTile + kFusedHsPad;
  float* wo_s = smem;  // (d, 2*LP)
  float* wa_s = smem + d * 2 * lp;  // (d, LP)
  int2* terms = reinterpret_cast<int2*>(smem);
  float* hs_t = smem + fused_region_a(d, lp);
  float* p_s = hs_t;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kFusedQTile;
  const int nq = min(kFusedQTile, q - q0);
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
    for (int i = tid; i < kFusedQTile * (d / 4); i += n_threads) {
      const int r = i % kFusedQTile, k = i / kFusedQTile;
      if (r < nq) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(hs_tile + (long long)r * d) + k);
        hs_t[(4 * k) * kHsStride + r] = x.x;
        hs_t[(4 * k + 1) * kHsStride + r] = x.y;
        hs_t[(4 * k + 2) * kHsStride + r] = x.z;
        hs_t[(4 * k + 3) * kHsStride + r] = x.w;
      }
    }
  } else {
    for (int i = tid; i < kFusedQTile * d; i += n_threads) {
      const int r = i % kFusedQTile, dd = i / kFusedQTile;
      if (r < nq) hs_t[dd * kHsStride + r] = __ldg(hs_tile + (long long)r * d + dd);
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
  const bool has_tile = tid < (kFusedQTile / kFusedRowBlock) * lp;
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
      const float wv[3] = {wx[dd * 2 * lp], wy[dd * 2 * lp], wl[dd * lp]};
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
  const int term_stride = fused_term_stride(lp);
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
      int2* t = terms + r * term_stride + lane * n_corners;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n_corners) t[k] = make_int2(idx[k], __float_as_int(w[k]));
      }
    }
  }
  __syncthreads();

  // the walk: a thread a (query, 4 channels); for kFusedTermChunk terms at a
  // time every row load first, predicated on an index in [0, S) and a
  // non-zero weight, no branch between them; then the FMAs in term order
  // (samples, then corners), fmaf(w, v, acc) as the loc kernel sums
  const long long bh = (long long)b * h_count + h;
  const T* rows_bh = rows + bh * (long long)s * hd;
  float* out_tile = out + (bh * q + q0) * hd;
  const int n_terms = lp * n_corners;
  const int quads = (hd + 3) / 4;
  for (int item = tid; item < nq * quads; item += n_threads) {
    const int r = item / quads;
    const int c = (item % quads) * 4;
    const int2* t_q = terms + r * term_stride;
    float sum4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t0 = 0; t0 < n_terms; t0 += kFusedTermChunk) {
      float v[kFusedTermChunk][4];
      float wt[kFusedTermChunk];
#pragma unroll
      for (int k = 0; k < kFusedTermChunk; ++k) {
        const bool term_on = t0 + k < n_terms;
        const int2 tk = t_q[term_on ? t0 + k : 0];
        wt[k] = __int_as_float(tk.y);
        const bool on = term_on && static_cast<unsigned>(tk.x) < static_cast<unsigned>(s) &&
                        wt[k] != 0.0f;
        load_quad<T, kVec>(rows_bh + (long long)(on ? tk.x : 0) * hd + c, c, hd, on, v[k]);
      }
#pragma unroll
      for (int k = 0; k < kFusedTermChunk; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum4[e] = fmaf(wt[k], v[k][e], sum4[e]);
    }
    store_quad<kVec>(out_tile + (long long)r * hd + c, c, hd, sum4);
  }
}

int warp_grid(long long warps) {
  return (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T>
int launch_gather(const void* rows, const void* idx, const void* w, void* out, int bh_count,
                  int s, int hd, int q, int j, void* stream) {
  msda_gather_sum_kernel<T><<<warp_grid((long long)bh_count * q), kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), bh_count, s, hd, q, j);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_loc(const void* rows, const void* xy, const void* attn, const void* lvl_h,
               const void* lvl_w, const void* lvl_off, void* out, int bh_count, int s, int hd,
               int q, int lp, int discrete, void* stream) {
  if (lp < 1 || lp > 32) return static_cast<int>(cudaErrorInvalidValue);
  msda_loc_sum_kernel<T><<<warp_grid((long long)bh_count * q), kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const float*>(xy),
      static_cast<const float*>(attn), static_cast<const float*>(lvl_h),
      static_cast<const float*>(lvl_w), static_cast<const int32_t*>(lvl_off),
      static_cast<float*>(out), bh_count, s, hd, q, lp, discrete);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const void* rows, const void* hs, const void* w_off, const void* b_off,
                 const void* w_att, const void* b_att, const void* base, const void* scale,
                 const void* lvl_h, const void* lvl_w, const void* lvl_off, void* out,
                 int b_count, int h_count, int s, int hd, int q, int d, int lp, int discrete,
                 void* stream) {
  // every prologue micro-tile (4 queries x one sample) needs a thread: at
  // the 32-query tile, LP <= 32
  if (lp < 1 || lp > 32 || kFusedQTile / kFusedRowBlock * lp > kFusedThreads || d < 1 ||
      hd < 1 || h_count > 65535 || b_count > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * ((size_t)fused_region_a(d, lp) + fused_region_b(d, lp));
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? &msda_fused_sum_kernel<T, true> : &msda_fused_sum_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q + kFusedQTile - 1) / kFusedQTile, h_count, b_count);
  kernel<<<grid, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const float*>(hs),
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
// stream is the caller's current CUDA stream. Each returns the CUDA error of
// the launch (0 on success). None synchronises or allocates.
extern "C" int msda_gather_sum_f32(const void* rows, const void* idx, const void* w,
                                   void* out, int bh_count, int s, int hd, int q, int j,
                                   void* stream) {
  return launch_gather<float>(rows, idx, w, out, bh_count, s, hd, q, j, stream);
}

extern "C" int msda_gather_sum_bf16(const void* rows, const void* idx, const void* w,
                                    void* out, int bh_count, int s, int hd, int q, int j,
                                    void* stream) {
  return launch_gather<__nv_bfloat16>(rows, idx, w, out, bh_count, s, hd, q, j, stream);
}

extern "C" int msda_loc_sum_f32(const void* rows, const void* xy, const void* attn,
                                const void* lvl_h, const void* lvl_w, const void* lvl_off,
                                void* out, int bh_count, int s, int hd, int q, int lp,
                                int discrete, void* stream) {
  return launch_loc<float>(rows, xy, attn, lvl_h, lvl_w, lvl_off, out, bh_count, s, hd, q, lp,
                           discrete, stream);
}

extern "C" int msda_loc_sum_bf16(const void* rows, const void* xy, const void* attn,
                                 const void* lvl_h, const void* lvl_w, const void* lvl_off,
                                 void* out, int bh_count, int s, int hd, int q, int lp,
                                 int discrete, void* stream) {
  return launch_loc<__nv_bfloat16>(rows, xy, attn, lvl_h, lvl_w, lvl_off, out, bh_count, s, hd,
                                   q, lp, discrete, stream);
}

extern "C" int msda_fused_sum_f32(const void* rows, const void* hs, const void* w_off,
                                  const void* b_off, const void* w_att, const void* b_att,
                                  const void* base, const void* scale, const void* lvl_h,
                                  const void* lvl_w, const void* lvl_off, void* out,
                                  int b_count, int h_count, int s, int hd, int q, int d, int lp,
                                  int discrete, void* stream) {
  return launch_fused<float>(rows, hs, w_off, b_off, w_att, b_att, base, scale, lvl_h, lvl_w,
                             lvl_off, out, b_count, h_count, s, hd, q, d, lp, discrete, stream);
}

extern "C" int msda_fused_sum_bf16(const void* rows, const void* hs, const void* w_off,
                                   const void* b_off, const void* w_att, const void* b_att,
                                   const void* base, const void* scale, const void* lvl_h,
                                   const void* lvl_w, const void* lvl_off, void* out,
                                   int b_count, int h_count, int s, int hd, int q, int d, int lp,
                                   int discrete, void* stream) {
  return launch_fused<__nv_bfloat16>(rows, hs, w_off, b_off, w_att, b_att, base, scale, lvl_h,
                                     lvl_w, lvl_off, out, b_count, h_count, s, hd, q, d, lp,
                                     discrete, stream);
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
