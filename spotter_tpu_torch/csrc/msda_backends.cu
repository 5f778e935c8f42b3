// The two opt-in MSDA sampling backends (SPOTTER_TPU_MSDA=pallas_sep and
// =pallas_gather), each on the operands the JAX package hands its TPU kernel,
// less the layouts that exist only for the TPU.
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
//    pallas_deformable_sampling, the lane gather, on the model's own value
//    layout: value (B, S, H, hd), read in place (the row of (b, s, h) starts
//    at ((b*S + s)*H + h)*hd), sample-major idx/w (B, H, 4, LP*Q) from the
//    corner prep, out (B, Q, H, hd) in the value's dtype:
//
//        out[b, q, h, d] = sum_j (sum_c w[b, h, c, j*Q + q] * value[b, idx[b, h, c, j*Q + q], h, d])
//
//    with the four slot products and then the LP samples summed in the
//    value's dtype, in that order, as the TPU kernel accumulates. The TPU
//    kernel takes the value as vt (B, H, hd, S) and returns (B, H, hd, Q)
//    because Mosaic's DynamicGather vectorises along lanes only; the JAX
//    package's own XLA path works row-major on the transpose. Here the rows
//    are read where the model holds them, so the backend makes no permute
//    copy of the value or the output. Nothing is padded: any S and Q.
//
// msda_sep_sum's one-pass mode (SPOTTER_TPU_MSDA_PRECISION=default; the
// `_onepass` entries, kOnePass) computes the TPU kernel's two bf16 dots as
// they round: per point and row y, g = bf16(xw0) * bf16(V[y, x0]) +
// bf16(xw1) * bf16(V[y, x0 + 1]) (products exact, one fp32 sum) and
// m = fp32(g * yw); the points' m of each row summed in fp32 in point
// order, that sum rounded to bf16 (the second dot's operand, which a
// gather would forget), and the rows' sums added in fp32. A thread walks
// its query's 2P candidate rows (point, dy) in order; the first candidate
// of a row sums that row's m over itself and the later candidates on it.
// It is a simple loop (a row's loads behind its checks), not the highest
// mode's predicated chunks; msda_sep_reference's "default" is its plain
// version, summed in the same order.
//
// What bounds them on an H100. Both move few bytes per operation: every term
// is one value load and one or two FMAs. sep: at the Deformable-DETR encoder
// (1333x1333 bucket: S = Q = 37,150 tokens over 4 levels, 8 heads of 32,
// 4 points a level) the six query-side operands are 24 bytes per (query,
// point) per level, about 0.9 GB over the four levels at B = 8, against
// 0.3 GB of values and 0.3 GB of output. The value rows of one head's level
// (at most 3.6 MB) stay in the 50 MB L2 while the head's tiles run, so repeat
// row reads are L2 hits. hd_gather: idx + w are 32 bytes per sample and
// corner slot, 1.2 GB at that size, against 0.3 GB of values and 0.3 GB of
// output; its bytes bound is 0.545 ms an encoder op. Both walk the same
// 16 x 4 terms a (query, head), so what remains above the bytes is the same
// work inside the SM: one 16-byte row load and four FMAs (or four adds and
// four products in the value's dtype) a term and thread.
//
// Design: one shape for both, memory-level parallelism.
// - One block of 256 threads per tile of 64 queries (sep: and b*h; hd_gather:
//   and (h, b)) first copies its tile's operands with coalesced loads into
//   shared memory: sep's six operands (6 x P x 64 words, contiguous per
//   operand) and a flag per level row from its row of the hit table (so no
//   division in the inner loop); hd_gather's (row offset, weight) pairs (4
//   slots x LP x 64 x 8 bytes, 32 KB at LP = 16), so idx/w are read from
//   device memory once, not once per group of channels, and each term's
//   checks (index in [0, S), weight not 0) and its row offset are worked
//   out once, not once per thread that reads the row.
// - A thread then takes one query and 4 channels (8 threads cover a 128-byte
//   fp32 row at hd = 32, a warp 4 neighbouring queries) and issues every
//   corner row load of a chunk before any arithmetic: 16-byte loads (8 bytes
//   for bf16 rows), each predicated, with no branch between them; a corner
//   not loaded is 0 and adds exactly nothing. sep's chunk is 4 points (16
//   loads); hd_gather's is one sample (its 4 slots), which keeps a thread
//   within 51 registers and 5 blocks (40 warps) on an SM: on the card a
//   thread with 4 samples' 16 loads in flight (124 registers, 2 blocks an
//   SM) ran the encoder op in 2.34 ms, one sample at a time in 1.47 ms, so
//   the warps an SM holds, not the loads a thread has in flight, hide the
//   latency here.
// - Sums keep their order: sep, points, then dy, then dx, with fmaf(wx * v,
//   wy, acc); hd_gather, each sample's four slot products in slot order,
//   then the samples, every product and add rounded to the value's dtype
//   (__fmul_rn/__fadd_rn, no FMA contraction), so it equals its plain
//   version bit for bit in fp32.
// - Queries stay contiguous within a tile: encoder queries are tokens in
//   level-major, row-major order, so a tile's neighbours sample neighbouring
//   cells and their rows are L1 and L2 hits.
// - Any hd: channels past hd are neither loaded nor written, and an hd that
//   is not a multiple of 4 (or rows not aligned to 4 channels) takes scalar
//   loads. Offsets are 64-bit where they span a launch (at B = 8 one
//   hd_gather launch's idx + w span 1.2 GB); a row's offset within one
//   image is 32-bit (S * H * hd < 2**31, checked).
// - No tensor cores: wgmma has nothing to multiply here.
// What holds hd_gather back now is the work inside the SM: per term and
// thread a shared-memory read, a predicated 16-byte load, and four products
// and four adds that cannot fuse (the TPU's rounding; in bf16 each also
// rounds, which makes the bf16 kernel slower than the fp32 one), about as
// many instructions a term as sep, whose op takes about as long.
// sep's first kernel (one warp a query, a lane a channel, operand loads and
// row loads behind `continue`) ran 13x its bytes bound; tools/sep_probe.py
// times it with the branches predicated, the operands loaded first or staged
// in shared memory, and none of those moves it far; with every sample on
// four L1-resident cells the redesign runs nearly as fast as the real op, so
// what remains is the work inside the SM, not L2. hd_gather's first kernel
// took the TPU's layout: a thread a (query, 8 channels) with eight 4-byte
// loads from eight rows of vt at stride S a term, a sector each, behind a
// branch, and idx/w read once per 8 channels. On an H100 80GB HBM3 at
// 700 W one encoder op at B = 8 takes ~1.65 ms under sep (2.3x its bytes
// bound; 9.5 ms under its first kernel) and ~1.47 ms under hd_gather (2.7x
// its 0.545 ms bound; 5.75 ms under its first kernel); PERF.md has the runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_rows.cuh"

namespace {

using msda_rows::load_quad;
using msda_rows::round_to;
using msda_rows::store_quad;

constexpr int kSepQTile = 64;  // the JAX package's Q_TILE
constexpr int kSepThreads = 256;
constexpr int kSepPointChunk = 4;  // points whose rows a thread loads before it sums them
constexpr int kGatherQTile = 64;  // queries of one msda_hd_gather_sum block (a power of 2)
constexpr int kGatherThreads = 256;
// blocks an SM the registers must allow (<= 51 a thread): one sample's four
// row loads a thread in flight, but 40 warps an SM to hide their latency
constexpr int kGatherMinBlocks = 5;
constexpr int kSlots = 4;  // corner slots of the lane layout

// the one-pass mode's m for one candidate row: g = bf16(xw0) * bf16(V[y, x0])
// + bf16(xw1) * bf16(V[y, x0 + 1]) over 4 channels, times yw, 0 where the row
// is outside the level, in a band left out, or of weight 0
template <typename T, bool kVec>
__device__ __forceinline__ void sep_row_term(const T* __restrict__ rows_bh, int y, int x0,
                                             float xw0, float xw1, float yw, bool row_ok,
                                             int lw, int hd, int c, float (&m)[4]) {
  const int row_stride = lw * hd;
  const T* p = rows_bh + (long long)(row_ok ? y : 0) * row_stride + c;
  const float a0 = round_to<__nv_bfloat16>(xw0), a1 = round_to<__nv_bfloat16>(xw1);
  float v0[4], v1[4];
  const bool on = row_ok && yw != 0.0f;
  const bool on0 = on && static_cast<unsigned>(x0) < static_cast<unsigned>(lw) && a0 != 0.0f;
  const bool on1 = on && static_cast<unsigned>(x0 + 1) < static_cast<unsigned>(lw) && a1 != 0.0f;
  load_quad<T, kVec>(p + (long long)(on0 ? x0 : 0) * hd, c, hd, on0, v0);
  load_quad<T, kVec>(p + (long long)(on1 ? x0 + 1 : 0) * hd, c, hd, on1, v1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float g = __fadd_rn(__fmul_rn(a0, round_to<__nv_bfloat16>(v0[e])),
                              __fmul_rn(a1, round_to<__nv_bfloat16>(v1[e])));
    m[e] = on ? __fmul_rn(g, yw) : 0.0f;
  }
}

template <typename T, bool kVec, bool kOnePass>
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
  if (kOnePass) {
    for (int item = threadIdx.x; item < kSepQTile * quads; item += kSepThreads) {
      const int qi = item / quads;
      const int c = (item % quads) * 4;
      float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int p = 0; p < n_points; ++p) {
        const int y0 = s_yi[p * kSepQTile + qi];
        for (int dy = 0; dy < 2; ++dy) {
          const int y = y0 + dy;
          bool first = true;  // no earlier point has a candidate on row y
          for (int pe = 0; pe < p; ++pe) {
            const int ye = s_yi[pe * kSepQTile + qi];
            first = first && ye != y && ye + 1 != y;
          }
          if (!first) continue;
          const bool row_ok = static_cast<unsigned>(y) < static_cast<unsigned>(lh) &&
                              row_on[static_cast<unsigned>(y) < static_cast<unsigned>(lh) ? y : 0] != 0;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int pl = p; pl < n_points; ++pl) {
            const int o = pl * kSepQTile + qi;
            const int dyl = pl == p ? dy : y - s_yi[o];  // which of pl's rows is y
            if (dyl != 0 && dyl != 1) continue;
            float m[4];
            sep_row_term<T, kVec>(rows_bh, y, s_xi[o], s_w[o], s_w[n_ops + o],
                                  s_w[(2 + dyl) * n_ops + o], row_ok, lw, hd, c, m);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], m[e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[e] = __fadd_rn(total[e], round_to<__nv_bfloat16>(acc[e]));
          }
        }
      }
      store_quad<kVec>(out_tile + (long long)qi * hd + c, c, hd, total);
    }
    return;
  }
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
    store_quad<kVec>(out_tile + (long long)qi * hd + c, c, hd, acc);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kGatherThreads, kGatherMinBlocks)
msda_hd_gather_sum_kernel(const T* __restrict__ value, const int32_t* __restrict__ idx,
                          const float* __restrict__ w, T* __restrict__ out, int h_count, int s,
                          int hd, int q, int lp) {
  // this tile's terms, [slot][sample][query]: .x the row's element offset
  // from the (b, 0, h) row, or -1 where nothing is loaded (an index outside
  // [0, S), a weight that rounds to 0, a query past Q); .y the weight's bits,
  // rounded to T
  extern __shared__ int2 s_terms[];
  const int q0 = blockIdx.x * kGatherQTile;
  const int nq = min(kGatherQTile, q - q0);
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * h_count + h;
  const long long term0 = bh * kSlots * lp * (long long)q;  // (slot, sample) row r at term0 + r * q
  const int row_stride = h_count * hd;  // the launcher checks S * H * hd < 2**31
  const int n_staged = kSlots * lp * kGatherQTile;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_staged; i += kGatherThreads) {
    const int r = i / kGatherQTile;  // slot * lp + sample
    const int qi = i % kGatherQTile;
    int2 t = make_int2(-1, 0);
    if (qi < nq) {
      const long long o = term0 + (long long)r * q + q0 + qi;
      const int sk = __ldg(idx + o);
      const float wk = round_to<T>(__ldg(w + o));
      const bool on = static_cast<unsigned>(sk) < static_cast<unsigned>(s) && wk != 0.0f;
      t = make_int2(on ? sk * row_stride : -1, __float_as_int(wk));
    }
    s_terms[i] = t;
  }
  __syncthreads();

  // the value rows of (b, :, h): row s at value_bh + s * H * hd
  const T* value_bh = value + (b * s * h_count + h) * (long long)hd;
  T* out_tile = out + ((b * q + q0) * h_count + h) * (long long)hd;
  const int quads = (hd + 3) / 4;
  for (int item = threadIdx.x; item < nq * quads; item += kGatherThreads) {
    const int qi = item / quads;
    const int c = (item % quads) * 4;
    float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < lp; ++j) {
      // the sample's four corner rows first, each load predicated, no
      // branch between them; a corner not loaded is 0 and adds exactly nothing
      float v[kSlots][4];
      float wk[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int2 t = s_terms[(k * lp + j) * kGatherQTile + qi];
        wk[k] = __int_as_float(t.y);
        load_quad<T, kVec>(value_bh + max(t.x, 0) + c, c, hd, t.x >= 0, v[k]);
      }
      // then the sums in the TPU kernel's order and dtype: the four slot
      // products in slot order, then the sample onto the total, each product
      // and add rounded to T
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = round_to<T>(__fadd_rn(acc[e], round_to<T>(__fmul_rn(v[k][e], wk[k]))));
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) total[e] = round_to<T>(__fadd_rn(total[e], acc[e]));
    }
    store_quad<kVec>(out_tile + (long long)qi * row_stride + c, c, hd, total);
  }
}

template <typename T, bool kOnePass>
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
  auto kernel = vec ? &msda_sep_sum_kernel<T, true, kOnePass>
                    : &msda_sep_sum_kernel<T, false, kOnePass>;
  kernel<<<grid, kSepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(xi),
      static_cast<const float*>(xw0), static_cast<const float*>(xw1),
      static_cast<const int32_t*>(yi), static_cast<const float*>(yw0),
      static_cast<const float*>(yw1), static_cast<const int32_t*>(mask),
      static_cast<float*>(out), n_qt, n_points, lh, lw, hd, r_band, n_bands);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd_gather(const void* value, const void* idx, const void* w, void* out, int b_count,
                     int h_count, int s, int hd, int q, int lp, void* stream) {
  // a row's element offset within one image is an int
  if (b_count < 1 || b_count > 65535 || h_count < 1 || h_count > 65535 || s < 1 || hd < 1 ||
      q < 1 || lp < 1 || (long long)s * h_count * hd >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int2) * kSlots * (size_t)lp * kGatherQTile;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // vector loads and stores need every row (and output row) aligned to 4 channels
  const size_t quad_bytes = 4 * sizeof(T);
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(value) % quad_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % quad_bytes == 0;
  auto kernel = vec ? &msda_hd_gather_sum_kernel<T, true> : &msda_hd_gather_sum_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((q + kGatherQTile - 1) / kGatherQTile, h_count, b_count);
  kernel<<<grid, kGatherThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(value), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), h_count, s, hd, q, lp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers; the
// stream is the caller's current CUDA stream. Each returns the CUDA error of
// the launch (0 on success). None synchronises or allocates.

// msda_sep_sum's four entries: f32 or bf16 rows, and the one-pass mode
#define MSDA_SEP_ENTRY(NAME, T, ONE_PASS)                                                      \
  extern "C" int NAME(const void* rows, const void* xi, const void* xw0, const void* xw1,     \
                      const void* yi, const void* yw0, const void* yw1, const void* mask,     \
                      void* out, int bh_count, int n_qt, int n_points, int lh, int lw,        \
                      int hd, int r_band, int n_bands, void* stream) {                        \
    return launch_sep<T, ONE_PASS>(rows, xi, xw0, xw1, yi, yw0, yw1, mask, out, bh_count,     \
                                   n_qt, n_points, lh, lw, hd, r_band, n_bands, stream);      \
  }
MSDA_SEP_ENTRY(msda_sep_sum_f32, float, false)
MSDA_SEP_ENTRY(msda_sep_sum_bf16, __nv_bfloat16, false)
MSDA_SEP_ENTRY(msda_sep_sum_f32_onepass, float, true)
MSDA_SEP_ENTRY(msda_sep_sum_bf16_onepass, __nv_bfloat16, true)

extern "C" int msda_hd_gather_sum_f32(const void* value, const void* idx, const void* w,
                                      void* out, int b_count, int h_count, int s, int hd, int q,
                                      int lp, void* stream) {
  return launch_hd_gather<float>(value, idx, w, out, b_count, h_count, s, hd, q, lp, stream);
}

extern "C" int msda_hd_gather_sum_bf16(const void* value, const void* idx, const void* w,
                                       void* out, int b_count, int h_count, int s, int hd, int q,
                                       int lp, void* stream) {
  return launch_hd_gather<__nv_bfloat16>(value, idx, w, out, b_count, h_count, s, hd, q, lp,
                                         stream);
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
