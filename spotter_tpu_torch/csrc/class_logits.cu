// OWL-ViT / OWLv2 class-logit head: normalize, cosine product, affine and
// query mask in one pass,
//
//     n         = sqrt(sum_d img[r, d]^2) + 1e-6
//     out[r, q] = (img[r, :] . bank[q, :] / n + shift[r]) * (elu(scale[r]) + 1)
//     out[r, q] = NEG_INF (float32 min) where mask[q] == 0
//
// for every patch row r of the (B*P, Dt) dense0 output, against the
// pre-normalized (Q, Dt) query bank. It replaces the Pallas kernel
// spotter_tpu/ops/openvocab.py::pallas_class_logits (body
// _class_logits_kernel). The TPU kernel pads P to 128 rows and Q to 128
// lanes; here rows past B*P and queries past Q are never written.
//
// What bounds it on an H100: bytes. At OWLv2 (B = 8, P = 3600, Dt = 512,
// Q = 22) the img read is 59 MB, 17.6 us at 3.35 TB/s. The product is
// 0.65 GFLOP: ~10 us of fp32 FMAs on the CUDA cores, plus one shared-memory
// read of the bank per 16 FMAs, so a design that loads rows, then computes,
// then loads again spends about as long computing as loading, one after the
// other. This one keeps the stream of rows going and moves the arithmetic to
// the tensor cores:
//
// - a persistent grid: one block an SM (fewer when there are fewer 64-row
//   tiles), each walking 64-row tiles of img with a stride of the grid;
// - two consumer warpgroups take the block's tiles in turn, each fed by its
//   own producer warp through its own ring of 4 stages (8 stages, 64 KB in
//   flight an SM), with a full and an empty mbarrier each: while one
//   warpgroup finishes a tile (its last wgmmas, its epilogue), the other's
//   slabs keep streaming. With one consumer, that work stalled the stream at
//   every tile. A slab is 64 rows x 128 bytes (32 fp32 or 64 bf16 columns),
//   128-byte swizzled; TMA fills rows past B*P and columns past Dt with
//   zeros, which add nothing to the product or the norm;
// - a consumer warpgroup reads its A fragments of a slab from shared memory
//   (two 16-byte loads a row, conflict-free under the swizzle), adds the
//   squares to its rows' sums, splits each fp32 value into two TF32 terms
//   (x = hi + lo) and issues wgmma m64nNk8 with A from registers, freeing
//   the stage once the wgmma fence has seen those registers written and a
//   proxy fence has ordered its reads before TMA's next write there. Split
//   TF32 keeps fp32 accuracy as in the fp32 attention kernel (one term alone
//   fails the fp32 gate); bf16 img widens exactly to TF32, so its lo is 0.
//   Two register sets alternate, so a slab's wgmmas run while the next slab
//   is read;
// - the bank tile, NT = 8, 16, 24 or 40 queries (Q = 22 takes 24; the widest
//   that fits shared memory beside the ring, so fewer at large Dt), comes by
//   TMA ahead of the first slab (plain loads of it, 32 rows to a warp
//   instruction, held back the first tiles), and the consumers split it in
//   place into hi and lo: one B operand of 2 NT rows, hi above lo, K-major
//   with the same swizzle. One wgmma of N = 2 NT takes an A term against
//   both, so a k-step is two wgmmas for fp32 img (hi and lo of A; the lo.lo
//   products come along) and one for bf16. The stream of slabs, not the
//   tensor cores, sets the pace. A thread's A columns
//   are a contiguous run of the slab row, so the bank's columns are
//   permuted to match (the product's sum does not care in which order k
//   runs). More queries loop over query tiles and stream img again;
// - the epilogue finishes each row's sum of squares with two quad shuffles,
//   adds the product's hi and lo columns, scales by the norm's reciprocal
//   (after the product, as before), applies shift, elu-scale and the mask,
//   and stores each logit once.
//
// TMA needs img 16-byte aligned with rows a multiple of 16 bytes apart;
// Dt is a multiple of 4, so fp32 always qualifies, and bf16 with Dt % 8 != 0
// does not (the wrapper widens such img to fp32 first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTileRows = 64;  // rows a tile: wgmma's M
constexpr int kConsumers = 2;  // warpgroups, each with its own tiles, producer and ring
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32 * kConsumers;  // + a producer warp each
constexpr int kStages = 8;  // of all rings: 64 KB in flight an SM
constexpr int kRingStages = kStages / kConsumers;
constexpr int kSlabBytes = kTileRows * 128;
constexpr int kMaxDt = 1024;
constexpr int kConsumerBarrier = 1;  // named barrier of the consumer warpgroups
constexpr int kQueryTiles[] = {8, 16, 24, 40};  // wgmma N: twice these

template <typename T>
struct Img;

template <>
struct Img<float> {
  static constexpr int kWidth = 32;  // columns a slab (128 bytes)
  static constexpr bool kSplit = true;  // A's lo term: two wgmmas a k-step
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // the 4 values of a 16-byte chunk
  static __device__ __forceinline__ void widen(uint4 raw, float* x) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Img<__nv_bfloat16> {
  static constexpr int kWidth = 64;
  static constexpr bool kSplit = false;  // exact in TF32: one wgmma a k-step
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // the 8 values of a 16-byte chunk, each bf16 widened exactly (the lower
  // address in the low half of each word)
  static __device__ __forceinline__ void widen(uint4 raw, float* x) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Dynamic shared memory of a block: 1 KB of alignment slack, the ring, the
// bank tile (slabs * W columns of NT queries, each a hi and a lo row), the
// ring's barriers and the bank tile's.
__host__ __device__ constexpr size_t smem_bytes(int nt, int slabs, int w) {
  return 1024 + static_cast<size_t>(kStages) * kSlabBytes +
         2 * static_cast<size_t>(slabs) * w * nt * sizeof(float) +
         (2 * kStages + 2) * sizeof(uint64_t);
}

// The bank tile as one B operand of 2 NT rows, K-major: row n holds query
// n's hi TF32 term and row NT + n its lo term, so one wgmma of N = 2 NT
// multiplies an A term by both. For 8-column k-step ks, row n's 8 values
// lie in 32-column block ks / 4 (2 NT rows of 128 bytes, 128-byte swizzled)
// at columns 8 (ks % 4) .. + 7. The A fragment's column c of a k-step (t or
// t + 4 for lane t of a quad) is img column kPer * (c % 4) + 2 kk + c / 4 of
// its slab (kk the k-step within the slab), so the bank's columns go where
// those are read. TMA has put the raw queries of each block in its lo rows
// (zeros past Q and Dt); a thread takes (query n, slab s) pairs, reads row
// n of the slab's blocks into registers and writes them back split, in the
// same blocks: no other thread reads those rows. Each k-step is two 16-byte
// chunks of hi and of lo, columns 4 h .. 4 h + 3 being slab columns
// kPer c + 2 kk + h, c = 0 .. 3. Neighbouring threads take neighbouring
// queries, so their 16-byte loads and stores differ in the swizzle's XOR:
// no bank conflicts.
template <int W, int NT>
__device__ __forceinline__ void split_bank(float* bank_s, int slabs) {
  constexpr int kSteps = W / 8;    // k-steps a slab
  constexpr int kPer = W / 4;      // columns of a slab row one lane holds
  constexpr int kBlocks = W / 32;  // 32-column blocks a slab
  const int items = NT * slabs;
  for (int i = threadIdx.x; i < items; i += kConsumerThreads) {
    const int n = i % NT;
    const int s = i / NT;
    float x[W];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      const float* raw = bank_s + (s * kBlocks + b) * (2 * NT * 32) + (NT + n) * 32;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(raw + ((j ^ (n & 7)) << 2));
        x[32 * b + 4 * j] = v.x;
        x[32 * b + 4 * j + 1] = v.y;
        x[32 * b + 4 * j + 2] = v.z;
        x[32 * b + 4 * j + 3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int ks = s * kSteps + kk;
      float* block = bank_s + (ks >> 2) * (2 * NT * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(x[kPer * c + 2 * kk + h], hi[c], lo[c]);
        // rows n and NT + n share n % 8, so the swizzle's XOR
        const int chunk = ((2 * (ks & 3) + h) ^ (n & 7)) * 4;
        *reinterpret_cast<uint4*>(block + n * 32 + chunk) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(block + (NT + n) * 32 + chunk) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
class_logits_kernel(const __grid_constant__ CUtensorMap img_map,
                    const __grid_constant__ CUtensorMap bank_map,
                    const float* __restrict__ shift, const float* __restrict__ scale,
                    const int* __restrict__ mask, float* __restrict__ out, int rows, int dt,
                    int q_count) {
  using I = Img<T>;
  constexpr int W = I::kWidth;
  constexpr int kSteps = W / 8;    // k-steps a slab
  constexpr int kPer = W / 4;      // columns of a slab row one lane holds
  constexpr int kGroups = NT / 8;  // 8-query column groups of the accumulator
  extern __shared__ char smem_raw[];
  char* const ring = align_1024(smem_raw);
  const int slabs = (dt + W - 1) / W;
  float* const bank_s = reinterpret_cast<float*>(ring + kStages * kSlabBytes);
  uint64_t* const full = reinterpret_cast<uint64_t*>(bank_s + 2 * slabs * W * NT);
  uint64_t* const empty = full + kStages;
  uint64_t* const bank_full = empty + kStages;  // a query tile's raw bank has landed
  uint64_t* const bank_empty = bank_full + 1;   // every consumer warp is done with it
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int q_tiles = (q_count + NT - 1) / NT;
  // warp-uniform as far as the compiler can see, so the roles' paths are not
  // divergent: warpgroups 0 and 1 consume, warps 8 and 9 load for them
  const int warp_id = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  // this block's tiles: blockIdx.x + k * gridDim.x; warpgroup cw takes k = cw, cw + 2, ...
  const int grid = static_cast<int>(gridDim.x);
  const int block_tiles = (n_tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // one arrival a warp of the ring's warpgroup
    }
    mbar_init(bank_full, 1);
    mbar_init(bank_empty, kConsumerThreads / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp_id >= kConsumerThreads / 32) {  // producer pw: warpgroup pw's tiles, into its ring
    const int pw = warp_id - kConsumerThreads / 32;
    if (threadIdx.x % 32 == 0) {
      const int blocks = slabs * W / 32;
      int it = 0;
      for (int qt = 0; qt < q_tiles; ++qt) {
        if (pw == 0) {  // the query tile's bank, once the last one's readers are done
          if (qt > 0) mbar_wait(bank_empty, (qt - 1) & 1);
          mbar_expect_tx(bank_full, blocks * NT * 128);
          for (int b = 0; b < blocks; ++b) {  // into the lo rows of each 32-column block
            tma_load_2d(bank_s + b * (2 * NT * 32) + NT * 32, &bank_map, bank_full, 32 * b,
                        qt * NT);
          }
        }
        for (int k = pw; k < block_tiles; k += kConsumers) {
          const int tile = blockIdx.x + k * grid;
          for (int s = 0; s < slabs; ++s, ++it) {
            const int st = pw * kRingStages + it % kRingStages;
            mbar_wait(&empty[st], ((it / kRingStages) & 1) ^ 1);
            mbar_expect_tx(&full[st], kSlabBytes);
            tma_load_2d(ring + st * kSlabBytes, &img_map, &full[st], s * W, tile * kTileRows);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup cw; its warp w holds tile rows 16 w .. 16 w + 15; lane
  // (g = lane / 4, t = lane % 4) rows g and g + 8 of those (the A fragment's
  // and the accumulator's), and columns kPer t .. kPer t + kPer - 1 of each
  // slab row
  const int cw = warp_id / 4;
  const int warp = warp_id % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const uint64_t bank_desc = sw128_desc(bank_s, 16);

  // columns 8 i + 2 t + e: query 8 i + 2 t + e's hi term (i < NT / 8), then
  // its lo term (i >= NT / 8), each summed over both A terms
  float acc[NT];
  uint32_t a_hi[2][kSteps][4], a_lo[2][kSteps][4];  // two sets: one read while one is used
#pragma unroll
  for (int set = 0; set < 2; ++set)
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_hi[set][kk][i] = 0u;
        a_lo[set][kk][i] = 0u;
      }
  float ss[2];  // rows g, g + 8: this lane's share of the sums of squares
  int it = 0;
  int read_st = 0;  // the ring stage of the slab last read

  // Slab `it` of this warpgroup's ring into A fragments: k-step kk takes
  // columns 2 kk (as the fragment's column t) and 2 kk + 1 (as t + 4) of
  // this lane's run.
  auto load_slab = [&](uint32_t (&ah)[kSteps][4], uint32_t (&al)[kSteps][4]) {
    const int st = cw * kRingStages + it % kRingStages;
    mbar_wait(&full[st], (it / kRingStages) & 1);
    const char* slab = ring + st * kSlabBytes;
    uint4 raw[2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 16 * warp + g + 8 * rr;  // r % 8 == g: the swizzle's XOR
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        raw[rr][j] = *reinterpret_cast<const uint4*>(slab + r * 128 + (((2 * t + j) ^ g) << 4));
      }
    }
    float x[2][kPer];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < 2; ++j) I::widen(raw[rr][j], &x[rr][j * kPer / 2]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int u = 0; u < kPer; ++u) ss[rr] = fmaf(x[rr][u], x[rr][u], ss[rr]);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float v[4] = {x[0][2 * kk], x[1][2 * kk], x[0][2 * kk + 1], x[1][2 * kk + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (I::kSplit) {
          split_tf32(v[i], ah[kk][i], al[kk][i]);
        } else {
          ah[kk][i] = __float_as_uint(v[i]);
        }
      }
    }
    read_st = st;  // issue() frees it
    ++it;
  };
  // Slab s's wgmmas: per k-step the hi term of A, then (fp32 only) its lo
  // term, each against the bank's hi and lo rows at once.
  auto issue = [&](int s, const uint32_t (&ah)[kSteps][4], const uint32_t (&al)[kSteps][4]) {
    wgmma_fence();
    // The slab's stage is free once every lane's reads of it are done, and
    // those reads (the generic proxy) are ordered before TMA's next write
    // there (the async proxy): without the proxy fence TMA overwrote stages
    // under reads now and then (wrong rows, with two consumers).
    fence_proxy_async_shared();
    __syncwarp();
    mbar_arrive_per_warp(&empty[read_st]);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int ks = s * kSteps + kk;
      const uint64_t at =
          bank_desc + static_cast<uint64_t>((ks >> 2) * (2 * NT * 128 / 16) + 2 * (ks & 3));
      wgmma_tf32_rs(acc, ah[kk], at);
      if constexpr (I::kSplit) wgmma_tf32_rs(acc, al[kk], at);
    }
    wgmma_commit();
  };
  // Placed after the wait that retires a set's wgmmas: its registers stay
  // untouched until then.
  auto retire = [&](uint32_t (&ah)[kSteps][4], uint32_t (&al)[kSteps][4]) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      fence_operands(ah[kk]);
      if constexpr (I::kSplit) fence_operands(al[kk]);
    }
  };

  for (int qt = 0; qt < q_tiles; ++qt) {
    const int q0 = qt * NT;
    mbar_wait(bank_full, qt & 1);
    split_bank<W, NT>(bank_s, slabs);
    fence_proxy_async_shared();  // the bank's stores, before wgmma reads them
    named_bar_sync(kConsumerBarrier, kConsumerThreads);
    // this lane's accumulator columns 8 i + 2 t + e: real queries, and not masked
    bool live[kGroups][2], keep[kGroups][2];
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * i + 2 * t + e;
        live[i][e] = q < q_count;
        keep[i][e] = live[i][e] && (mask == nullptr || mask[q] != 0);
      }

    for (int k = cw; k < block_tiles; k += kConsumers) {
      const int tile = blockIdx.x + k * grid;
      float sh[2], sc[2];  // for the epilogue, read while the slabs stream
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = tile * kTileRows + 16 * warp + g + 8 * rr;
        sh[rr] = 0.f;
        sc[rr] = 0.f;
        if (row < rows) {
          sh[rr] = shift[row];
          const float raw = scale[row];
          sc[rr] = (raw > 0.f ? raw : expm1f(raw)) + 1.f;  // the TPU kernel's expm1 form
        }
        ss[rr] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[i] = 0.f;
      int s = 0;
      for (; s + 1 < slabs; s += 2) {
        load_slab(a_hi[0], a_lo[0]);
        issue(s, a_hi[0], a_lo[0]);
        wgmma_wait<1>();  // slab s - 1's wgmmas are done with set 1
        retire(a_hi[1], a_lo[1]);
        load_slab(a_hi[1], a_lo[1]);
        issue(s + 1, a_hi[1], a_lo[1]);
        wgmma_wait<1>();  // ... slab s's with set 0
        retire(a_hi[0], a_lo[0]);
      }
      if (s < slabs) {
        load_slab(a_hi[0], a_lo[0]);
        issue(s, a_hi[0], a_lo[0]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      retire(a_hi[0], a_lo[0]);
      retire(a_hi[1], a_lo[1]);

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ss[rr] += __shfl_xor_sync(0xffffffffu, ss[rr], 1);
        ss[rr] += __shfl_xor_sync(0xffffffffu, ss[rr], 2);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = tile * kTileRows + 16 * warp + g + 8 * rr;
        if (row >= rows) continue;
        // one division a row: the stream waits on this epilogue, and an
        // IEEE division a logit (a call with a slow path) was most of it
        const float inv_n = 1.f / (sqrtf(ss[rr]) + 1e-6f);
        float* dst = out + static_cast<long long>(row) * q_count + q0;
#pragma unroll
        for (int i = 0; i < kGroups; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!live[i][e]) continue;
            const float dot = acc[4 * i + 2 * rr + e] + acc[4 * (i + kGroups) + 2 * rr + e];
            dst[8 * i + 2 * t + e] = keep[i][e] ? fmaf(dot, inv_n, sh[rr]) * sc[rr] : -FLT_MAX;
          }
      }
    }
    mbar_arrive_per_warp(bank_empty);  // after this warp's last wait on its wgmmas
  }
}

template <typename T, int NT>
int run(const CUtensorMap& map, const CUtensorMap& bank_map, const void* shift, const void* scale,
        const void* mask, void* out, int rows, int dt, int q_count, int grid, size_t smem,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(class_logits_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  class_logits_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      map, bank_map, static_cast<const float*>(shift),
      static_cast<const float*>(scale), static_cast<const int*>(mask), static_cast<float*>(out),
      rows, dt, q_count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* img, const void* bank, const void* shift, const void* scale,
           const void* mask, void* out, long long rows, int dt, int q_count, void* stream) {
  if (rows < 1 || rows > INT32_MAX || q_count < 1 || dt < 4 || dt % 4 != 0 || dt > kMaxDt ||
      reinterpret_cast<uintptr_t>(img) % 16 != 0 || (dt * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bank) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int W = Img<T>::kWidth;
  const int slabs = (dt + W - 1) / W;
  // the query tile: the fewest tiles over Q that fit, then the narrowest
  int nt = 0;
  for (int cand : kQueryTiles) {
    if (smem_bytes(cand, slabs, W) > static_cast<size_t>(smem_max)) continue;
    if (nt == 0 || (q_count + cand - 1) / cand < (q_count + nt - 1) / nt) nt = cand;
  }
  if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dt), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dt) * sizeof(T)};
  const cuuint32_t box[2] = {W, kTileRows};
  int map_err = encode_tiled(&map, Img<T>::kType, 2, img, dims, strides, box);
  if (map_err != 0) return map_err;
  CUtensorMap bank_map;  // a box is 32 columns of a query tile
  const cuuint64_t bank_dims[2] = {static_cast<cuuint64_t>(dt), static_cast<cuuint64_t>(q_count)};
  const cuuint64_t bank_strides[1] = {static_cast<cuuint64_t>(dt) * sizeof(float)};
  const cuuint32_t bank_box[2] = {32, static_cast<cuuint32_t>(nt)};
  map_err = encode_tiled(&bank_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, bank, bank_dims,
                         bank_strides, bank_box);
  if (map_err != 0) return map_err;
  const long long n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  const size_t smem = smem_bytes(nt, slabs, W);
  const int r = static_cast<int>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_nt) {
    constexpr int kNt = decltype(kernel_nt)::value;
    return run<T, kNt>(map, bank_map, shift, scale, mask, out, r, dt, q_count, grid, smem, s);
  };
  switch (nt) {
    case 8: return go(std::integral_constant<int, 8>());
    case 16: return go(std::integral_constant<int, 16>());
    case 24: return go(std::integral_constant<int, 24>());
    default: return go(std::integral_constant<int, 40>());
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. img is a contiguous (rows, dt)
// device array of fp32 (or bf16, widened exactly to fp32), 16-byte aligned,
// with dt a multiple of 4 up to 1024 (of 8 for bf16: TMA's row pitch is a
// multiple of 16 bytes); bank a contiguous, 16-byte aligned (q_count, dt)
// fp32 array of pre-normalized queries; shift and scale contiguous (rows,)
// fp32; mask a (q_count,) int32 array, 0 = masked, or null for all valid;
// out a contiguous (rows, q_count) fp32 array. The stream is the caller's
// current CUDA stream. Each returns the CUDA error of the launch (0 on
// success) or a refused tensor map's code; none synchronises or allocates.
extern "C" int owl_class_logits_fp32(const void* img, const void* bank, const void* shift,
                                     const void* scale, const void* mask, void* out,
                                     long long rows, int dt, int q_count, void* stream) {
  return launch<float>(img, bank, shift, scale, mask, out, rows, dt, q_count, stream);
}

extern "C" int owl_class_logits_bf16(const void* img, const void* bank, const void* shift,
                                     const void* scale, const void* mask, void* out,
                                     long long rows, int dt, int q_count, void* stream) {
  return launch<__nv_bfloat16>(img, bank, shift, scale, mask, out, rows, dt, q_count, stream);
}

extern "C" const char* class_logits_error_string(int code) { return hopper::error_string(code); }
