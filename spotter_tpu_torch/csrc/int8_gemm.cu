// Exact int8 GEMM on the tensor cores: C (M, N) int32 = A (M, K) int8 x
// B (K, N) int8, every product and sum exact in int32; batched over a grid
// dimension, with B shared by the batch or one a batch entry.
//
// It replaces the Pallas kernel of tools/bench_int8.py::pallas_int8 (body
// :146-164): one int8 x int8 -> int32 dot_general per 512 x 4096 x 512
// block, which asks whether Mosaic reaches the TPU's int8 MXU. Here the
// question is the same for Hopper's int8 tensor cores, through
// wgmma.mma_async m64n256k32.s32.s8.s8 (SASS IGMMA). It also serves the
// port's int8 quantization (spotter_tpu/utils/quant.py's s8 convolution and
// dot_generals, through csrc/quant.cu's passes): the convolutions as im2col
// GEMMs, the dense projections, and QKᵀ and attn·V batched over B*H.
//
// What bounds it on an H100: operations. At n = 4096 the 2n^3 = 137 G int
// ops take 69 us at the dense int8 peak of 1,979 TOP/s, where the bytes
// (two 16.8 MB operands, a 67.1 MB int32 result) need 30 us at 3.35 TB/s;
// at n = 8192, 556 us against 120 us. So the design keeps the tensor cores
// fed from shared memory without threads touching the operands:
//
// - wgmma takes 8-bit operands K-major only. The served entry
//   (int8_gemm_kmajor_s8s8s32) takes B that way, as Bᵀ (N, K): the
//   quantize passes write it so, and a layer's weight codes are kept so.
//   The tool's wrapper (ops/int8.py `int8_gemm`) takes B (K, N) row-major
//   and runs a first pass (int8_transpose_s8) that writes Bᵀ, then the same
//   entry: 2 x 16.8 MB of traffic at n = 4096, ~10 us at 3.35 TB/s, timed
//   with its call;
// - a block owns a 128 x 256 tile of one batch entry's C (blockIdx.z) and
//   has three warpgroups: a producer, one thread of which keeps TMA loads of
//   the A (128 x 128 bytes) and Bᵀ (256 x 128 bytes) tiles of the next K
//   steps in flight in a ring of 4 stages (192 KB), each with a full and an
//   empty mbarrier; and two consumers, each issuing 4 wgmma m64n256k32 a
//   stage from shared-memory descriptors into 128 int32 accumulators a
//   thread, releasing a stage as soon as the wgmmas that read it have
//   finished (one group in flight);
// - tiles are 128-byte swizzled by TMA through 3-D maps (K, rows, batch), so
//   wgmma reads them without bank conflicts; TMA zero-fills rows and K
//   columns past the edge of each batch entry, so a ragged M, N or K needs
//   no special case, and the epilogue stores int32 pairs of C (single
//   values when N is odd) masked at the edge.
//
// K must be a multiple of 16 (TMA wants row strides that are multiples of 16
// bytes; the quantize passes pad K with zero codes, which add nothing). The
// transpose also wants N a multiple of 16 (it moves 16-byte chunks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;  // C rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;  // C columns a block
constexpr int kBK = 128;  // bytes of K a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;

struct alignas(1024) Smem {
  int8_t a[kStages][kBM * kBK];  // [m][k], 16 KB a stage
  int8_t b[kStages][kBN * kBK];  // [n][k] (B^T), 32 KB a stage
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap bt_map, int32_t* __restrict__ C, int M,
                 int N, int K, int b_batched) {
  extern __shared__ char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  // warp-uniform as far as the compiler can see, so the roles' paths are not divergent
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int z = blockIdx.z;  // the batch entry
  C += static_cast<long long>(z) * M * N;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], sizeof(sm.a[0]) + sizeof(sm.b[0]));
        tma_load_3d(sm.a[st], &a_map, &sm.full[st], kt * kBK, m0, z);
        tma_load_3d(sm.b[st], &bt_map, &sm.full[st], kt * kBK, n0, b_batched ? z : 0);
      }
    }
    return;
  }

  // consumer cw owns C rows m0 + 64 cw .. + 63; within them warp w rows
  // 16 w .. + 15, and lane (g = lane / 4, t = lane % 4) rows g and g + 8,
  // columns 8 i + 2 t and + 1 of each 8-column group i: acc[4 i + 2 r + c]
  const int cw = warpgroup - 1;
  const int tid = threadIdx.x - 128 * warpgroup;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    const uint64_t a_desc = sw128_desc(&sm.a[st][cw * 64 * kBK], 16);
    const uint64_t b_desc = sw128_desc(sm.b[st], 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {  // 32 bytes of K a step
      wgmma_m64n256k32_s8_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas are done with it
    if (kt > 0) mbar_arrive_per_warp(&sm.empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 64 * cw + 16 * warp + g + 8 * r;
    if (row >= M) continue;
    int32_t* c_row = C + static_cast<long long>(row) * N;
    if ((N & 1) == 0) {  // pairs: 8-byte aligned, never straddling the edge
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col < N) {
          *reinterpret_cast<int2*>(c_row + col) =
              make_int2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col < N) c_row[col] = acc[4 * i + 2 * r];
        if (col + 1 < N) c_row[col + 1] = acc[4 * i + 2 * r + 1];
      }
    }
  }
}

// B (K, N) -> B^T (N, K), bytes, through a 64 x 64 tile in shared memory:
// each thread loads one 16-byte chunk of a B row and stores one 16-byte chunk
// of a B^T row (16 byte reads of a column of the tile). Rows of the tile are
// 68 bytes, so the column reads of a warp fall on at most 2 ways of a bank.
constexpr int kTile = 64;
constexpr int kTileLd = kTile + 4;

__global__ void __launch_bounds__(256)
transpose_s8_kernel(const int8_t* __restrict__ B, int8_t* __restrict__ Bt, int K, int N) {
  __shared__ __align__(16) uint8_t tile[kTile * kTileLd];
  const int k0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int row = threadIdx.x / 4;        // tile row: k (load), n (store)
  const int chunk = (threadIdx.x % 4) * 16;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k0 + row < K && n0 + chunk < N) {
    v = *reinterpret_cast<const uint4*>(B + static_cast<long long>(k0 + row) * N + n0 + chunk);
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(tile + row * kTileLd + chunk);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
  __syncthreads();
  if (n0 + row < N && k0 + chunk < K) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint8_t* col = tile + (chunk + 4 * q) * kTileLd + row;
      w[q] = static_cast<uint32_t>(col[0]) | (static_cast<uint32_t>(col[kTileLd]) << 8) |
             (static_cast<uint32_t>(col[2 * kTileLd]) << 16) |
             (static_cast<uint32_t>(col[3 * kTileLd]) << 24);
    }
    *reinterpret_cast<uint4*>(Bt + static_cast<long long>(n0 + row) * K + k0 + chunk) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C interface, loaded with ctypes. All arrays are contiguous,
// row-major and 16-byte aligned device arrays. The stream is the caller's current CUDA stream. Each returns the
// error of its launch or of its tensor maps (0 on success); nothing
// synchronises or allocates.

// bt (n, k) = the transpose of b (k, n), int8; k and n positive multiples of 16.
extern "C" int int8_transpose_s8(const void* b, void* bt, int k, int n, void* stream) {
  if (k < 16 || n < 16 || k % 16 || n % 16) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile);
  transpose_s8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), k, n);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The GEMM on K-major operands: a (batch, m, k), bt (b_batch, n, k) with
// b_batch 1 (shared) or batch; c (batch, m, n).
int launch_gemm(const void* a, const void* bt, void* c, int batch, int m, int n, int k,
                int b_batched, cudaStream_t stream) {
  CUtensorMap a_map, bt_map;
  const cuuint64_t a_dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t bt_dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n),
                                 static_cast<cuuint64_t>(b_batched ? batch : 1)};
  const cuuint64_t a_strides[2] = {static_cast<cuuint64_t>(k),
                                   static_cast<cuuint64_t>(k) * static_cast<cuuint64_t>(m)};
  const cuuint64_t bt_strides[2] = {static_cast<cuuint64_t>(k),
                                    static_cast<cuuint64_t>(k) * static_cast<cuuint64_t>(n)};
  const cuuint32_t a_box[3] = {kBK, kBM, 1};
  const cuuint32_t bt_box[3] = {kBK, kBN, 1};
  int err = encode_tiled(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, a, a_dims, a_strides, a_box);
  if (err != 0) return err;
  err = encode_tiled(&bt_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, bt, bt_dims, bt_strides, bt_box);
  if (err != 0) return err;
  constexpr size_t smem = sizeof(Smem) + 1024;  // + the alignment slack
  const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  int8_gemm_kernel<<<grid, kThreads, smem, stream>>>(a_map, bt_map, static_cast<int32_t*>(c), m,
                                                     n, k, b_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c (batch, m, n) int32 = a (batch, m, k) int8 x bt (n, k)ᵀ int8, bt one for
// the whole batch (b_batched 0) or one a batch entry (b_batched 1, bt
// (batch, n, k)): K-major operands, any m, n >= 1, k a positive multiple of 16.
extern "C" int int8_gemm_kmajor_s8s8s32(const void* a, const void* bt, void* c, int batch,
                                        int m, int n, int k, int b_batched, void* stream) {
  if (batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 16 || k % 16 ||
      (m + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_gemm(a, bt, c, batch, m, n, k, b_batched ? 1 : 0,
                     static_cast<cudaStream_t>(stream));
}

// One launch of an empty kernel: the launch floor the tool reports beside
// the GEMM's time (the counterpart of bench_int8.py's floor_calibration).
extern "C" int int8_gemm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_error_string(int code) { return hopper::error_string(code); }
