// Exact int8 GEMM on the tensor cores: C (M, N) int32 = A (M, K) int8 x
// B (K, N) int8, both row-major, every product and sum exact in int32.
//
// It replaces the Pallas kernel of tools/bench_int8.py::pallas_int8 (body
// :146-164): one int8 x int8 -> int32 dot_general per 512 x 4096 x 512
// block, which asks whether Mosaic reaches the TPU's int8 MXU. Here the
// question is the same for Hopper's int8 tensor cores, through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//
// What bounds it on an H100: operations. At n = 4096 the 2n^3 = 137 G int
// ops take 69 us at the dense int8 peak of 1,979 TOP/s, where the bytes
// (two 16.8 MB operands, a 67.1 MB int32 result) need 30 us at 3.35 TB/s;
// at n = 8192, 556 us against 120 us. So the design keeps the tensor cores
// fed from shared memory:
//
// - a block owns a 128 x 128 tile of C and walks K in steps of 64; its 8
//   warps each own 64 x 32 of the tile (4 x 4 m16n8 fragments, 64 int32
//   accumulators a thread), so each k32 step is 16 mma per warp against 24
//   32-bit shared loads;
// - mma's B operand is K-major ("col"), and B arrives (K, N) row-major;
//   ldmatrix's .trans works only on 16-bit elements, so each thread loads a
//   4 x 4 byte block of B (4 rows of 4 bytes, coalesced along N), turns it
//   with byte permutes and stores 4 K-contiguous words: the transpose
//   happens while the tile is staged, inside this kernel's time;
// - shared rows are 64 bytes of K plus 16 of pad (20 words), so the
//   fragment loads of a warp (8 rows x 4 words) hit 32 distinct banks;
// - the next K step's tiles are loaded from global memory into registers
//   while the tensor cores work on the current one (register double
//   buffering; wgmma and TMA are a later step).
//
// M, N and K must be multiples of 16 (the wrapper checks): a partial tile
// at the edge is masked at the granularity of 16-byte chunks of A, 4 x 4
// blocks of B and 2-column pairs of C, which never straddle the edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRowWords = kBK / 4 + 4;  // 16 words of K + 4 of pad

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The global loads of one K step: two 16-byte chunks of A and two 4 x 4
// blocks of B per thread.
struct Stage {
  uint4 a[2];
  uint32_t b[2][4];
};

__device__ __forceinline__ void load_stage(Stage& st, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks: 128 rows x 4 chunks of 16 bytes
    const int row = m0 + (c >> 2);
    const int k = k0 + (c & 3) * 16;
    st.a[i] = (row < M && k < K)
                  ? *reinterpret_cast<const uint4*>(A + static_cast<long long>(row) * K + k)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // 512 blocks of 4 x 4 bytes: lanes take 8 neighbouring N blocks of 4
    // neighbouring K blocks, so each load instruction reads 4 whole sectors
    const int blk = tid + i * kThreads;
    const int nq = ((blk >> 5) & 3) * 8 + (blk & 7);
    const int kq = (blk >> 7) * 4 + ((blk >> 3) & 3);
    const int k = k0 + kq * 4;
    const int n = n0 + nq * 4;
    const bool live = k < K && n < N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st.b[i][r] = live ? *reinterpret_cast<const uint32_t*>(
                              B + static_cast<long long>(k + r) * N + n)
                        : 0u;
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, uint32_t* As, uint32_t* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(As + (c >> 2) * kRowWords + (c & 3) * 4) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = tid + i * kThreads;
    const int nq = ((blk >> 5) & 3) * 8 + (blk & 7);
    const int kq = (blk >> 7) * 4 + ((blk >> 3) & 3);
    const uint32_t* w = st.b[i];
    // w[r] holds B[k + r][n .. n + 3]; column j of the block is byte j of each
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    uint32_t* dst = Bs + (nq * 4) * kRowWords + kq;
    dst[0 * kRowWords] = __byte_perm(lo01, lo23, 0x5410);  // column n: k .. k + 3
    dst[1 * kRowWords] = __byte_perm(lo01, lo23, 0x7632);
    dst[2 * kRowWords] = __byte_perm(hi01, hi23, 0x5410);
    dst[3 * kRowWords] = __byte_perm(hi01, hi23, 0x7632);
  }
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 int32_t* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) uint32_t As[kBM * kRowWords];  // [m][k], 10 KB
  __shared__ __align__(16) uint32_t Bs[kBN * kRowWords];  // [n][k], transposed, 10 KB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (A, C) or column (B)
  const int t = lane & 3;   // word within a fragment's 16 bytes of K
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Stage st;
  load_stage(st, A, B, M, N, K, m0, n0, 0);
  store_stage(st, As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load_stage(st, A, B, M, N, K, m0, n0, k0 + kBK);  // in flight during the mma
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* r0 = As + (wm + i * 16 + g) * kRowWords + ks * 8 + t;
        const uint32_t* r8 = r0 + 8 * kRowWords;
        a[i][0] = r0[0];  // row g,     k t*4 .. +3
        a[i][1] = r8[0];  // row g + 8, k t*4 .. +3
        a[i][2] = r0[4];  // row g,     k 16 + t*4 .. +3
        a[i][3] = r8[4];  // row g + 8, k 16 + t*4 .. +3
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* col = Bs + (wn + j * 8 + g) * kRowWords + ks * 8 + t;
        b[j][0] = col[0];  // column g, k t*4 .. +3
        b[j][1] = col[4];  // column g, k 16 + t*4 .. +3
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // every warp is done reading this step's tiles
    if (more) {
      store_stage(st, As, Bs);
      __syncthreads();
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row < M) {
          *reinterpret_cast<int2*>(C + static_cast<long long>(row) * N + col) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C interface, loaded with ctypes. a (m, k) and b (k, n) are
// contiguous row-major int8 device arrays, 16-byte aligned; c a contiguous
// (m, n) int32 device array; m, n and k positive multiples of 16. The
// stream is the caller's current CUDA stream. Returns the CUDA error of the
// launch (0 on success); nothing synchronises or allocates.
extern "C" int int8_gemm_s8s8s32(const void* a, const void* b, void* c, int m, int n, int k,
                                 void* stream) {
  if (m < 16 || n < 16 || k < 16 || m % 16 || n % 16 || k % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(c), m,
      n, k);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel: the launch floor the tool reports beside
// the GEMM's time (the counterpart of bench_int8.py's floor_calibration).
extern "C" int int8_gemm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
