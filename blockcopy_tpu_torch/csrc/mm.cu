// Tiled matrix product y = x @ w for the int8-vs-bf16 rate probe:
//   mm_bf16: x (rows, k) bf16, w (k, n) bf16, fp32 accumulation, y bf16
//            (rounded once, to nearest even);
//   mm_int8: x (rows, k) int8, w given as wt (n, k) int8, int32
//            accumulation, y int32 (exact).
//
// Replaces the Pallas kernel tools/probe_int8.py (make_mm :38, _mm_kernel
// :33): the im2col'd 3x3-conv GEMM of the blocked RN50 layer2/3 tail.
//
// Bound: at the probe's shapes the card is bytes-bound, in both types.
// 16384x2304x256 moves 85.1 MB (bf16) / 55.1 MB (int8) for 19.3 G
// operations: 25.4 / 16.5 us of device memory against 19.5 / 9.8 us of
// tensor-core work; 16384x1152x128 and 4096x2304x256 are further below the
// ridge.  x is most of the bytes, so the design reads x from device memory
// once and keeps the tensor cores fed from shared memory:
// - A CTA computes a BM x 128 tile of y with 8 warps (a 2x4 grid of warp
//   tiles).  The TPU grid (rows // chunk steps, each holding the whole w in
//   VMEM) is not carried over: each CTA loops over k itself, in chunks of
//   128 bytes of every row (64 bf16 or 128 int8 values).
// - The chunks of x and w stream into shared memory by cp.async through a
//   ring of stages, so loads run a few chunks ahead of the products.  Two
//   CTAs share an SM.
// - The CTAs of one row block are consecutive in blockIdx.x, so they run
//   together and the second reads its x tile from L2: x leaves device memory
//   once although n > 128 splits a row block over several CTAs.  w (at most
//   1.2 MB at the probe's shapes) stays in L2 and is read by every row block.
//   What L2 hands the SMs (x once per 128 columns, w once per row block) is
//   then about 3.5x the bound's bytes at 16384x2304x256 with 128-row tiles.
// - BM is 128, or 64 where 128-row tiles would give fewer CTAs than the card
//   has SMs (4096x2304x256: 64 CTAs of 128 rows, 128 of 64).
// - Fragments come from ldmatrix; the products run on mma.sync
//   m16n8k16 (bf16, fp32 accumulators) and m16n8k32 (s8, s32 accumulators).
//   Both consume 32 bytes of k per step, so the x fragments are loaded by
//   the same code for both types.
// - int8 B fragments: ldmatrix.trans transposes 16-bit elements only, so it
//   cannot make the column-major int8 B fragment from a row-major (k, n) w.
//   The wrapper (ops/kernels/mm.py) transposes w to (n, k) once per call,
//   inside the call, and the kernel reads wt with the same non-transposed
//   ldmatrix as x.  bf16 keeps w (k, n) and uses ldmatrix.trans.
// - Shared-memory rows are padded by 16 bytes (144 and 272 bytes), so the 8
//   rows of an ldmatrix phase fall on distinct banks.
// Shapes: rows a multiple of 128; k a multiple of the mma depth (16 bf16,
// 32 int8), so every 16-byte copy is whole and a short last chunk runs
// fewer steps; n a multiple of 8 (columns past n are neither loaded nor
// stored).  Bases 16-byte aligned.  The launch refuses other shapes
// (cudaErrorInvalidValue); the wrapper raises before that.
// wgmma with TMA, clusters that share x and w tiles between CTAs, and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps, a 2x4 grid of warp tiles
constexpr int kMinBlocks = 2;      // CTAs an SM holds
constexpr int kBN = 128;           // columns of a CTA tile
constexpr int kNJ = kBN / 32;      // n8 tiles of a warp tile (even)
constexpr int kChunk = 128;        // bytes of k per chunk
constexpr int kStep = 32;          // bytes of k per mma
constexpr int kLdK = kChunk + 16;  // padded row of an x (or wt) chunk, bytes
constexpr int kLdW = kBN * 2 + 16;  // padded row of a bf16 w chunk, bytes
constexpr int kBTileBytes = kBN * kLdK > kChunk / 2 * kLdW
                                ? kBN * kLdK : kChunk / 2 * kLdW;
// shared memory of one CTA: an SM's 228 KB for kMinBlocks CTAs, less the
// 1 KB the card reserves for each
constexpr int kSmemBudget = 233472 / kMinBlocks - 1024;

// A CTA tile of BM rows (64 or 128): warp tiles of BM / 2 rows, and as many
// pipeline stages as the budget holds (3 at 128 rows, 4 at 64).
template <int BM>
struct Tile {
  static constexpr int kMI = BM / 32;  // m16 tiles of a warp tile
  static constexpr int kATileBytes = BM * kLdK;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  static constexpr int kStages = kSmemBudget / kStageBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(kStages >= 2, "a tile needs two stages");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 16-bit matrices (8 rows of 16 bytes each) from shared memory;
// lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// bf16: x (rows, k), w (k, n).  A chunk of w is kChunk / 2 k-rows of kBN
// columns.
struct Bf16 {
  using Acc = float;
  static constexpr int kElem = 2;

  // kChunk / 2 k-rows x kBN columns from w (k, n), 16 bytes a copy
  __device__ static void load_b(char* dst, const char* w, int k, int n,
                                int n0, int c) {
    constexpr int vecs = kBN * 2 / 16;
    for (int e = threadIdx.x; e < (kChunk / 2) * vecs; e += kThreads) {
      const int r = e / vecs, v = e % vecs;
      const int kr = c * (kChunk / 2) + r, col = n0 + v * 8;
      if (kr < k && col < n)
        __pipeline_memcpy_async(dst + r * kLdW + v * 16,
                                w + ((size_t)kr * n + col) * 2, 16);
    }
  }

  // B fragments of kNJ n8 tiles (columns from `col`) for k-step `ks`:
  // fb[q][0..1] serve tile 2q, fb[q][2..3] tile 2q + 1.
  __device__ static void frag_b(unsigned (&fb)[kNJ / 2][4], const char* b,
                                int col, int ks, int lane) {
    const int kr = ks * 16 + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
    for (int q = 0; q < kNJ / 2; ++q)
      ldsm_x4_t(fb[q], b + kr * kLdW + (col + q * 16 + lane / 16 * 8) * 2);
  }

  __device__ static void mma(float (&d)[4], const unsigned (&a)[4],
                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  // columns (col, col + 1) of one row, rounded once to bf16
  __device__ static void store2(void* y, size_t at, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + at) =
        __floats2bfloat162_rn(v0, v1);
  }
};

// int8: x (rows, k), wt (n, k).  A chunk of wt is kBN n-rows of 64 bytes,
// laid out as an x chunk.
struct S8 {
  using Acc = int;
  static constexpr int kElem = 1;

  __device__ static void load_b(char* dst, const char* wt, int k, int n,
                                int n0, int c) {
    constexpr int vecs = kChunk / 16;
    for (int e = threadIdx.x; e < kBN * vecs; e += kThreads) {
      const int r = e / vecs, v = e % vecs;
      const int kb = c * kChunk + v * 16;
      if (n0 + r < n && kb < k)
        __pipeline_memcpy_async(dst + r * kLdK + v * 16,
                                wt + (size_t)(n0 + r) * k + kb, 16);
    }
  }

  // matrices: n rows 0-7 k bytes 0-15 / 16-31, then n rows 8-15 likewise
  __device__ static void frag_b(unsigned (&fb)[kNJ / 2][4], const char* b,
                                int col, int ks, int lane) {
    const int row = lane / 16 * 8 + lane % 8;
    const int kb = ks * kStep + (lane / 8) % 2 * 16;
#pragma unroll
    for (int q = 0; q < kNJ / 2; ++q)
      ldsm_x4(fb[q], b + (col + q * 16 + row) * kLdK + kb);
  }

  __device__ static void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  __device__ static void store2(void* y, size_t at, int v0, int v1) {
    *reinterpret_cast<int2*>(static_cast<int*>(y) + at) = make_int2(v0, v1);
  }
};

// BM rows x kChunk bytes of k from x (row stride k_bytes), 16 bytes a copy
template <int BM>
__device__ __forceinline__ void load_a(char* dst, const char* x,
                                       size_t k_bytes, int c) {
  constexpr int vecs = kChunk / 16;
  for (int e = threadIdx.x; e < BM * vecs; e += kThreads) {
    const int r = e / vecs, v = e % vecs;
    const size_t kb = (size_t)c * kChunk + v * 16;
    if (kb < k_bytes)
      __pipeline_memcpy_async(dst + r * kLdK + v * 16, x + r * k_bytes + kb,
                              16);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mm_kernel(const char* __restrict__ x, const char* __restrict__ w, void* y,
          int k, int n) {
  using L = Tile<BM>;
  constexpr int kMI = L::kMI, kStages = L::kStages;
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const size_t row0 = (size_t)blockIdx.y * BM;
  const size_t k_bytes = (size_t)k * T::kElem;
  const int chunks = (int)((k_bytes + kChunk - 1) / kChunk);
  const char* xb = x + row0 * k_bytes;

  auto load = [&](int c) {
    char* stage = smem + (c % kStages) * L::kStageBytes;
    load_a<BM>(stage, xb, k_bytes, c);
    T::load_b(stage + L::kATileBytes, w, k, n, n0, c);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s);
    __pipeline_commit();
  }

  // warp tile: rows wm .. wm + BM / 2 - 1, columns wn .. wn + kBN / 4 - 1
  const int wm = warp / 4 * (BM / 2), wn = warp % 4 * (kBN / 4);
  typename T::Acc acc[kMI][kNJ][4] = {};
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed, and every warp is done with chunk c - 1, whose
    // buffer the next load refills
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    __pipeline_commit();

    const char* a = smem + (c % kStages) * L::kStageBytes;
    const char* b = a + L::kATileBytes;
    // a last chunk shorter than kChunk runs fewer steps
    const size_t left = k_bytes - (size_t)c * kChunk;
    const int steps = left < kChunk ? (int)left / kStep : kChunk / kStep;
    for (int ks = 0; ks < steps; ++ks) {
      unsigned fa[kMI][4], fb[kNJ / 2][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        ldsm_x4(fa[i], a + (wm + i * 16 + lane % 16) * kLdK + ks * kStep +
                           lane / 16 * 16);
      T::frag_b(fb, b, wn, ks, lane);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          T::mma(acc[i][j], fa[i], fb[j / 2][j % 2 * 2],
                 fb[j / 2][j % 2 * 2 + 1]);
    }
  }

  // accumulator (i, j): rows +lane/4 and +lane/4 + 8, columns 2 * (lane % 4)
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int col = n0 + wn + j * 8 + lane % 4 * 2;
    if (col >= n) continue;
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const size_t r = row0 + wm + i * 16 + lane / 4;
      T::store2(y, r * n + col, acc[i][j][0], acc[i][j][1]);
      T::store2(y, (r + 8) * n + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <typename T, int BM>
int launch_tile(const char* x, const char* w, void* y, int rows, int k, int n,
                cudaStream_t stream) {
  constexpr int bytes = Tile<BM>::kSmemBytes;
  // raised once, never again (a CUDA graph capture may be open)
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        mm_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const dim3 grid((n + kBN - 1) / kBN, rows / BM);
  mm_kernel<T, BM><<<grid, kThreads, bytes, stream>>>(x, w, y, k, n);
  return (int)cudaGetLastError();
}

// 128-row tiles, or 64-row tiles where 128-row ones would leave SMs idle
template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int k, int n,
           void* stream, int k_mult) {
  if (rows <= 0 || rows % 128 || k <= 0 || k % k_mult || n <= 0 || n % 8)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const auto xc = static_cast<const char*>(x);
  const auto wc = static_cast<const char*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((rows / 128) * ((n + kBN - 1) / kBN) < sms)
    return launch_tile<T, 64>(xc, wc, y, rows, k, n, s);
  return launch_tile<T, 128>(xc, wc, y, rows, k, n, s);
}

}  // namespace

// y (rows, n) bf16 = x (rows, k) bf16 @ w (k, n) bf16
extern "C" int mm_bf16(const void* x, const void* w, void* y, int rows, int k,
                       int n, void* stream) {
  return launch<Bf16>(x, w, y, rows, k, n, stream, 16);
}

// y (rows, n) int32 = x (rows, k) int8 @ wt (n, k) int8 transposed
extern "C" int mm_int8(const void* x, const void* wt, void* y, int rows, int k,
                       int n, void* stream) {
  return launch<S8>(x, wt, y, rows, k, n, stream, 32);
}
