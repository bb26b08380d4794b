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
// once, keeps as many bytes in flight as shared memory holds, and lets as
// few bytes as it can travel from L2 to the SMs:
// - A CTA computes a 128 x BN tile of y: BN = 256 where n > 128, so at
//   n = 256 x leaves L2 once per row block, and BN = 128 at n <= 128.  Two
//   consumer warpgroups each own 64 rows and issue wgmma.mma_async
//   (m64nBNk16 bf16 -> fp32, m64nBNk32 s8 -> s32) on operands in shared
//   memory; a producer warp keeps TMA loads (cp.async.bulk.tensor) in flight
//   through a ring of 4 (BN 256) or 6 (BN 128) stages of 128 bytes of k,
//   guarded by full/empty mbarriers.  A consumer warpgroup releases a stage
//   once the next stage's products are issued (wgmma.wait_group 1).
// - Each row block starts its k loop at its own chunk, so that the row
//   blocks in flight do not all read the same columns of x at once
//   (MM_NO_SKEW below measures what that buys).
// - Two CTAs of neighbouring row blocks form a cluster where the row
//   blocks pair up: each loads half of the w tile and multicasts it to
//   both, so w crosses from L2 once per row block pair, and a consumer
//   warpgroup releases a stage in both CTAs.  The remote release is a
//   CTA-scope arrive (the stage was read by wgmma, which has completed):
//   with a cluster-scope release the pairs ran slower than single CTAs.
// - Operands sit in 128-byte-swizzled shared memory as the TMA writes them:
//   boxes of 64 bf16 or 128 int8 along k.  x (and int8's wt) are K-major.
//   bf16 w stays (k, n): its boxes are 64 k-rows x 64 columns and the B
//   descriptor reads them MN-major (wgmma's transpose bit), so no copy of w
//   is made.  int8 wgmma takes K-major operands only, so the wrapper
//   (ops/kernels/mm.py) transposes w to (n, k) inside the call.
// - Edges: the TMA zero-fills what a box reaches past the tensor, which
//   takes care of a short last k chunk and of a partial column tile; the
//   epilogue stores only columns below n.
// - Filling the SMs: where 256-column tiles would fill at most half the
//   card the plan takes 128-column ones, and where the tiles alone leave
//   SMs idle it splits k over CTAs (4096x2304x256: 64 tiles, k split 2
//   ways, 128 CTAs).  Each split stores its fp32 / int32 partial tile in a
//   workspace, and a second kernel sums the splits in a fixed order and
//   rounds once.  Split-K was chosen over a persistent or stream-K schedule
//   because its mainloop is the unsplit one and its fix-up is one
//   elementwise pass over L2-resident partials (8.4 MB at 4096 rows);
//   stream-K needs the same fix-up plus a tile scheduler.
// Three ablation switches, never set by the library build, let
// blockcopy_tpu_torch/tools/mm_breakdown.py time the parts: MM_NO_SKEW
// starts every k loop at chunk 0, MM_NO_PRODUCTS drops the wgmma products
// (loads, barriers and epilogue stay), MM_NO_W also drops the w loads (x
// streams alone).
// Shapes: rows a multiple of 128; k a multiple of the mma depth (16 bf16,
// 32 int8); n a multiple of 8; bases 16-byte aligned.  The launch refuses
// other shapes and plans (cudaErrorInvalidValue); the wrapper raises before.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kBM = 128;                   // rows of a CTA tile
constexpr int kChunk = 128;                // bytes of k per stage
constexpr int kABytes = kBM * kChunk;      // x tile of one stage
constexpr int kWgRows = 64;                // rows of one warpgroup

template <int BN>
struct Ring {
  static constexpr int kBBytes = BN * kChunk;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  // the stages, and slack to align them to 1024 bytes
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
};

// bf16: x (rows, k), w (k, n) read MN-major.
struct Bf16 {
  using Acc = float;
  using Acc2 = float2;
  using Acc4 = float4;
  static constexpr int kElem = 2;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  // boxes of 64 k-rows x 64 columns, 8 KB each, BN / 64 of them a stage
  static int encode_w(CUtensorMap* map, const void* w, int k, int n, int bn,
                      int csize) {
    (void)bn;
    (void)csize;
    return encode_2d(map, kType, w, n, k, (uint64_t)n * 2, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  // CTA `rank` of `csize` loads its share of the stage's boxes
  template <int BN>
  __device__ static void load_w(char* b, const CUtensorMap* map, uint64_t* bar,
                                int c, int n0, uint32_t rank, int csize) {
    const int per = BN / 64 / csize;
    for (int j = rank * per; j < (int)(rank + 1) * per; ++j) {
      if (csize == 1)
        tma_load_2d(b + j * 8192, map, bar, n0 + 64 * j, c * 64);
      else
        tma_load_2d_multicast(b + j * 8192, map, bar, n0 + 64 * j, c * 64,
                              0x3);
    }
  }
  // k-step ks: 16 k-rows further; column blocks 8 KB apart
  __device__ static uint64_t desc_w(uint32_t b, int ks) {
    return desc_sw128(b + ks * 2048, 8192, 1024);
  }
  template <int N>
  __device__ static void mma(float (&d)[N], uint64_t a, uint64_t b) {
    wgmma_bf16_ss<1>(d, a, b, 1);
  }
  // columns (col, col + 1) of one row, rounded once to bf16
  __device__ static void store2(void* y, size_t at, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + at) =
        __floats2bfloat162_rn(v0, v1);
  }
  __device__ static void store4(void* y, size_t at, const float (&v)[4]) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                           __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + at) =
        *reinterpret_cast<const uint2*>(h);
  }
};

// int8: x (rows, k), wt (n, k), both K-major.
struct S8 {
  using Acc = int;
  using Acc2 = int2;
  using Acc4 = int4;
  static constexpr int kElem = 1;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;

  // one box of bn / csize n-rows x 128 bytes of k per CTA and stage
  static int encode_w(CUtensorMap* map, const void* wt, int k, int n, int bn,
                      int csize) {
    return encode_2d(map, kType, wt, k, n, (uint64_t)k, 128, bn / csize,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  template <int BN>
  __device__ static void load_w(char* b, const CUtensorMap* map, uint64_t* bar,
                                int c, int n0, uint32_t rank, int csize) {
    const int rows = BN / csize;
    char* dst = b + rank * rows * kChunk;
    if (csize == 1)
      tma_load_2d(dst, map, bar, c * kChunk, n0);
    else
      tma_load_2d_multicast(dst, map, bar, c * kChunk, n0 + rank * rows,
                            0x3);
  }
  __device__ static uint64_t desc_w(uint32_t b, int ks) {
    return desc_sw128(b + ks * 32, 16, 1024);
  }
  template <int N>
  __device__ static void mma(int (&d)[N], uint64_t a, uint64_t b) {
    wgmma_s8_ss(d, a, b, 1);
  }
  __device__ static void store2(void* y, size_t at, int v0, int v1) {
    *reinterpret_cast<int2*>(static_cast<int*>(y) + at) = make_int2(v0, v1);
  }
  __device__ static void store4(void* y, size_t at, const int (&v)[4]) {
    *reinterpret_cast<int4*>(static_cast<int*>(y) + at) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
};

// Row block blockIdx.x, column tile blockIdx.y, k split blockIdx.z (chunks
// [z * chunks / splits, (z + 1) * chunks / splits)).  With one split the
// tile is stored to y (T's output type), else as accumulators to
// out + z * rows * n.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
mm_kernel(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_w, void* out, int rows,
          int n, int chunks, int splits, int csize) {
  using R = Ring<BN>;
  constexpr int kStages = R::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto stage = [&](int s) { return smem + s * R::kStageBytes; };

  const int row0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int c_begin = blockIdx.z * chunks / splits;
  const int c_count = (blockIdx.z + 1) * chunks / splits - c_begin;
  const uint32_t rank = cluster_rank();
  // each cluster starts its k loop at another chunk, so that the row
  // blocks in flight do not all read the same columns of x at once
#ifdef MM_NO_SKEW
  const int skew = 0;
#else
  const int skew = blockIdx.x / csize % c_count;
#endif
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * csize);  // each warpgroup of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < c_count; ++i) {
        const int s = i % kStages, c = c_begin + (i + skew) % c_count;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
#ifdef MM_NO_W
        mbar_expect_tx(&full[s], kABytes);
        tma_load_2d(stage(s), &map_x, &full[s], c * kChunk / T::kElem, row0);
#else
        mbar_expect_tx(&full[s], R::kStageBytes);
        tma_load_2d(stage(s), &map_x, &full[s], c * kChunk / T::kElem, row0);
        T::template load_w<BN>(stage(s) + kABytes, &map_w, &full[s], c, n0,
                               rank, csize);
#endif
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
    typename T::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < c_count; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t a = smem_u32(stage(s)) + wg * kWgRows * kChunk;
      const uint32_t b = smem_u32(stage(s) + kABytes);
      wgmma_fence();
#ifndef MM_NO_PRODUCTS
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks)
        T::mma(acc, desc_sw128(a + ks * 32, 16, 1024), T::desc_w(b, ks));
#endif
      wgmma_commit();
      // the previous chunk's products are done: release its stage in every
      // CTA of the cluster (each of them multicast into it)
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && threadIdx.x % 128 == 0) {
        uint64_t* bar = &empty[(i - 1) % kStages];
        mbar_arrive(bar);
        if (csize == 2) mbar_arrive_cta(bar, rank ^ 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int t = threadIdx.x % 128;
    const size_t r = row0 + wg * kWgRows + t / 32 * 16 + t % 32 / 4;
    const size_t plane = (size_t)rows * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (t % 4);
      if (col >= n) continue;
      if (splits == 1) {
        T::store2(out, r * n + col, acc[4 * j], acc[4 * j + 1]);
        T::store2(out, (r + 8) * n + col, acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        using A2 = typename T::Acc2;
        auto* ws = static_cast<typename T::Acc*>(out) + blockIdx.z * plane;
        *reinterpret_cast<A2*>(ws + r * n + col) = A2{acc[4 * j],
                                                      acc[4 * j + 1]};
        *reinterpret_cast<A2*>(ws + (r + 8) * n + col) =
            A2{acc[4 * j + 2], acc[4 * j + 3]};
      }
    }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// y = the sum of `splits` partial planes, in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256)
sum_splits(const typename T::Acc* __restrict__ ws, void* y, size_t plane,
           int splits) {
  using Acc = typename T::Acc;
  const size_t quads = plane / 4;
  for (size_t q = blockIdx.x * (size_t)blockDim.x + threadIdx.x; q < quads;
       q += (size_t)gridDim.x * blockDim.x) {
    Acc v[4] = {0, 0, 0, 0};
    for (int s = 0; s < splits; ++s) {
      const auto p =
          reinterpret_cast<const typename T::Acc4*>(ws + s * plane)[q];
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
    T::store4(y, 4 * q, v);
  }
}

template <typename T, int BN>
int launch(const void* x, const void* w, void* y, void* ws, int rows, int k,
           int n, int csize, int splits, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  int err = encode_2d(&map_x, T::kType, x, k, rows, (uint64_t)k * T::kElem,
                      kChunk / T::kElem, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = T::encode_w(&map_w, w, k, n, BN, csize);
  if (err) return err;
  constexpr int bytes = Ring<BN>::kSmemBytes;
  // raised once, never again (a CUDA graph capture may be open)
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int chunks = (k * T::kElem + kChunk - 1) / kChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows / kBM, (n + BN - 1) / BN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, mm_kernel<T, BN>, map_x, map_w,
                         splits == 1 ? y : ws, rows, n, chunks, splits, csize);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t quads = (size_t)rows * n / 4;
    const int blocks = (int)((quads + 255) / 256 < 4096 ? (quads + 255) / 256
                                                        : 4096);
    sum_splits<T><<<blocks, 256, 0, stream>>>(
        static_cast<const typename T::Acc*>(ws), y, (size_t)rows * n, splits);
  }
  return (int)cudaGetLastError();
}

// The wrapper's plan: column tile bn (128 or 256), cluster size (1 or 2
// row blocks), k splits (1 .. chunks, a workspace of splits * rows * n
// accumulators where splits > 1).
template <typename T>
int launch_plan(const void* x, const void* w, void* y, void* ws, int rows,
                int k, int n, int bn, int csize, int splits, void* stream,
                int k_mult) {
  if (rows <= 0 || rows % kBM || k <= 0 || k % k_mult || n <= 0 || n % 8)
    return (int)cudaErrorInvalidValue;
  const int chunks = (k * T::kElem + kChunk - 1) / kChunk;
  if ((bn != 128 && bn != 256) || (csize != 1 && csize != 2) ||
      (rows / kBM) % csize || splits < 1 || splits > chunks ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch<T, 256>(x, w, y, ws, rows, k, n, csize, splits, s);
  return launch<T, 128>(x, w, y, ws, rows, k, n, csize, splits, s);
}

}  // namespace

// y (rows, n) bf16 = x (rows, k) bf16 @ w (k, n) bf16; ws: splits x rows x n
// fp32 (unused with one split)
extern "C" int mm_bf16(const void* x, const void* w, void* y, void* ws,
                       int rows, int k, int n, int bn, int csize, int splits,
                       void* stream) {
  return launch_plan<Bf16>(x, w, y, ws, rows, k, n, bn, csize, splits, stream,
                           16);
}

// y (rows, n) int32 = x (rows, k) int8 @ wt (n, k) int8 transposed; ws:
// splits x rows x n int32 (unused with one split)
extern "C" int mm_int8(const void* x, const void* wt, void* y, void* ws,
                       int rows, int k, int n, int bn, int csize, int splits,
                       void* stream) {
  return launch_plan<S8>(x, wt, y, ws, rows, k, n, bn, csize, splits, stream,
                         32);
}
