// Fused bottleneck tail for stride-1 identity ResNet bottlenecks:
//   y = relu(bn3(conv1x1(relu(bn2(conv3x3(pad(h1)))))) + x)
//
// Replaces the Pallas kernel blockcopy_tpu/ops/pallas/bottleneck.py
// (bottleneck_tail :92, _kernel :50).  The padded tile is built from h1 and
// the 8 halo pieces of the strip exchange; numerics follow :82-89: the 3x3
// conv accumulates in fp32, is cast to the activation dtype, then the BN2
// multiply and add each round to that dtype, ReLU; the 1x1 accumulates in
// fp32, is cast, BN3 multiply, add, + x, ReLU, each rounding likewise.
// Weights come prepared (ops/kernels/bottleneck.py prepare_tail_weights):
// w2 (3, 3, Cm, Cm) as [dy][dx][co][ci], w3 (Co, Cm), BN vectors in the
// activation dtype.
//
// Bound (bf16, K = 64 blocks, RN50 at 1024x2048): layer2 (bs 16, Cm 128,
// Co 512) moves ~39 MB for ~7 GFLOP, so bytes bound it; layer3 (bs 8,
// Cm 256, Co 1024) ~22 MB for ~7 GFLOP, so tensor-core operations do.
// Design (bf16), everything between h1 and y kept on chip:
// - A cluster of 2 CTAs runs each executed block (128 CTAs at K = 64, where
//   one CTA per block left 68 of the 132 SMs idle).  CTA r computes h2's
//   output channels [r Cm/2, (r+1) Cm/2) over all bs^2 pixels, writes its
//   half into both CTAs' shared memory (st.shared::cluster), and after a
//   cluster barrier computes y's channels [r Co/2, (r+1) Co/2).  No product
//   is computed twice.  (Splitting by pixels cannot work at layer3, whose 64
//   pixels are one m64 tile.)
// - Two consumer warpgroups issue wgmma.mma_async; a producer thread streams
//   the weights by TMA (cp.async.bulk.tensor) through a ring of 4 stages of
//   128 rows x 64 channels, 128-byte swizzled, guarded by full/empty
//   mbarriers: first the w2 chunks (one tap, 64 input channels, this CTA's
//   Cm/2 outputs), then the w3 chunks (64 input channels x 128 outputs).
// - 3x3 conv: A comes from registers (wgmma's {a-regs}, descB form), loaded
//   by ldmatrix from the padded tile: a tap's row offset dy (bs+2) + dx
//   breaks the 8-row alignment an A descriptor needs, while ldmatrix takes
//   one row address per lane, so each lane points at its own output pixel's
//   tap row and the product has exactly bs^2 rows (256 at layer2, 64 at
//   layer3).  The tile's rows are padded by 16 bytes, so the 8 rows of an
//   ldmatrix phase fall on distinct banks.
// - 1x1 conv: A (h2) and B (w3) from shared memory by descriptor; the 3x3
//   epilogue writes h2 in the swizzled K-major layout the A descriptor
//   reads.  x arrives by TMA as (bs^2 pixels x 64 channels) swizzled boxes
//   into the space the padded tile held, the epilogue turns each x value
//   into y in place, and a TMA store writes the boxes out.
// - Warpgroup work: where bs^2 >= 128 each warpgroup owns half of the m64
//   tiles, else both share the one m64 tile and split n.
// Two ablation switches, never set by the library build, let
// blockcopy_tpu_torch/tools/tail_breakdown.py time the parts:
// TAIL_NO_3X3_PRODUCTS drops the 3x3 conv's products (fragment loads,
// barriers and epilogue stay), TAIL_NO_1X1_STAGE ends the kernel once h2 is
// built and exchanged.
// bf16 blocks: (bs, Cm) in (16, 128), (8, 256), (8, 128) and Co a multiple
// of 256 (the others do not fit in shared memory); the launch refuses the
// rest (cudaErrorInvalidValue) and the wrapper raises before.
// fp32 runs a scalar FMA kernel (no tensor core gives fp32 exactly); its h2
// goes through a device-memory scratch buffer.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
struct Args {
  const T *h1, *x, *top, *bottom, *left, *right, *tl, *tr, *bl, *br;
  const T *w2;  // (3, 3, Cm, Cm): [dy][dx][co][ci]
  const T *w3;  // (Co, Cm)
  const T *s2, *b2, *s3, *b3;
  T* y;
  int bs, cm, co;
};

// Pixel (py, px) of block k's padded (bs+2)x(bs+2) tile: one channel row.
template <typename T>
__device__ __forceinline__ const T* padded_pixel(const Args<T>& a, int k,
                                                 int py, int px) {
  const int bs = a.bs, cm = a.cm, last = bs + 1;
  if (py == 0) {
    if (px == 0) return a.tl + (size_t)k * cm;
    if (px == last) return a.tr + (size_t)k * cm;
    return a.top + ((size_t)k * bs + px - 1) * cm;
  }
  if (py == last) {
    if (px == 0) return a.bl + (size_t)k * cm;
    if (px == last) return a.br + (size_t)k * cm;
    return a.bottom + ((size_t)k * bs + px - 1) * cm;
  }
  if (px == 0) return a.left + ((size_t)k * bs + py - 1) * cm;
  if (px == last) return a.right + ((size_t)k * bs + py - 1) * cm;
  return a.h1 + (((size_t)k * bs + py - 1) * bs + px - 1) * cm;
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 128 * 128;     // 128 rows of 64 bf16
constexpr int kN1 = 128;                   // output channels of a 1x1 tile
constexpr int kMaxSmem = 232448;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int max_of(int a, int b) { return a > b ? a : b; }

template <int BS, int CM>
struct Tail {
  static constexpr int kM = BS * BS;      // pixels: the rows of both products
  static constexpr int kMT = kM / 64;     // m64 tiles
  static constexpr int kWp = BS + 2;      // padded row width
  static constexpr int kPadPx = kWp * kWp;
  static constexpr int kLda = CM + 8;     // padded-tile row, elements
  static constexpr int kN2 = CM / 2;      // 3x3 outputs of one CTA
  static constexpr int kKc = CM / 64;     // 64-channel k chunks
  static constexpr int kMtw = kMT >= 2 ? kMT / 2 : 1;  // m tiles a warpgroup
  static constexpr int kSplitN = kMT >= 2 ? 1 : 2;     // warpgroups on one
  static constexpr int kN3w = kN2 / kSplitN;           // 3x3 n a warpgroup
  static constexpr int kN1w = kN1 / kSplitN;           // 1x1 n a warpgroup
  static constexpr int kXBytes = 2 * kM * 128;  // x / y of one 1x1 tile
  static constexpr int kPadBytes = round_up(kPadPx * kLda * 2, 1024);
  static constexpr int kH2Bytes = kKc * kM * 128;  // 64-channel panels
  static constexpr int kRest = kH2Bytes + kStages * kStageBytes + 1024;
  // two x / y buffers where they fit, so one tile's x lands while the
  // previous tile's y leaves
  static constexpr int kXBuf =
      max_of(kPadBytes, 2 * kXBytes) + kRest <= kMaxSmem ? 2 : 1;
  static constexpr int kTileBytes = max_of(kPadBytes, kXBuf * kXBytes);
  static constexpr int kSmemBytes = kTileBytes + kRest;
  static_assert(kMT == 1 || kMT % 2 == 0, "m64 tiles split over 2 groups");
  static_assert(kSmemBytes <= kMaxSmem, "block does not fit");
};

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Byte offset of (row m, channel c) in 64-channel panels of rows rows, each
// row 128 bytes, 128-byte swizzled.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int m, int c) {
  return (c / 64) * (ROWS * 128) + m * 128 + (((c % 64) / 8) ^ (m % 8)) * 16 +
         (c % 8) * 2;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int BS, int CM>
__global__ void __launch_bounds__(kThreads, 1)
tail_bf16(Args<bf16> a, const __grid_constant__ CUtensorMap map_w2,
          const __grid_constant__ CUtensorMap map_w3,
          const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_y) {
  using L = Tail<BS, CM>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // per x / y buffer: x of its tile landed, y of its tile written; and the
  // padded tile read (the consumers are past the 3x3 products)
  __shared__ __align__(8) uint64_t xbar[2], ydone[2], tile_free;
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* pad = reinterpret_cast<bf16*>(smem);  // padded tile, then x / y
  char* xs = smem;
  char* h2 = smem + L::kTileBytes;
  char* ring = h2 + L::kH2Bytes;

  const int blk = blockIdx.x / 2, co = a.co;
  const uint32_t rank = cluster_rank();
  const int n_w2 = 9 * L::kKc, n_tiles = co / 2 / kN1;
  // first channel of the nt-th 1x1 tile
  auto tile_c0 = [&](int nt) { return rank * (co / 2) + nt * kN1; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&xbar[b], 1);
      mbar_init(&ydone[b], kConsumers);
    }
    mbar_init(&tile_free, kConsumers);
    fence_barrier_init();
  }
  // barriers ready, and the peer has started: its h2 takes our stores
  cluster_sync();

  const int row0 = blk * L::kM;  // this block's first row of x, y (K bs^2, Co)
  if (threadIdx.x == kConsumers + 1) {
    // x in, y out: x boxes by TMA into the space of the padded tile once
    // the 3x3 products are done with it, y boxes out once written
    auto load_x = [&](int nt) {
      char* buf = xs + nt % L::kXBuf * L::kXBytes;
      const int c0 = tile_c0(nt);
      uint64_t* bar = &xbar[nt % L::kXBuf];
      mbar_expect_tx(bar, L::kXBytes);
      tma_load_2d(buf, &map_x, bar, c0, row0);
      tma_load_2d(buf + L::kM * 128, &map_x, bar, c0 + 64, row0);
    };
#ifndef TAIL_NO_1X1_STAGE
    mbar_wait(&tile_free, 0);
    for (int nt = 0; nt < L::kXBuf && nt < n_tiles; ++nt) load_x(nt);
#endif
    cluster_sync();
#ifndef TAIL_NO_1X1_STAGE
    for (int nt = 0; nt < n_tiles; ++nt) {
      mbar_wait(&ydone[nt % L::kXBuf], (nt / L::kXBuf) & 1);
      const char* buf = xs + nt % L::kXBuf * L::kXBytes;
      const int c0 = tile_c0(nt);
      tma_store_2d(&map_y, buf, c0, row0);
      tma_store_2d(&map_y, buf + L::kM * 128, c0 + 64, row0);
      bulk_commit();
      if (nt + L::kXBuf < n_tiles) {
        bulk_wait_read();  // the buffer is free for the next x
        load_x(nt + L::kXBuf);
      }
    }
    bulk_wait();
#endif
    return;
  }
  if (threadIdx.x >= kConsumers) {
    // producer: one thread streams w2, then w3, through the ring
    if (threadIdx.x != kConsumers) return;
#ifdef TAIL_NO_1X1_STAGE
    const int chunks = n_w2;
#else
    const int chunks = n_w2 + n_tiles * L::kKc;
#endif
    bool joined = false;
    for (int i = 0; i < chunks; ++i) {
      // from here on a stage is freed only after the h2 exchange
      if (i == n_w2 + kStages) {
        cluster_sync();
        joined = true;
      }
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      char* dst = ring + s * kStageBytes;
      if (i < n_w2) {
        const int tap = i / L::kKc, kc = i % L::kKc;
        mbar_expect_tx(&full[s], L::kN2 * 128);
        tma_load_2d(dst, &map_w2, &full[s], kc * 64, tap * CM + rank * L::kN2);
      } else {
        const int t = (i - n_w2) / L::kKc, kc = (i - n_w2) % L::kKc;
        mbar_expect_tx(&full[s], kN1 * 128);
        tma_load_2d(dst, &map_w3, &full[s], kc * 64, tile_c0(t));
      }
    }
    if (!joined) cluster_sync();
    return;
  }

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, wi = t / 32;
  // the padded tile by cp.async, 16 bytes a copy
  constexpr int kVec = CM / 8;
  for (int e = tid; e < L::kPadPx * kVec; e += kConsumers) {
    const int px = e / kVec, v = e % kVec;
    __pipeline_memcpy_async(
        pad + px * L::kLda + v * 8,
        padded_pixel(a, blk, px / L::kWp, px % L::kWp) + v * 8, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  named_sync(1, kConsumers);

  // 3x3 conv -> BN2 -> ReLU into h2.  Warpgroup wg: m tiles mtile(j), n
  // columns [n3, n3 + kN3w) of this CTA's half.
  auto mtile = [&](int j) { return L::kMT >= 2 ? wg * L::kMtw + j : 0; };
  const int n3 = (L::kSplitN == 2 ? wg : 0) * L::kN3w;
  int px0[L::kMtw];  // the lane's ldmatrix row: its pixel's tap-(0, 0) row
#pragma unroll
  for (int j = 0; j < L::kMtw; ++j) {
    const int m = mtile(j) * 64 + wi * 16 + lane % 16;
    px0[j] = (m / BS) * L::kWp + m % BS;
  }
  const int kcol = lane / 16 * 8;
  float acc3[L::kMtw][L::kN3w / 2];
#pragma unroll
  for (int j = 0; j < L::kMtw; ++j)
#pragma unroll
    for (int e = 0; e < L::kN3w / 2; ++e) acc3[j][e] = 0.0f;
  int i = 0;  // chunk counter of the ring
  for (; i < n_w2; ++i) {
    const int s = i % kStages, tap = i / L::kKc, kc = i % L::kKc;
    const int off = (tap / 3) * L::kWp + tap % 3;
    unsigned fa[L::kMtw][4][4];
#pragma unroll
    for (int j = 0; j < L::kMtw; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(fa[j][kk],
                pad + (px0[j] + off) * L::kLda + kc * 64 + kk * 16 + kcol);
    mbar_wait(&full[s], (i / kStages) & 1);
#ifndef TAIL_NO_3X3_PRODUCTS
    const uint32_t b = smem_u32(ring + s * kStageBytes) + n3 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < L::kMtw; ++j)
        wgmma_bf16_rs(acc3[j], fa[j][kk], desc_sw128(b + kk * 32, 16, 1024),
                      1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < L::kMtw; ++j) fence_regs(acc3[j]);
#endif
    if (t == 0) mbar_arrive(&empty[s]);
  }
  fence_proxy_async();  // the tile's reads come before the x loads into it
  mbar_arrive(&tile_free);

  // epilogue: both CTAs get this CTA's half of h2, swizzled as the 1x1's A
  const uint32_t h2_peer = map_cta(smem_u32(h2), rank ^ 1);
#pragma unroll
  for (int j = 0; j < L::kMtw; ++j) {
#pragma unroll
    for (int q = 0; q < L::kN3w / 8; ++q) {
      const int ch = rank * L::kN2 + n3 + 8 * q + 2 * (t % 4);
      const float2 sc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.s2 + ch));
      const float2 bi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.b2 + ch));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mtile(j) * 64 + wi * 16 + lane / 4 + 8 * h;
        float v[2] = {acc3[j][4 * q + 2 * h], acc3[j][4 * q + 2 * h + 1]};
        const float s2v[2] = {sc.x, sc.y}, b2v[2] = {bi.x, bi.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = rb(v[e]);
          v[e] = rb(__fmul_rn(v[e], s2v[e]));
          v[e] = rb(__fadd_rn(v[e], b2v[e]));
          v[e] = v[e] > 0.0f ? v[e] : 0.0f;
        }
        const uint32_t at = swz<L::kM>(m, ch), word = pack(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(h2 + at) = word;
        st_cluster_u32(h2_peer + at, word);
      }
    }
  }
  fence_proxy_async();
  cluster_sync();  // both halves of h2 are in both CTAs
  fence_proxy_async();
#ifdef TAIL_NO_1X1_STAGE
  return;
#endif

  // 1x1 conv -> BN3 -> + x -> ReLU into y, kN1 channels a tile.  Warpgroup
  // wg: m tiles mtile(j), columns [n1, n1 + kN1w) of the tile.
  const int n1 = (L::kSplitN == 2 ? wg : 0) * L::kN1w;
  for (int nt = 0; nt < n_tiles; ++nt) {
    float acc1[L::kMtw][L::kN1w / 2];
#pragma unroll
    for (int j = 0; j < L::kMtw; ++j)
#pragma unroll
      for (int e = 0; e < L::kN1w / 2; ++e) acc1[j][e] = 0.0f;
    for (int kc = 0; kc < L::kKc; ++kc, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t b = smem_u32(ring + s * kStageBytes) + n1 * 128;
      const uint32_t h = smem_u32(h2) + kc * L::kM * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < L::kMtw; ++j)
          wgmma_bf16_ss<0>(
              acc1[j], desc_sw128(h + mtile(j) * 64 * 128 + kk * 32, 16, 1024),
              desc_sw128(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < L::kMtw; ++j) fence_regs(acc1[j]);
      if (t == 0) mbar_arrive(&empty[s]);
    }

    // x of this tile has landed; y replaces it in place
    mbar_wait(&xbar[nt % L::kXBuf], (nt / L::kXBuf) & 1);
    char* buf = xs + nt % L::kXBuf * L::kXBytes;
    const int c0 = tile_c0(nt);
#pragma unroll
    for (int j = 0; j < L::kMtw; ++j) {
#pragma unroll
      for (int q = 0; q < L::kN1w / 8; ++q) {
        const int cl = n1 + 8 * q + 2 * (t % 4);
        const float2 sc = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.s3 + c0 + cl));
        const float2 bi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.b3 + c0 + cl));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mtile(j) * 64 + wi * 16 + lane / 4 + 8 * h;
          __nv_bfloat162* p =
              reinterpret_cast<__nv_bfloat162*>(buf + swz<L::kM>(m, cl));
          const float2 xv = __bfloat1622float2(*p);
          float v[2] = {acc1[j][4 * q + 2 * h], acc1[j][4 * q + 2 * h + 1]};
          const float s3v[2] = {sc.x, sc.y}, b3v[2] = {bi.x, bi.y};
          const float xr[2] = {xv.x, xv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = rb(v[e]);
            v[e] = rb(__fmul_rn(v[e], s3v[e]));
            v[e] = rb(__fadd_rn(v[e], b3v[e]));
            v[e] = rb(__fadd_rn(v[e], xr[e]));
            v[e] = v[e] > 0.0f ? v[e] : 0.0f;
          }
          *p = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
    fence_proxy_async();  // y before the TMA store reads it
    mbar_arrive(&ydone[nt % L::kXBuf]);
  }
}

template <int BS, int CM>
int launch_bf16(const Args<bf16>& a, int k, cudaStream_t stream) {
  using L = Tail<BS, CM>;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t rows = (uint64_t)k * L::kM;
  CUtensorMap mw2, mw3, mx, my;
  int err = encode_2d(&mw2, kBf16, a.w2, CM, 9 * CM, CM * 2, 64, L::kN2, kSw);
  if (!err) err = encode_2d(&mw3, kBf16, a.w3, CM, a.co, CM * 2, 64, kN1, kSw);
  if (!err)
    err = encode_2d(&mx, kBf16, a.x, a.co, rows, a.co * 2, 64, L::kM, kSw);
  if (!err)
    err = encode_2d(&my, kBf16, a.y, a.co, rows, a.co * 2, 64, L::kM, kSw);
  if (err) return err;
  // raised once, never again (a CUDA graph capture may be open)
  static bool raised = false;
  if (!raised) {
    cudaError_t e =
        cudaFuncSetAttribute(tail_bf16<BS, CM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, tail_bf16<BS, CM>, a, mw2, mw3, mx, my);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The blocks the bf16 kernel takes (ops/kernels/bottleneck.py BF16_BLOCKS)
bool bf16_block(int bs, int cm) {
  return (bs == 16 && cm == 128) || (bs == 8 && (cm == 256 || cm == 128));
}

// ---------------------------------------------------------------- fp32 ----

constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
tail_f32(Args<float> a, float* __restrict__ h2_scratch) {
  const int k = blockIdx.x, tid = threadIdx.x;
  const int bs = a.bs, cm = a.cm, co = a.co, m_all = bs * bs;
  float* h2 = h2_scratch + (size_t)k * m_all * cm;

  for (int e = tid; e < m_all * cm; e += kF32Threads) {
    const int m = e / cm, c = e % cm;
    const int oy = m / bs, ox = m % bs;
    float acc = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* src = padded_pixel(a, k, oy + tap / 3, ox + tap % 3);
      const float* w = a.w2 + ((size_t)tap * cm + c) * cm;
      for (int ci = 0; ci < cm; ++ci) acc = fmaf(src[ci], w[ci], acc);
    }
    const float v = __fadd_rn(__fmul_rn(acc, a.s2[c]), a.b2[c]);
    h2[e] = v > 0.0f ? v : 0.0f;
  }
  __syncthreads();

  const size_t base = (size_t)k * m_all;
  for (int e = tid; e < m_all * co; e += kF32Threads) {
    const int m = e / co, o = e % co;
    const float* hrow = h2 + (size_t)m * cm;
    const float* w = a.w3 + (size_t)o * cm;
    float acc = 0.0f;
    for (int c = 0; c < cm; ++c) acc = fmaf(hrow[c], w[c], acc);
    const size_t at = (base + m) * co + o;
    float v = __fadd_rn(__fmul_rn(acc, a.s3[o]), a.b3[o]);
    v = __fadd_rn(v, a.x[at]);
    a.y[at] = v > 0.0f ? v : 0.0f;
  }
}

template <typename T>
Args<T> make_args(void* const* p, int bs, int cm, int co) {
  Args<T> a;
  const T** in[] = {&a.h1, &a.x, &a.top, &a.bottom, &a.left, &a.right, &a.tl,
                    &a.tr, &a.bl, &a.br, &a.w2, &a.w3, &a.s2, &a.b2, &a.s3,
                    &a.b3};
  for (int i = 0; i < 16; ++i) *in[i] = static_cast<const T*>(p[i]);
  a.y = static_cast<T*>(p[16]);
  a.bs = bs;
  a.cm = cm;
  a.co = co;
  return a;
}

}  // namespace

// ptrs: h1, x, top, bottom, left, right, top_left, top_right, bottom_left,
// bottom_right, w2, w3, s2, b2, s3, b3, y (17 device pointers; weights as
// prepare_tail_weights lays them out).
// dtype: 0 = fp32 (h2_scratch (K, bs*bs, Cm) fp32 required), 1 = bf16.
extern "C" int bottleneck_tail(void* const* ptrs, void* h2_scratch, int k,
                               int bs, int cm, int co, int dtype,
                               void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!bf16_block(bs, cm) || co % (2 * kN1)) return (int)cudaErrorInvalidValue;
    const Args<bf16> a = make_args<bf16>(ptrs, bs, cm, co);
    if (bs == 16) return launch_bf16<16, 128>(a, k, s);
    if (cm == 256) return launch_bf16<8, 256>(a, k, s);
    return launch_bf16<8, 128>(a, k, s);
  }
  tail_f32<<<k, kF32Threads, 0, s>>>(make_args<float>(ptrs, bs, cm, co),
                                     static_cast<float*>(h2_scratch));
  return (int)cudaGetLastError();
}
