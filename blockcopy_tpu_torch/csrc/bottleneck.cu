// Fused bottleneck tail for stride-1 identity ResNet bottlenecks:
//   y = relu(bn3(conv1x1(relu(bn2(conv3x3(pad(h1)))))) + x)
//
// Replaces the Pallas kernel blockcopy_tpu/ops/pallas/bottleneck.py
// (bottleneck_tail :92, _kernel :50).  The padded tile is built from h1 and
// the halo site's edge strips, just written by the strip exchange: each
// halo pixel is read straight from its neighbour's strip (halo.cuh), so the
// 8 pieces the JAX package gathers first (blocked.py:401-416) never reach
// device memory and take no launch of their own.  A CTA computes its
// block's 8 neighbour indices once, into shared memory, before it stages.
// Numerics follow :82-89: the 3x3
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
// Three switches, never set by the library build, let
// blockcopy_tpu_torch/tools/tail_breakdown.py time the parts:
// TAIL_NO_3X3_PRODUCTS drops the 3x3 conv's products (fragment loads,
// barriers and epilogue stay), TAIL_NO_1X1_STAGE ends the kernel once h2 is
// built and exchanged (both in this route and in the row route);
// TAIL_F32_BM (64 or 32) fixes the fp32 row tile.
// This wgmma route takes (bs, Cm) in (16, 128), (8, 256), (8, 128) with Co a
// multiple of 256: a larger block's padded tile does not fit in shared
// memory (at (32, 128) the tile alone takes 314,432 bytes of the 232,448 a
// block can have).  Every other bf16 block with Cm and Co multiples of 64
// takes the row route (the same design over bands of a block's rows staged
// one 64-channel chunk at a time: see the row section).  fp32 runs two
// GEMM launches over rows flattened across blocks on mma.sync TF32 with a
// 3-product split (3xTF32): see the fp32 section.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "halo.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
struct Args {
  const T *h1, *x;
  const T *rows;  // (T+1, 2, bs, Cm): every block's top and bottom rows
  const T *cols;  // (T+1, bs, 2, Cm): its left and right columns
  const long long* idx;  // (K,) flat block indices; T: a padding slot
  const T *w2;  // (3, 3, Cm, Cm): [dy][dx][co][ci]
  const T *w3;  // (Co, Cm)
  const T *s2, *b2, *s3, *b3;
  T* y;
  int bs, cm, co;
  int n, gh, gw;  // the grid; T = n gh gw
};

// Block k's 8 neighbour indices into nb, by threads 0-7 of the CTA; the
// caller synchronises before any padded_pixel reads them.
template <typename T>
__device__ __forceinline__ void block_neighbours(const Args<T>& a, int k,
                                                 long long* nb) {
  if (threadIdx.x < 8)
    nb[threadIdx.x] = halo::neighbour(a.idx[k], threadIdx.x, a.n, a.gh, a.gw);
}

// Pixel (py, px) of block k's padded (bs+2)x(bs+2) tile: one channel row,
// of h1 inside, of a neighbour's strip on the halo (nb: block k's 8
// neighbour indices).
template <typename T>
__device__ __forceinline__ const T* padded_pixel(const Args<T>& a, int k,
                                                 const long long* nb, int py,
                                                 int px) {
  const int bs = a.bs;
  if (py >= 1 && py <= bs && px >= 1 && px <= bs)
    return a.h1 + (((size_t)k * bs + py - 1) * bs + px - 1) * a.cm;
  return halo::strip_pixel(a.rows, a.cols, nb, bs, 1, py, px, a.cm);
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 128 * 128;     // 128 rows of 64 bf16
constexpr int kN1 = 128;                   // output channels of a 1x1 tile
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int max_of(int a, int b) {
  return a > b ? a : b;
}

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

// 32-bit shared-memory load and store at a shared address (a generic
// pointer into dynamic shared memory would compile to generic accesses)
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
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
  __shared__ long long nb[8];  // the block's neighbours, for the staging
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
  block_neighbours(a, blk, nb);
  // barriers and neighbours ready, and the peer has started: its h2 takes
  // our stores
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
        padded_pixel(a, blk, nb, px / L::kWp, px % L::kWp) + v * 8, 16);
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

// The blocks the wgmma route takes (ops/kernels/bottleneck.py BF16_BLOCKS)
bool bf16_block(int bs, int cm) {
  return (bs == 16 && cm == 128) || (bs == 8 && (cm == 256 || cm == 128));
}

// ---------------------------------------------------------------- fp32 ----
//
// Replaces the same Pallas kernel (bottleneck.py bottleneck_tail :92) in
// fp32.  Bound: operations, 3 x 2 K bs^2 Cm (9 Cm + Co) over 495 TFLOP/s
// of TF32 (this route: 3 TF32 products per fp32 product; 0.042 ms at K = 64
// for either RN50 shape, where fp32 outside the tensor cores, 67 TFLOP/s,
// would take 0.104 ms); the bytes (h1, x, y, the halo, the weights, each
// once) take 0.013-0.024 ms at 3.35 TB/s.
// Design: the tail as two GEMMs over rows m = (block, pixel) flattened
// across blocks, so every launch spreads over all SMs whatever K is:
// - stage A: h2 (K bs^2 x Cm) = relu(bn2(A w2)), depth 9 Cm as (tap, ci),
//   the A row of pixel (k, oy, ox) at tap (dy, dx) being padded_pixel(k,
//   oy + dy, ox + dx): h1 or a neighbour's strip (the 8 neighbours of each
//   block a tile's rows reach are computed once a CTA, into shared memory),
//   so the padded tile is never built; h2 goes to the wrapper's fp32 scratch (16.8 MB at K = 128,
//   L2-resident for stage B);
// - stage B: y (K bs^2 x Co) = relu(bn3(h2 w3) + x), depth Cm.
// A CTA of 4 warps (2 x 2) computes a BM x 64 tile (BM 64, or 32 where
// 64-row tiles would not fill one wave), streaming 32-deep A and B slices
// through 3 shared-memory stages by cp.async (16-byte pieces; rows padded by
// 4 floats, so the fragment loads of a warp hit 32 distinct banks).
// Products run on mma.sync m16n8k8 TF32, 3 per product (3xTF32): each
// operand v splits into hi = rna(v) and lo = rna(v - hi), and lo hi + hi lo
// is accumulated before hi hi (lo lo is dropped); one TF32 product keeps
// about 3 digits and misses 1e-4.  The tensor cores round their fp32 sums
// toward zero, an error that grows with the depth (2304 at layer3), so each
// 32-deep stage is summed on its own and added to the total with
// round-to-nearest fp32 adds.  The epilogues round as the plain
// version: acc * s + b in two roundings, (+ x), ReLU.  Row tiles past K
// bs^2 are masked: loads clamp to the last row, stores are skipped.

constexpr int kF32Threads = 128;  // four warps, 2 x 2 over the tile
constexpr int kF32BN = 64;        // output channels of a tile
constexpr int kF32BK = 32;        // depth of a stage, floats
constexpr int kF32Ld = kF32BK + 4;  // shared-memory row, floats
constexpr int kF32Stages = 3;

template <int BM>
constexpr int f32_smem_bytes() {
  return kF32Stages * (BM + kF32BN) * kF32Ld * 4;
}

// Blocks of bs^2 rows a BM-row tile can reach (stage A keeps their 8
// neighbours each in shared memory): at most BM + 1, where bs is 1
template <int BM>
int f32_tile_blocks(int bs) {
  return (BM - 1) / (bs * bs) + 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a b: A 16 x 8 (row), B 8 x 8 (col), D 16 x 8, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One BM x 64 tile of stage A (CONV: the 3x3 conv into h2) or of stage B
// (the 1x1 over h2 into y); rows = K bs^2.
template <int BM, bool CONV>
__global__ void __launch_bounds__(kF32Threads)
tail_f32(Args<float> a, float* h2, int rows) {
  constexpr int kMT = BM / 32;  // m16 tiles of a warp (BM / 2 rows)
  constexpr int kNT = 4;        // n8 tiles of a warp (32 columns)
  constexpr int kRowStep = kF32Threads / 8;  // rows a pass of the copy
  constexpr int kAPieces = BM / kRowStep;    // A rows a thread copies
  constexpr int kBPieces = kF32BN / kRowStep;
  extern __shared__ __align__(16) float smem_f[];
  float* As = smem_f;                                // [stage][BM][kF32Ld]
  float* Bs = smem_f + kF32Stages * BM * kF32Ld;     // [stage][64][kF32Ld]
  // stage A: [block of the tile - blk0][8] neighbour indices
  long long* nbs =
      reinterpret_cast<long long*>(Bs + kF32Stages * kF32BN * kF32Ld);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kF32BN;
  const int cm = a.cm, bs = a.bs;
  const int chunks = cm / kF32BK;  // stages of one tap
  const int iters = (CONV ? 9 : 1) * chunks;

  // the rows this thread copies: row tid / 8 + i kRowStep, 16 bytes at
  // float 4 (tid % 8) of the stage's 32
  const int r0 = tid / 8, c4 = (tid % 8) * 4;
  int blk[kAPieces], oy[kAPieces], ox[kAPieces];
#pragma unroll
  for (int i = 0; i < kAPieces; ++i) {
    const int m = min(m0 + r0 + i * kRowStep, rows - 1);
    const int p = m % (bs * bs);
    blk[i] = m / (bs * bs);
    oy[i] = p / bs;
    ox[i] = p % bs;
  }
  const int blk0 = m0 / (bs * bs);
  if (CONV) {
    const int span = (min(m0 + BM, rows) - 1) / (bs * bs) - blk0 + 1;
    for (int e = tid; e < span * 8; e += kF32Threads)
      nbs[e] = halo::neighbour(a.idx[blk0 + e / 8], e % 8, a.n, a.gh, a.gw);
    __syncthreads();
  }

  auto load = [&](int it, int s) {
    const int tap = it / chunks, c0 = (it % chunks) * kF32BK + c4;
    float* as = As + s * BM * kF32Ld + c4;
    float* bsm = Bs + s * kF32BN * kF32Ld + c4;
#pragma unroll
    for (int i = 0; i < kAPieces; ++i) {
      const float* src =
          CONV ? padded_pixel(a, blk[i], nbs + (blk[i] - blk0) * 8,
                              oy[i] + tap / 3, ox[i] + tap % 3)
               : h2 + ((size_t)blk[i] * bs * bs + oy[i] * bs + ox[i]) * cm;
      cp_async16(as + (r0 + i * kRowStep) * kF32Ld, src + c0);
    }
    const float* w = CONV ? a.w2 + (size_t)tap * cm * cm : a.w3;
#pragma unroll
    for (int i = 0; i < kBPieces; ++i) {
      const int n = r0 + i * kRowStep;
      cp_async16(bsm + n * kF32Ld, w + (size_t)(n0 + n) * cm + c0);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // stage it landed; stage it - 1 is read by all
    if (it + kF32Stages - 1 < iters)
      load(it + kF32Stages - 1, (it + kF32Stages - 1) % kF32Stages);
    cp_async_commit();
    const int s = it % kF32Stages;
    const float* as = As + (s * BM + wm * (BM / 2)) * kF32Ld;
    const float* bsm = Bs + (s * kF32BN + wn * 32) * kF32Ld;
    float part[kMT][kNT][4];  // this stage's products
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kF32BK; kk += 8) {
      uint32_t ahi[kMT][4], alo[kMT][4], bhi[kNT][2], blo[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // rows g, g + 8 of the m16 tile; columns t, t + 4 of the k8 step
        const float* p = as + (i * 16 + g) * kF32Ld + kk + t;
        split_tf32(p[0], ahi[i][0], alo[i][0]);
        split_tf32(p[8 * kF32Ld], ahi[i][1], alo[i][1]);
        split_tf32(p[4], ahi[i][2], alo[i][2]);
        split_tf32(p[8 * kF32Ld + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // column g of the n8 tile; rows t, t + 4 of the k8 step
        const float* q = bsm + (j * 8 + g) * kF32Ld + kk + t;
        split_tf32(q[0], bhi[j][0], blo[j][0]);
        split_tf32(q[4], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_tf32(part[i][j], alo[i], bhi[j]);
          mma_tf32(part[i][j], ahi[i], blo[j]);
          mma_tf32(part[i][j], ahi[i], bhi[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  cp_async_wait<0>();

  const int ld = CONV ? cm : a.co;
  const float* sc = CONV ? a.s2 : a.s3;
  const float* bi = CONV ? a.b2 : a.b3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * (BM / 2) + i * 16 + g + 8 * h;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const size_t at = (size_t)m * ld + n;
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        float2 xv = make_float2(0.0f, 0.0f);
        if (!CONV) xv = *reinterpret_cast<const float2*>(a.x + at);
        const float xr[2] = {xv.x, xv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fadd_rn(__fmul_rn(v[e], sc[n + e]), bi[n + e]);
          if (!CONV) v[e] = __fadd_rn(v[e], xr[e]);
          v[e] = v[e] > 0.0f ? v[e] : 0.0f;
        }
        float* out = CONV ? h2 + at : a.y + at;
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      }
    }
}

// One stage: a grid of row tiles x 64-column tiles.  The dynamic
// shared-memory limit is raised once, never again (a CUDA graph capture
// may be open).
template <int BM, bool CONV>
int launch_f32_stage(const Args<float>& a, float* h2, int rows, int n,
                     cudaStream_t stream) {
  constexpr int kSmem = f32_smem_bytes<BM>();
  static bool raised = false;
  if (!raised) {  // to what any bs may take
    cudaError_t e = cudaFuncSetAttribute(
        tail_f32<BM, CONV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem + (CONV ? 64 * f32_tile_blocks<BM>(1) : 0));
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int smem = kSmem + (CONV ? 64 * f32_tile_blocks<BM>(a.bs) : 0);
  const dim3 grid((rows + BM - 1) / BM, n / kF32BN);
  tail_f32<BM, CONV><<<grid, kF32Threads, smem, stream>>>(a, h2, rows);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// 32-row tiles where 64-row ones would leave SMs idle (under one wave)
bool f32_small_tiles(int rows, int n) {
#ifdef TAIL_F32_BM
  return TAIL_F32_BM == 32;
#else
  return (long)((rows + 63) / 64) * (n / kF32BN) < sm_count();
#endif
}

int launch_f32(const Args<float>& a, float* h2, int k, cudaStream_t stream) {
  const int rows = k * a.bs * a.bs;
  int err = f32_small_tiles(rows, a.cm)
                ? launch_f32_stage<32, true>(a, h2, rows, a.cm, stream)
                : launch_f32_stage<64, true>(a, h2, rows, a.cm, stream);
  if (err) return err;
  return f32_small_tiles(rows, a.co)
             ? launch_f32_stage<32, false>(a, h2, rows, a.co, stream)
             : launch_f32_stage<64, false>(a, h2, rows, a.co, stream);
}

// ------------------------------------------------------ bf16, row route ----
//
// Replaces the same Pallas kernel (bottleneck.py bottleneck_tail :92) in
// bf16 for every block the wgmma route above cannot hold in shared memory:
// any bs up to 128 with Cm and Co multiples of 64 and Cm at most 1024, a
// superset of the blocks the JAX gate fuses (swiftnet.py:283-298) in every
// model the repository builds.  Bound at RN50's block-256 blocks, K = 16
// (the block-256 stepper's capacity), from the data sheet's 989 TFLOP/s
// bf16 and 3.35 TB/s: (32, 128, 512) moves 38.7 MB, 0.0116 ms, so bytes
// bound it; (16, 256, 1024) and (8, 512, 2048) do 6.98 GFLOP, 0.0071 ms, so
// operations do.
// Design: one launch, everything between h1 and y kept on chip, like the
// wgmma route, but over bands instead of whole blocks:
// - A band is R image rows of one block (R bs output pixels, M = 64 MT
//   product rows with MT 1 or 2, R = M / bs; the last band of a block may
//   be shorter).  A cluster of CS CTAs (1, 2 or 4) owns a band: CTA r
//   computes h2's channels [r Cm/CS, (r+1) Cm/CS), writes them into every
//   CTA's h2 (st.shared::cluster), and after a cluster barrier computes
//   y's channels [r Co/CS, (r+1) Co/CS).  (Clusters of 8 at 228 KB a CTA
//   did not all fit on the card at once: 128 CTAs ran in two waves.)
// - The band's padded input, (R+2) x (bs+2) pixels from h1 and the
//   neighbours' strips, is staged one 64-channel chunk at a time by
//   cp.async into
//   shared memory (two buffers: the next chunk lands while this one is
//   read), pixel rows padded to 144 bytes so the 8 rows of an ldmatrix phase fall on
//   distinct banks.  Each input pixel crosses from L2 (R+2)/R times, not 9
//   times as a row-gathered GEMM would fetch it.
// - 3x3 conv: the 9 taps read the staged chunk through per-lane ldmatrix
//   row addresses into wgmma's register A operand, as the wgmma route does;
//   one tap's products stay in flight while the next tap's weights are
//   awaited and its fragments load, and narrow passes alternate taps
//   between two accumulators (on the H100 a tap costs ~650 cycles however
//   narrow).
//   Each tap's w2 box (NP output channels x 64 input channels) and then the
//   w3 boxes (128 channels x 64) arrive by TMA, 128-byte swizzled, through a
//   ring of up to 8 mbarrier-guarded stages fed by one producer warp.  NP,
//   the channels of a pass, is 64, 128 or 256: where a CTA's Cm/CS exceeds
//   it the 3x3 runs in passes, restaging the input.
// - The 3x3 epilogue writes h2 (M x Cm) in the swizzled K-major layout an
//   A descriptor reads; the 1x1 runs wgmma from shared memory over NT-wide
//   tiles of y (NT = 128 a warpgroup where it fits: narrower tiles make a
//   long chain of small dependent products), x arrives by TMA into a tile
//   buffer as (64 channels x R bs pixels) boxes of a (Co, bs^2, K) tensor
//   map (the later tiles prefetched into L2 at the start), the epilogue
//   turns x into y in place, and a TMA store writes it out.  The map's
//   bs^2 bound zero-fills and clips a short last band, so no box reaches
//   another block.  Both epilogues run two channels a bf16x2 operation out
//   of registers holding the BN vectors, loaded ahead: scalar epilogues
//   with loads behind their stores took half a launch.
// - Warpgroup work: at MT 2 each warpgroup owns one m64 tile, at MT 1 both
//   share it and split the pass and the tile.
// The launch plan (band_plan, mirrored by ops/kernels/bottleneck.py
// row_plan and checked against it through bottleneck_rows_plan) is a pure
// function of (K, bs, Cm, Co) and the SM count: of the (MT, CS) pairs whose
// buffers fit in shared memory, the one with the fewest product rows x
// columns a CTA issues (padding included) times waves of CTAs, ties to the
// smaller CS and then the larger MT; for each, the widest pass and tile
// and the deepest ring that fit.  So a small K spreads over clusters and
// short bands.  On 132 SMs (MT, CS, NP, NT): RN50 at block 256, K = 16,
// takes (2, 1, 128, 128) on (32, 128, 512) (128 CTAs), (1, 2, 128, 256) on
// (16, 256, 1024) (128) and (1, 4, 128, 256) on (8, 512, 2048) (64); at
// K = 2, (1, 2, 64, 256), (1, 4, 64, 256) and (1, 4, 128, 256) (64, 32
// and 8 CTAs).  Every plan fuses the 1x1 stage: h2 of a 64-row band takes
// 2 Cm x 64 bytes, which fits beside the ring and the band up to Cm 1024
// (wide_resnet50_2's widest); a larger Cm or bs has no plan and the entry
// refuses it.

constexpr int kBandLd = 72;  // staged pixel: 64 channels + 8 pad, bf16
// two consumer warpgroups, a producer warp and an x / y warp: the two
// single-thread roles spin on barriers, and in one warp each would hold up
// the other
constexpr int kBandThreads = kConsumers + 64;
constexpr int kBandStages = 8;  // most weight-ring stages
constexpr int kBandSmemMax = kMaxSmem - 1024;  // the barriers are static

struct BandPlan {
  int mt;      // m64 tiles a band
  int rows;    // image rows a band (R)
  int bands;   // bands a block
  int cs;      // CTAs a cluster
  int np;      // channels of a 3x3 pass
  int nt;      // channels of a 1x1 tile
  int stages;  // weight-ring stages
  int xbuf;    // x / y tile buffers
  int smem;    // dynamic shared memory, bytes; 0: no plan
};

int band_smem(int bs, int cm, int mt, int rows, int np, int nt, int stages,
              int xbuf) {
  const int m = 64 * mt;
  return stages * max_of(np, 128) * 128 + cm * m * 2 + xbuf * nt * m * 2 +
         2 * round_up((rows + 2) * (bs + 2) * kBandLd * 2, 1024) + 1024;
}

BandPlan band_plan(int k, int bs, int cm, int co, int sms) {
  BandPlan best = {};
  long best_cost = -1;
  for (int cs = 1; cs <= 4; cs *= 2) {
    if (cm % (64 * cs) || co % (64 * cs)) continue;
    for (int mt = 2; mt >= 1; --mt) {
      const int m = 64 * mt, rows = bs < m / bs ? bs : m / bs;
      if (rows == 0 || (mt == 2 && bs * bs <= 64)) continue;
      const int n3 = cm / cs, cap = mt == 1 ? 256 : 128;
      int widest = 64;
      while (2 * widest <= n3 && 2 * widest <= cap) widest *= 2;
      // the widest 3x3 pass, then 1x1 tiles of 128 channels a warpgroup,
      // then the deepest ring (the products wait for their weights where
      // few are in flight), then two x / y buffers, that fit
      const int fits[9][2] = {{8, 2}, {8, 1}, {6, 2}, {6, 1}, {4, 2},
                              {4, 1}, {3, 2}, {3, 1}, {2, 1}};
      int np = 0, nt = 0, stages = 0, xbuf = 0, smem = 0;
      for (int w = widest; w >= 64 && !stages; w /= 2) {
        for (int n = mt == 1 ? 256 : 128; n >= 128 && !stages; n -= 128) {
          for (const auto& f : fits) {
            // a chunk's stages are released one chunk late: twice its count
            if (f[0] < 2 * (n / 128)) continue;
            smem = band_smem(bs, cm, mt, rows, w, n, f[0], f[1]);
            if (smem <= kBandSmemMax) {
              np = w;
              nt = n;
              stages = f[0];
              xbuf = f[1];
              break;
            }
          }
        }
      }
      if (!stages) continue;
      const int bands = (bs + rows - 1) / rows;
      const long ctas = (long)k * bands * cs;
      const long passes = (n3 + np - 1) / np;
      const long tiles = (co / cs + nt - 1) / nt;
      const long cost = (ctas + sms - 1) / sms * m *
                        (9L * cm * passes * np + (long)cm * tiles * nt);
      if (best_cost < 0 || cost < best_cost) {
        best = {mt, rows, bands, cs, np, nt, stages, xbuf, smem};
        best_cost = cost;
      }
    }
  }
  return best;
}

template <int MT, int NW, int NT>
__global__ void __launch_bounds__(kBandThreads, 1)
tail_band(Args<bf16> a, BandPlan pl,
          const __grid_constant__ CUtensorMap map_w2,
          const __grid_constant__ CUtensorMap map_w3,
          const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_y) {
  constexpr int kM = 64 * MT;                 // product rows of a band
  constexpr int kNP = MT == 1 ? 2 * NW : NW;  // channels of a 3x3 pass
  // channels of a 1x1 tile: 128 a warpgroup whatever the pass where they
  // fit (a narrow tile makes a long chain of small dependent products)
  constexpr int kNT = NT, kNW1 = MT == 1 ? NT / 2 : NT;
  // a ring stage holds one w2 box or 128 rows of w3: a 256-channel tile
  // takes two stages a chunk, one for each warpgroup
  constexpr int kStage = max_of(kNP, 128) * 128, kHalves = kNT / 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kBandStages], empty[kBandStages];
  // per x / y buffer: x of its tile landed, y of its tile written
  __shared__ __align__(8) uint64_t xbar[2], ydone[2];
  __shared__ long long nb[8];  // the block's neighbours, for the staging
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bs = a.bs, cm = a.cm, kcs = cm / 64, stages = pl.stages;
  const int xbuf = pl.xbuf, cs = pl.cs, wp = bs + 2;
  char* h2 = ring + stages * kStage;
  char* xs = h2 + kcs * kM * 128;
  constexpr int kXBytes = kNT / 64 * kM * 128;  // one x / y buffer
  bf16* band = reinterpret_cast<bf16*>(xs + xbuf * kXBytes);
  const int band_elems = round_up((pl.rows + 2) * wp * kBandLd * 2, 1024) / 2;

  const uint32_t rank = cluster_rank();
  const int band_id = blockIdx.x / cs;
  const int blk = band_id / pl.bands, r0 = band_id % pl.bands * pl.rows;
  const int rv = min(pl.rows, bs - r0);  // image rows of this band
  const int n3 = cm / cs, h0 = rank * n3;       // this CTA's h2 channels
  const int cy = a.co / cs, y0 = rank * cy;     // and y channels
  const int passes = (n3 + kNP - 1) / kNP, tiles = (cy + kNT - 1) / kNT;
  const int n_w2 = passes * kcs * 9;
  auto boxes = [&](int t) { return min(kNT, cy - t * kNT) / 64; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&xbar[b], 1);
      mbar_init(&ydone[b], kConsumers);
    }
    fence_barrier_init();
  }
  block_neighbours(a, blk, nb);
  // barriers and neighbours ready, and the peers have started: their h2
  // takes our stores
  cluster_sync();

  if (threadIdx.x >= kConsumers + 32) {
    // x in, y out, as (64 channels x R bs pixels) boxes of block blk, by
    // one thread
    if (threadIdx.x != kConsumers + 32) return;
    const int px0 = r0 * bs, box_bytes = pl.rows * bs * 128;
    auto load_x = [&](int t) {
      char* buf = xs + t % xbuf * kXBytes;
      uint64_t* bar = &xbar[t % xbuf];
      mbar_expect_tx(bar, boxes(t) * box_bytes);
      for (int b = 0; b < boxes(t); ++b)
        tma_load_3d(buf + b * kM * 128, &map_x, bar, y0 + t * kNT + 64 * b,
                    px0, blk);
    };
#ifndef TAIL_NO_1X1_STAGE
    for (int t = 0; t < tiles; ++t) {
      if (t < xbuf) {
        load_x(t);
      } else {  // into L2 while the 3x3 runs, so its load waits less
        for (int b = 0; b < boxes(t); ++b)
          tma_prefetch_3d(&map_x, y0 + t * kNT + 64 * b, px0, blk);
      }
    }
#endif
    cluster_sync();
#ifndef TAIL_NO_1X1_STAGE
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(&ydone[t % xbuf], (t / xbuf) & 1);
      const char* buf = xs + t % xbuf * kXBytes;
      for (int b = 0; b < boxes(t); ++b)
        tma_store_3d(&map_y, buf + b * kM * 128, y0 + t * kNT + 64 * b, px0,
                     blk);
      bulk_commit();
      if (t + xbuf < tiles) {
        bulk_wait_read();  // the buffer is free for the next x
        load_x(t + xbuf);
      }
    }
    bulk_wait();
#endif
    return;
  }
  if (threadIdx.x >= kConsumers) {
    // producer: one thread streams w2 (by pass, chunk, tap), then w3 (by
    // tile, chunk), through the ring
    if (threadIdx.x != kConsumers) return;
#ifdef TAIL_NO_1X1_STAGE
    const int chunks = n_w2;
#else
    const int chunks = n_w2 + tiles * kcs * kHalves;
#endif
    bool joined = false;
    for (int i = 0; i < chunks; ++i) {
      // from here on a stage is freed only after the h2 exchange
      if (i == n_w2 + stages) {
        cluster_sync();
        joined = true;
      }
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      char* dst = ring + s * kStage;
      if (i < n_w2) {
        const int p = i / (9 * kcs), kc = i / 9 % kcs, tap = i % 9;
        mbar_expect_tx(&full[s], kNP * 128);
        tma_load_2d(dst, &map_w2, &full[s], kc * 64, tap * cm + h0 + p * kNP);
      } else {
        const int j = (i - n_w2) / kHalves, hf = (i - n_w2) % kHalves;
        const int t = j / kcs, kc = j % kcs;
        mbar_expect_tx(&full[s], 128 * 128);
        tma_load_2d(dst, &map_w3, &full[s], kc * 64, y0 + t * kNT + hf * 128);
      }
    }
    if (!joined) cluster_sync();
    return;
  }

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, wi = t / 32;
  const int mt = MT == 2 ? wg : 0;        // this warpgroup's m64 tile
  const int nw0 = MT == 1 ? wg * NW : 0;  // its columns of a pass or tile
  // the lane's ldmatrix row: its output pixel's tap-(0, 0) staged pixel
  // (rows past the band read its last pixel; their results are dropped)
  const int pv = rv * bs;
  const int mrow = min(mt * 64 + wi * 16 + lane % 16, pv - 1);
  const bf16* lane_px =
      band + ((mrow / bs) * wp + mrow % bs) * kBandLd + lane / 16 * 8;
  // chunk kc of the band's padded input into buffer `buf`
  auto stage = [&](int kc, int buf) {
    bf16* dst = band + buf * band_elems;
    for (int e = tid; e < (rv + 2) * wp * 8; e += kConsumers) {
      const int px = e / 8, v = e % 8;
      cp_async16(dst + px * kBandLd + v * 8,
                 padded_pixel(a, blk, nb, r0 + px / wp, px % wp) + kc * 64 +
                     v * 8);
    }
  };

  const int steps = passes * kcs;  // staged chunks
  stage(0, 0);
  cp_async_commit();
  if (steps > 1) stage(1 % kcs, 1);
  cp_async_commit();
  // 3x3 conv -> BN2 -> ReLU into h2, a pass of kNP channels at a time;
  // taps alternate between kChains accumulators: a narrow tap's products
  // are latency-bound, and two independent chains overlap
  constexpr int kChains = NW <= 64 ? 2 : 1;
  float acc[kChains][NW / 2];
  // this pass's BN2 scale and bias, loaded ahead of the epilogue
  __nv_bfloat162 s2q[NW / 8], b2q[NW / 8];
  int i = 0;  // chunk counter of the ring
  for (int pc = 0; pc < steps; ++pc) {
    const int p = pc / kcs, kc = pc % kcs;
    if (kc == 0) {
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int e = 0; e < NW / 2; ++e) acc[c][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < NW / 8; ++q) {
        const int ch = min(h0 + p * kNP + nw0 + 8 * q + 2 * (t % 4), cm - 2);
        s2q[q] = __ldg(reinterpret_cast<const __nv_bfloat162*>(a.s2 + ch));
        b2q[q] = __ldg(reinterpret_cast<const __nv_bfloat162*>(a.b2 + ch));
      }
    }
    cp_async_wait<1>();  // chunk pc has landed
    named_sync(1, kConsumers);
    const bf16* src = lane_px + pc % 2 * band_elems;
    unsigned fa[2][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(fa[0][kk], src + kk * 16);
    // one tap's products stay in flight while the next tap's weights are
    // awaited and its fragments load
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
#ifndef TAIL_NO_3X3_PRODUCTS
      const uint32_t b = smem_u32(ring + s * kStage) + nw0 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs(acc[tap % kChains], fa[tap % 2][kk],
                      desc_sw128(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous tap's products are done
#pragma unroll
      for (int c = 0; c < kChains; ++c) fence_regs(acc[c]);
#endif
      if (tap > 0 && t == 0) mbar_arrive(&empty[(i - 1) % stages]);
      if (tap < 8) {  // into the registers the previous tap read
        const int off = ((tap + 1) / 3 * wp + (tap + 1) % 3) * kBandLd;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(fa[(tap + 1) % 2][kk], src + off + kk * 16);
      }
    }
#ifndef TAIL_NO_3X3_PRODUCTS
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChains; ++c) fence_regs(acc[c]);
#endif
    if (t == 0) mbar_arrive(&empty[(i - 1) % stages]);
    named_sync(1, kConsumers);  // every warp is done with this buffer
    if (pc + 2 < steps) stage((pc + 2) % kcs, pc % 2);
    cp_async_commit();
    if (kc < kcs - 1) continue;

    // epilogue of pass p: every CTA of the cluster gets these h2 channels,
    // swizzled as the 1x1's A.  Two channels a bf16x2 operation: a
    // product of two bf16 values is exact in fp32 and a sum rounds to the
    // same bf16 once or through fp32, so each step rounds as the Pallas
    // kernel's does (and the code stays small: a first pass through an
    // unrolled scalar epilogue stalls on instruction fetch).  The _rn forms
    // keep the compiler from contracting a multiply and an add into one
    // fma, which would round once where the Pallas kernel rounds twice.
    const uint32_t h2_at = smem_u32(h2);
#pragma unroll
    for (int q = 0; q < NW / 8; ++q) {
      const int ch = h0 + p * kNP + nw0 + 8 * q + 2 * (t % 4);
      if (ch >= h0 + n3) continue;  // a last pass past this CTA's channels
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 64 + wi * 16 + lane / 4 + 8 * h;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[0][4 * q + 2 * h + e];
          if (kChains == 2) v[e] = __fadd_rn(v[e], acc[1][4 * q + 2 * h + e]);
        }
        const __nv_bfloat162 r = __hmax2(
            __hadd2_rn(__hmul2_rn(__floats2bfloat162_rn(v[0], v[1]), s2q[q]),
                       b2q[q]),
            __float2bfloat162_rn(0.0f));
        const uint32_t at = swz<kM>(m, ch);
        const uint32_t word = *reinterpret_cast<const uint32_t*>(&r);
        sts32(h2_at + at, word);
        for (int d = 1; d < cs; ++d)
          st_cluster_u32(map_cta(h2_at + at, (rank + d) % cs), word);
      }
    }
  }
  fence_proxy_async();
  cluster_sync();  // every CTA's h2 channels are in every CTA
  fence_proxy_async();
#ifdef TAIL_NO_1X1_STAGE
  return;
#endif

  // 1x1 conv -> BN3 -> + x -> ReLU into y, kNT channels a tile;
  // warpgroup wg: columns [nt0, nt0 + kNW1) of it
  const int nt0 = MT == 1 ? wg * kNW1 : 0;
  float acc1[kNW1 / 2];
  for (int tt = 0; tt < tiles; ++tt) {
#pragma unroll
    for (int e = 0; e < kNW1 / 2; ++e) acc1[e] = 0.0f;
    // this tile's BN3 scale and bias, loaded ahead of the epilogue
    __nv_bfloat162 s3q[kNW1 / 8], b3q[kNW1 / 8];
#pragma unroll
    for (int q = 0; q < kNW1 / 8; ++q) {
      const int c = min(y0 + tt * kNT + nt0 + 8 * q + 2 * (t % 4), a.co - 2);
      s3q[q] = __ldg(reinterpret_cast<const __nv_bfloat162*>(a.s3 + c));
      b3q[q] = __ldg(reinterpret_cast<const __nv_bfloat162*>(a.b3 + c));
    }
    // one chunk in flight; with two stages a chunk, warpgroup wg reads the
    // wg-th and releases both
    for (int kc = 0; kc < kcs; ++kc, i += kHalves) {
      const int s = (i + (kHalves == 2 ? wg : 0)) % stages;
      mbar_wait(&full[s], ((i + (kHalves == 2 ? wg : 0)) / stages) & 1);
      const uint32_t b =
          smem_u32(ring + s * kStage) + (kHalves == 2 ? 0 : nt0) * 128;
      const uint32_t hh = smem_u32(h2) + kc * kM * 128 + mt * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_ss<0>(acc1, desc_sw128(hh + kk * 32, 16, 1024),
                         desc_sw128(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc1);
      if (kc > 0 && t == 0)
        for (int hf = 0; hf < kHalves; ++hf)
          mbar_arrive(&empty[(i - kHalves + hf) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc1);
    if (t == 0)
      for (int hf = 0; hf < kHalves; ++hf)
        mbar_arrive(&empty[(i - kHalves + hf) % stages]);

    // x of this tile has landed; y replaces it in place
    mbar_wait(&xbar[tt % xbuf], (tt / xbuf) & 1);
    const uint32_t buf = smem_u32(xs + tt % xbuf * kXBytes);
    const int valid = boxes(tt) * 64;
    // every x word first, then y over it (columns past a last tile's
    // valid ones are read and written back unchanged, never stored)
    uint32_t xw[kNW1 / 8][2];
#pragma unroll
    for (int q = 0; q < kNW1 / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xw[q][h] = lds32(buf + swz<kM>(mt * 64 + wi * 16 + lane / 4 + 8 * h,
                                       nt0 + 8 * q + 2 * (t % 4)));
#pragma unroll
    for (int q = 0; q < kNW1 / 8; ++q) {
      const int cl = nt0 + 8 * q + 2 * (t % 4);
      if (cl >= valid) continue;  // a last tile past this CTA's channels
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // bf16x2 steps, as the 3x3 epilogue
        const int m = mt * 64 + wi * 16 + lane / 4 + 8 * h;
        const __nv_bfloat162 r = __floats2bfloat162_rn(
            acc1[4 * q + 2 * h], acc1[4 * q + 2 * h + 1]);
        const __nv_bfloat162 y = __hmax2(
            __hadd2_rn(__hadd2_rn(__hmul2_rn(r, s3q[q]), b3q[q]),
                       *reinterpret_cast<const __nv_bfloat162*>(&xw[q][h])),
            __float2bfloat162_rn(0.0f));
        sts32(buf + swz<kM>(m, cl), *reinterpret_cast<const uint32_t*>(&y));
      }
    }
    fence_proxy_async();  // y before the TMA store reads it
    mbar_arrive(&ydone[tt % xbuf]);
  }
}

template <int MT, int NW, int NT>
int launch_band(const Args<bf16>& a, const BandPlan& pl, int k,
                cudaStream_t stream) {
  constexpr int kNP = MT == 1 ? 2 * NW : NW, kNT = NT;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const int cm = a.cm, co = a.co, px = a.bs * a.bs;
  CUtensorMap mw2, mw3, mx, my;
  int err = encode_2d(&mw2, kBf16, a.w2, cm, 9 * cm, cm * 2, 64, kNP, kSw);
  if (!err) err = encode_2d(&mw3, kBf16, a.w3, cm, co, cm * 2, 64, 128, kSw);
  if (!err)
    err = encode_3d(&mx, kBf16, a.x, co, px, k, 64, pl.rows * a.bs, kSw, 2);
  if (!err)
    err = encode_3d(&my, kBf16, a.y, co, px, k, 64, pl.rows * a.bs, kSw, 2);
  if (err) return err;
  // raised once, to what any plan may take, never again (a CUDA graph
  // capture may be open)
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        tail_band<MT, NW, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBandSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * pl.bands * pl.cs);
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, tail_band<MT, NW, NT>, a, pl, mw2, mw3, mx, my);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int launch_rows(const Args<bf16>& a, int k, cudaStream_t stream) {
  const BandPlan pl = band_plan(k, a.bs, a.cm, a.co, sm_count());
  if (!pl.smem) return (int)cudaErrorInvalidValue;
  if (pl.mt == 2)  // 1x1 tiles of 128
    return pl.np == 128 ? launch_band<2, 128, 128>(a, pl, k, stream)
                        : launch_band<2, 64, 128>(a, pl, k, stream);
  if (pl.nt == 256) {
    if (pl.np == 256) return launch_band<1, 128, 256>(a, pl, k, stream);
    if (pl.np == 128) return launch_band<1, 64, 256>(a, pl, k, stream);
    return launch_band<1, 32, 256>(a, pl, k, stream);
  }
  if (pl.np == 256) return launch_band<1, 128, 128>(a, pl, k, stream);
  if (pl.np == 128) return launch_band<1, 64, 128>(a, pl, k, stream);
  return launch_band<1, 32, 128>(a, pl, k, stream);
}

template <typename T>
Args<T> make_args(void* const* p, int bs, int cm, int co, int n, int gh,
                  int gw) {
  Args<T> a;
  const T** in[] = {&a.h1, &a.x, &a.rows, &a.cols, &a.w2, &a.w3, &a.s2,
                    &a.b2, &a.s3, &a.b3};
  const int at[] = {0, 1, 2, 3, 5, 6, 7, 8, 9, 10};
  for (int i = 0; i < 10; ++i) *in[i] = static_cast<const T*>(p[at[i]]);
  a.idx = static_cast<const long long*>(p[4]);
  a.y = static_cast<T*>(p[11]);
  a.bs = bs;
  a.cm = cm;
  a.co = co;
  a.n = n;
  a.gh = gh;
  a.gw = gw;
  return a;
}

}  // namespace

// ptrs: h1, x, rows, cols, idx, w2, w3, s2, b2, s3, b3, y (12 device
// pointers: the halo site's strips at pad 1, rows (T+1, 2, bs, Cm) and cols
// (T+1, bs, 2, Cm) with T = n gh gw and a zero row T, and the K blocks'
// int64 flat indices, T marking a padding slot; weights as
// prepare_tail_weights lays them out).
// dtype: 0 = fp32, h2_scratch (K, bs*bs, Cm) fp32 required; 1 = bf16, the
// wgmma route where bf16_block takes the block and Co is a multiple of 256,
// else the row route (one launch, no scratch); 2 = bf16 on the row route
// whatever the block (to time it against the wgmma route).
extern "C" int bottleneck_tail(void* const* ptrs, void* h2_scratch, int k,
                               int bs, int cm, int co, int n, int gh, int gw,
                               int dtype, void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 || dtype == 2) {
    const Args<bf16> a = make_args<bf16>(ptrs, bs, cm, co, n, gh, gw);
    if (dtype == 1 && bf16_block(bs, cm) && co % (2 * kN1) == 0) {
      if (bs == 16) return launch_bf16<16, 128>(a, k, s);
      if (cm == 256) return launch_bf16<8, 256>(a, k, s);
      return launch_bf16<8, 128>(a, k, s);
    }
    if (cm % 64 || co % 64) return (int)cudaErrorInvalidValue;
    return launch_rows(a, k, s);
  }
  if (cm % kF32BN || co % kF32BN) return (int)cudaErrorInvalidValue;
  return launch_f32(make_args<float>(ptrs, bs, cm, co, n, gh, gw),
                    static_cast<float*>(h2_scratch), k, s);
}

// The row route's launch plan for K blocks of (bs, Cm) -> Co on `sms` SMs
// (band_plan), as 9 ints: m64 tiles a band, image rows a band, bands a
// block, CTAs a cluster, channels of a 3x3 pass and of a 1x1 tile, ring
// stages, x / y buffers, dynamic shared memory (0: no plan).
extern "C" void bottleneck_rows_plan(int k, int bs, int cm, int co, int sms,
                                     int* out) {
  const BandPlan p = band_plan(k, bs, cm, co, sms);
  const int v[9] = {p.mt, p.rows, p.bands, p.cs, p.np, p.nt, p.stages,
                    p.xbuf, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}
