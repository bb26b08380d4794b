// Halo gather: assemble each executed block's halo-padded tile.
//
// Replaces the Pallas kernel blockcopy_tpu/ops/pallas/halo.py
// (halo_gather_pallas :68, _kernel :34), and adds two entry points over the
// edge-strip storage that the default halo mode keeps
// (blockcopy_tpu/core/blocked.py:213-274): halo_gather_strips assembles the
// padded tiles, halo_pieces writes the 8 pieces unassembled
// (gather_halo_strips, blocked.py:234), the form the stem's plane pool and
// the BORDER_CONV lowerings read.  (The fused bottleneck tail reads its halo
// straight from the strips: bottleneck.cu.)
//
// out[k] (bs+2p, bs+2p, C) = interior <- center[k]; the 8 halo pieces
// (top/bottom p rows, left/right p cols, 4 corners) <- the neighbour blocks
// of idx[k] in TL,T,TR,L,R,BL,B,BR order.  Out-of-image neighbours and
// padding slots (idx == total) read the zero sentinel row `total`.
//
// Bound: bytes.  It moves K*(bs+2p)^2*C elements out and reads the same
// number in (center plus halo pieces); there is no arithmetic.  Design: one
// CTA per executed block times a tile of channel units times a slice of the
// tile's pixels (so a large block still spreads over many SMs), the CTA
// computes its own 8 neighbour indices into shared memory, and every thread
// copies 16-byte units along C (contiguous in NHWC) when C*itemsize % 16 ==
// 0, else 4- or 2-byte units.  The kernel copies bytes, so it is
// dtype-agnostic and its output is bitwise equal to the plain version.
// The neighbour and strip maths live in halo.cuh, shared with bottleneck.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"

namespace {

using halo::neighbour;

constexpr int kThreads = 256;
constexpr int kUnitsPerTile = 32;
constexpr int kCopiesPerThread = 8;  // sizes the pixel slices

// STRIPS=false: src0 is the full canvas (total+1, bs, bs, U).
// STRIPS=true:  src0 is rows (total+1, 2p, bs, U), src1 cols (total+1, bs, 2p, U).
template <typename U, bool STRIPS>
__global__ void __launch_bounds__(kThreads)
halo_kernel(U* __restrict__ out, const U* __restrict__ src0,
            const U* __restrict__ src1, const U* __restrict__ center,
            const long long* __restrict__ idx, int bs, int p, int units,
            int n, int gh, int gw) {
  __shared__ long long nb[8];
  const int k = blockIdx.x;
  if (threadIdx.x < 8) nb[threadIdx.x] = neighbour(idx[k], threadIdx.x, n, gh, gw);
  __syncthreads();

  const int u0 = blockIdx.y * kUnitsPerTile;
  const int ut = min(kUnitsPerTile, units - u0);
  const int w = bs + 2 * p;
  const int count = w * w * ut;
  const int slice = (count + gridDim.z - 1) / gridDim.z;
  const int end = min(count, (int)(blockIdx.z + 1) * slice);
  for (int e = blockIdx.z * slice + threadIdx.x; e < end; e += kThreads) {
    const int pix = e / ut;
    const int u = u0 + e % ut;
    const int py = pix / w, px = pix % w;
    const int ry = py < p ? 0 : (py < p + bs ? 1 : 2);
    const int rx = px < p ? 0 : (px < p + bs ? 1 : 2);
    const U* src;
    if (ry == 1 && rx == 1) {
      src = center + (((size_t)k * bs + (py - p)) * bs + (px - p)) * units;
    } else {
      if (!STRIPS) {
        const int slot = ry * 3 + rx;
        const long long b = nb[slot - (slot > 4)];
        // row / col read inside the neighbour block
        const int sy = ry == 0 ? bs - p + py : (ry == 1 ? py - p : py - p - bs);
        const int sx = rx == 0 ? bs - p + px : (rx == 1 ? px - p : px - p - bs);
        src = src0 + (((size_t)b * bs + sy) * bs + sx) * units;
      } else {
        src = halo::strip_pixel(src0, src1, nb, bs, p, py, px, units);
      }
    }
    out[((size_t)k * w * w + pix) * units + u] = src[u];
  }
}

template <bool STRIPS>
int launch(void* out, const void* src0, const void* src1, const void* center,
           const void* idx, int k, int bs, int c_bytes, int p, int n, int gh,
           int gw, void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto unit) {
    using U = decltype(unit);
    const int units = c_bytes / (int)sizeof(U);
    const int w = bs + 2 * p, ut = units < kUnitsPerTile ? units
                                                         : kUnitsPerTile;
    const int per_cta = kThreads * kCopiesPerThread;
    dim3 grid(k, (units + kUnitsPerTile - 1) / kUnitsPerTile,
              (w * w * ut + per_cta - 1) / per_cta);
    halo_kernel<U, STRIPS><<<grid, kThreads, 0, s>>>(
        static_cast<U*>(out), static_cast<const U*>(src0),
        static_cast<const U*>(src1), static_cast<const U*>(center),
        static_cast<const long long*>(idx), bs, p, units, n, gh, gw);
  };
  if (c_bytes % 16 == 0) go(uint4{});
  else if (c_bytes % 4 == 0) go(uint32_t{});
  else go(uint16_t{});
  return (int)cudaGetLastError();
}

// halo_pieces: the 8 pieces of every executed block from its neighbours'
// strips, for the stem's plane pool and the BORDER_CONV lowerings.
// Bound: bytes, each piece read once and written once (a block-128 frame's
// plane pool, (bs 32, C 256) bf16 at K = 64: 8.6 MB, 2.6 us at 3.35 TB/s).
// Design: the launch's whole work, every 16-byte unit of all 8 pieces of
// all K blocks (block-major, then piece, pixel and unit, so a thread's
// neighbours in the warp copy neighbouring bytes), is cut into equal shares
// of kPieceThreads x kPieceUnits units, one a CTA: no CTA copies a 1-pixel
// corner alone.  A CTA first computes the 8 neighbour indices of each block
// its share touches into shared memory, then each thread issues its
// kPieceUnits independent loads before any of its stores, so their DRAM
// latencies overlap.  A unit's place (block, piece, pixel, unit) takes five
// divisions by launch constants, each a multiply-high and a shift
// (FastDiv) in place of an integer division's ~20 instructions, and is
// worked out while the CTA's block indices load.
constexpr int kPieceThreads = 256;
constexpr int kPieceUnits = 4;  // loads in flight a thread
constexpr int kPieceShare = kPieceThreads * kPieceUnits;

// n / d for 0 <= n < 2^31 as a multiply-high and a shift: m = ceil(2^(31+s)
// / d), s = ceil(log2 d), so n m / 2^(31+s) exceeds n / d by less than
// n / 2^(31+s) < 1 / d and never reaches the next integer
struct FastDiv {
  int d;
  unsigned m;
  int shift;
};

FastDiv fast_div(int d) {
  FastDiv f = {d, 0u, 0};
  if (d == 1) return f;
  int s = 0;
  while ((1LL << s) < d) ++s;
  f.m = (unsigned)(((1ULL << (31 + s)) + d - 1) / d);
  f.shift = s - 1;
  return f;
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.m) >> f.shift);
}

// read in place from the parameter space (__grid_constant__): a piece
// index known only at run time would otherwise copy the 8 pointers to local
// memory
struct Pieces {
  void* out[8];
};

// The divisors of a unit's place: units a block (all 8 pieces), an edge
// piece, a corner piece, a pixel, and the two piece widths
struct PieceDivs {
  FastDiv block, edge, corner, units, bs, p;
};

template <typename U>
__global__ void __launch_bounds__(kPieceThreads)
pieces_kernel(const __grid_constant__ Pieces o,
              const __grid_constant__ PieceDivs dv,
              const U* __restrict__ rows, const U* __restrict__ cols,
              const long long* __restrict__ idx, int k, int n, int gh,
              int gw) {
  extern __shared__ long long nbs[];  // [blocks of this share][8]
  const int bs = dv.bs.d, p = dv.p.d, units = dv.units.d;
  const int edge = dv.edge.d, corner = dv.corner.d, per_block = dv.block.d;
  const int e0 = blockIdx.x * kPieceShare;
  const int e1 = min(e0 + kPieceShare, k * per_block);
  const int k0 = e0 / dv.block;
  const int span = (e1 - 1) / dv.block - k0 + 1;
  // the first block index this thread turns into a neighbour, asked for
  // first: it arrives while the units' places are worked out
  const int t0 = threadIdx.x;
  const long long first = t0 < span * 8 ? idx[k0 + t0 / 8] : 0;

  // each unit's place: its block (of the share), its pixel in the padded
  // tile, its unit, its destination
  int blk[kPieceUnits], py[kPieceUnits], px[kPieceUnits], u[kPieceUnits];
  U* dst[kPieceUnits];
#pragma unroll
  for (int i = 0; i < kPieceUnits; ++i) {
    const int e = e0 + i * kPieceThreads + threadIdx.x;
    dst[i] = nullptr;
    if (e >= e1) continue;
    const int kk = e / dv.block, l = e - kk * per_block;
    // the piece, then the unit's place in it
    int j, r;
    if (l < 4 * edge) {
      j = l / dv.edge;
      r = l - j * edge;
    } else {
      const int c = (l - 4 * edge) / dv.corner;
      j = 4 + c;
      r = l - 4 * edge - c * corner;
    }
    const halo::Piece q = halo::piece(j, bs, p);
    const int pix = r / dv.units, y = pix / (j < 2 ? dv.bs : dv.p);
    blk[i] = kk - k0;
    py[i] = q.y0 + y;
    px[i] = q.x0 + pix - y * q.w;
    u[i] = r - pix * units;
    dst[i] = static_cast<U*>(o.out[j]) + (size_t)kk * q.h * q.w * units + r;
  }
  if (t0 < span * 8) nbs[t0] = neighbour(first, t0 % 8, n, gh, gw);
  for (int t = t0 + kPieceThreads; t < span * 8; t += kPieceThreads)
    nbs[t] = neighbour(idx[k0 + t / 8], t % 8, n, gh, gw);
  __syncthreads();  // the neighbours are in
  U v[kPieceUnits];
#pragma unroll
  for (int i = 0; i < kPieceUnits; ++i)
    if (dst[i])
      v[i] = halo::strip_pixel(rows, cols, nbs + blk[i] * 8, bs, p, py[i],
                               px[i], units)[u[i]];
#pragma unroll
  for (int i = 0; i < kPieceUnits; ++i)
    if (dst[i]) *dst[i] = v[i];
}

}  // namespace

extern "C" int halo_gather_canvas(void* out, const void* canvas,
                                  const void* center, const void* idx, int k,
                                  int bs, int c_bytes, int p, int n, int gh,
                                  int gw, void* stream) {
  return launch<false>(out, canvas, nullptr, center, idx, k, bs, c_bytes, p,
                       n, gh, gw, stream);
}

extern "C" int halo_gather_strips(void* out, const void* rows,
                                  const void* cols, const void* center,
                                  const void* idx, int k, int bs, int c_bytes,
                                  int p, int n, int gh, int gw, void* stream) {
  return launch<true>(out, rows, cols, center, idx, k, bs, c_bytes, p, n, gh,
                      gw, stream);
}

// out: the 8 pieces' device pointers in PIECES order (top, bottom, left,
// right, top_left, top_right, bottom_left, bottom_right), each 16-byte
// aligned: top/bottom (K, p, bs, C), left/right (K, bs, p, C), corners
// (K, p, p, C).  One launch of equal shares over all of them.
extern "C" int halo_pieces(void* const* out, const void* rows,
                           const void* cols, const void* idx, int k, int bs,
                           int c_bytes, int p, int n, int gh, int gw,
                           void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  Pieces o;
  for (int j = 0; j < 8; ++j) o.out[j] = out[j];
  auto s = static_cast<cudaStream_t>(stream);
  // the kernel counts units in int: every unit of the launch (at most
  // c_bytes / 2 a pixel) and a share past them must fit
  if (4LL * p * (bs + p) * (c_bytes / 2) * k >= INT32_MAX - kPieceShare)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto unit) {
    using U = decltype(unit);
    const int units = c_bytes / (int)sizeof(U);
    const int edge = p * bs * units, corner = p * p * units;
    const int per_block = 4 * (edge + corner);
    const PieceDivs dv = {fast_div(per_block), fast_div(edge),
                          fast_div(corner), fast_div(units), fast_div(bs),
                          fast_div(p)};
    const int ctas = (per_block * k + kPieceShare - 1) / kPieceShare;
    // the blocks a share can touch: its units over a block's, and the two
    // it may start and end inside
    const int most = kPieceShare / per_block + 2;
    const int span = most < k ? most : k;
    pieces_kernel<U><<<ctas, kPieceThreads, 8 * sizeof(long long) * span,
                       s>>>(
        o, dv, static_cast<const U*>(rows), static_cast<const U*>(cols),
        static_cast<const long long*>(idx), k, n, gh, gw);
  };
  if (c_bytes % 16 == 0) go(uint4{});
  else if (c_bytes % 4 == 0) go(uint32_t{});
  else go(uint16_t{});
  return (int)cudaGetLastError();
}
