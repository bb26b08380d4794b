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
// number in (center plus halo pieces); there is no arithmetic.
//
// Design (the assembled entries, halo_gather_canvas / halo_gather_strips):
// the unit of work is a padded row, not an element.  Row py of out[k] is
// contiguous ((bs+2p)*C elements) and is three contiguous source segments,
// [p C | bs C | p C]: an interior row is the left neighbour's right columns,
// center[k] row py-p, the right neighbour's left columns; a top or bottom
// row is a corner, the upper or lower neighbour's edge row, a corner.  The
// launch's K*(bs+2p) rows are cut into pieces of at most a few KB (finer
// where a launch has fewer rows than the card has SMs), and the pieces into
// equal contiguous shares, one a CTA, a few CTAs an SM: the CTA count
// follows the SM count, not K.  The plan (pieces a row, piece bytes, pieces
// a share, CTAs, ring depth, blocks a share touches) is made on the host by
// ops/kernels/halo.py halo_plan and checked here.  A CTA first turns the
// block indices of the blocks its share touches into their 8 neighbours, in
// shared memory; then each of `depth` threads owns a slot of a ring of
// piece buffers and moves its pieces with Hopper's bulk asynchronous
// copies: the three segments' parts global -> shared (cp.async.bulk,
// completing on the slot's mbarrier with complete_tx), then the assembled
// piece shared -> global in one bulk store (bulk_group).  A slot asks for
// its first piece's center part, which needs no neighbour, before the
// block indices arrive, so most of the bytes are on their way one index
// round trip earlier.  A piece's three
// source addresses are worked out once, not per 16 bytes, and the copy
// engine, not the threads, moves the bytes, so `depth` pieces a CTA are in
// flight at once.  Where C*itemsize is not a multiple of 16 (the bulk
// copies' granule) the same shares are copied by a plain loop of 4- or
// 2-byte units.  The kernel copies bytes, so it is dtype-agnostic and its
// output is bitwise equal to the plain version.  The neighbour and strip
// maths live in halo.cuh, shared with bottleneck.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"
#include "hopper.cuh"

namespace {

using halo::neighbour;

constexpr int kGatherThreads = 64;  // the ring's slots at most
constexpr int kSmemMax = 232448;    // a CTA's shared memory on sm_90

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

// One launch of the assembled gather.  src0 is the canvas (total+1, bs,
// bs, C) or the strips' rows (total+1, 2p, bs, C); src1 the strips' cols
// (total+1, bs, 2p, C).  cb = C * itemsize; pieces = K (bs+2p) cuts.
struct Gather {
  char* out;
  const char* src0;
  const char* src1;
  const char* center;
  const long long* idx;
  int k, bs, p, cb, n, gh, gw;
  int piece, share, depth, pieces;
  FastDiv cuts, w;  // pieces a row, rows a block
};

// Whether padded row py lies between the halo rows: its middle segment is
// a row of center[k], no neighbour's.
__device__ __forceinline__ bool interior(const Gather& g, int py) {
  return py >= g.p && py < g.p + g.bs;
}

// Row y of center[kk], as bytes.
__device__ __forceinline__ const char* center_row(const Gather& g, int kk,
                                                  int y) {
  return g.center + ((size_t)kk * g.bs + y) * g.bs * g.cb;
}

// The three source segments (bytes) of padded row py of block kk, whose 8
// neighbour indices are nb (TL, T, TR, L, R, BL, B, BR).
template <bool STRIPS>
__device__ __forceinline__ void row_sources(const Gather& g,
                                            const long long* nb, int kk,
                                            int py, const char* (&seg)[3]) {
  const int bs = g.bs, p = g.p;
  const size_t pc = (size_t)p * g.cb, line = (size_t)bs * g.cb;
  if (interior(g, py)) {
    const int y = py - p;
    seg[1] = center_row(g, kk, y);
    if (STRIPS) {  // cols: [left p; right p] columns of each row
      seg[0] = g.src1 + ((size_t)nb[3] * bs + y) * 2 * pc + pc;
      seg[2] = g.src1 + ((size_t)nb[4] * bs + y) * 2 * pc;
    } else {
      seg[0] = g.src0 + ((size_t)nb[3] * bs + y) * line + line - pc;
      seg[2] = g.src0 + ((size_t)nb[4] * bs + y) * line;
    }
    return;
  }
  // above: the upper neighbours' bottom rows (rows p + py of the strips'
  // [top p; bottom p], bs - p + py of the canvas); below: the lower
  // neighbours' top rows
  const bool top = py < p;
  const long long* q = nb + (top ? 0 : 5);
  const int y = top ? (STRIPS ? p : bs - p) + py : py - p - bs;
  const size_t block = (size_t)(STRIPS ? 2 * p : bs) * line;
  const size_t row = (size_t)y * line;
  seg[0] = g.src0 + (size_t)q[0] * block + row + line - pc;
  seg[1] = g.src0 + (size_t)q[1] * block + row;
  seg[2] = g.src0 + (size_t)q[2] * block + row;
}

// bytes [lo, hi) of output row `row` (block kk, padded row py) are piece j
struct Where {
  int row, kk, py, lo, hi;
};

__device__ __forceinline__ Where locate(const Gather& g, int j,
                                        int row_bytes) {
  Where at;
  at.row = j / g.cuts;
  at.kk = at.row / g.w;
  at.py = at.row - at.kk * g.w.d;
  at.lo = (j - at.row * g.cuts.d) * g.piece;
  at.hi = min(at.lo + g.piece, row_bytes);
  return at;
}

// bulk copies of 16-byte multiples: global -> this CTA's shared memory,
// counted on `bar`; shared -> global in this thread's bulk group
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(hopper::smem_u32(src)), "r"(bytes)
               : "memory");
}

// U = uint4: the bulk-copy ring; U = uint32_t / uint16_t: the unit loop.
// Shared memory: [depth slots of `piece` bytes][depth mbarriers][the
// share's blocks x 8 neighbour indices].
template <typename U, bool STRIPS>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const __grid_constant__ Gather g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = g.w.d * g.cb;
  const int pc = g.p * g.cb, line = g.bs * g.cb;
  const int j0 = blockIdx.x * g.share;
  const int j1 = min(j0 + g.share, g.pieces);
  const int k0 = j0 / g.cuts / g.w;
  const int span = (j1 - 1) / g.cuts / g.w - k0 + 1;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (size_t)g.depth * g.piece);
  long long* nbs = reinterpret_cast<long long*>(bar + g.depth);
  // slot s of the ring takes pieces j0 + s, j0 + s + depth, ...  Its first
  // piece's bytes are expected on its barrier at once, and the part of
  // them in center[k] (which needs no neighbour) is asked for while the
  // block indices load
  const int s = threadIdx.x;
  const bool ring = sizeof(U) == 16 && s < g.depth && j0 + s < j1;
  unsigned char* buf = smem + (size_t)s * g.piece;
  Where first = {};
  if (ring) {
    hopper::mbar_init(bar + s, 1);
    hopper::fence_barrier_init();
    first = locate(g, j0 + s, row_bytes);
    hopper::mbar_expect_tx(bar + s, first.hi - first.lo);
    const int lo = max(first.lo, pc), hi = min(first.hi, pc + line);
    if (interior(g, first.py) && lo < hi)
      bulk_load(buf + (lo - first.lo),
                center_row(g, first.kk, first.py - g.p) + (lo - pc), hi - lo,
                bar + s);
  }
  for (int t = threadIdx.x; t < span * 8; t += kGatherThreads)
    nbs[t] = neighbour(g.idx[k0 + t / 8], t % 8, g.n, g.gh, g.gw);
  __syncthreads();  // the neighbours are in

  if constexpr (sizeof(U) == 16) {
    // each piece: its loads, the wait on the slot's barrier, its store; the
    // slot is refilled once its last store has read it
    if (!ring) return;
    uint64_t* b = bar + s;
    int turn = 0;
    for (int j = j0 + s; j < j1; j += g.depth, ++turn) {
      const Where at = turn ? locate(g, j, row_bytes) : first;
      const char* seg[3];
      row_sources<STRIPS>(g, nbs + (at.kk - k0) * 8, at.kk, at.py, seg);
      const int edge[4] = {0, pc, pc + line, row_bytes};
      if (turn) {
        hopper::bulk_wait_read();
        hopper::mbar_expect_tx(b, at.hi - at.lo);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int lo = max(at.lo, edge[i]), hi = min(at.hi, edge[i + 1]);
        if (lo < hi && !(turn == 0 && i == 1 && interior(g, at.py)))
          bulk_load(buf + (lo - at.lo), seg[i] + (lo - edge[i]), hi - lo, b);
      }
      hopper::mbar_wait(b, turn & 1);
      bulk_store(g.out + (size_t)at.row * row_bytes + at.lo, buf,
                 at.hi - at.lo);
      hopper::bulk_commit();
    }
    hopper::bulk_wait_read();  // the buffers outlive their last store
  } else {
    for (int j = j0; j < j1; ++j) {
      const Where at = locate(g, j, row_bytes);
      const char* seg[3];
      row_sources<STRIPS>(g, nbs + (at.kk - k0) * 8, at.kk, at.py, seg);
      char* dst = g.out + (size_t)at.row * row_bytes;
      for (int x = at.lo + threadIdx.x * (int)sizeof(U); x < at.hi;
           x += kGatherThreads * (int)sizeof(U)) {
        const int i = x < pc ? 0 : (x < pc + line ? 1 : 2);
        const int from = i == 0 ? 0 : (i == 1 ? pc : pc + line);
        *reinterpret_cast<U*>(dst + x) =
            *reinterpret_cast<const U*>(seg[i] + (x - from));
      }
    }
  }
}

template <typename U, bool STRIPS>
int run(const Gather& g, int ctas, int smem, cudaStream_t s) {
  // past the default 48 KB (no shipped plan on sm_90 needs it), raised once
  // to what any plan may take, never again (a CUDA graph capture may be
  // open)
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_kernel<U, STRIPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  gather_kernel<U, STRIPS><<<ctas, kGatherThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// Checks the plan (cuts, piece, share, ctas, depth, span) made by
// halo_plan: every row cut into non-empty pieces of whole units, every
// piece in exactly one CTA's share and no CTA without one, a ring slot for
// each ring thread (none on the unit loop), room for the neighbours of
// every block a share can touch, and shared memory that fits; else
// cudaErrorInvalidValue and no launch.
template <bool STRIPS>
int launch(void* out, const void* src0, const void* src1, const void* center,
           const void* idx, int k, int bs, int c_bytes, int p, int n, int gh,
           int gw, int cuts, int piece, int share, int ctas, int depth,
           int span, void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  const int unit = c_bytes % 16 == 0 ? 16 : (c_bytes % 4 == 0 ? 4 : 2);
  const long long w = bs + 2LL * p, row_bytes = w * c_bytes;
  const long long pieces = k * w * cuts;
  const long long smem = (long long)depth * piece + 8LL * depth + 64LL * span;
  const long long touched = share >= 1 && cuts >= 1
                                ? ((share - 1) / cuts + 1) / w + 2 : 0;
  const bool ok =
      bs > 0 && p > 0 && c_bytes > 0 && c_bytes % 2 == 0 && cuts >= 1 &&
      piece > 0 && piece % unit == 0 && (long long)cuts * piece >= row_bytes &&
      (long long)(cuts - 1) * piece < row_bytes && share >= 1 && ctas >= 1 &&
      pieces + share < INT32_MAX && (long long)ctas * share >= pieces &&
      (long long)(ctas - 1) * share < pieces &&
      (unit == 16 ? depth >= 1 && depth <= kGatherThreads && depth <= share
                  : depth == 0) &&
      span >= (touched < k ? touched : k) && smem <= kSmemMax;
  if (!ok) return (int)cudaErrorInvalidValue;
  Gather g = {static_cast<char*>(out), static_cast<const char*>(src0),
              static_cast<const char*>(src1),
              static_cast<const char*>(center),
              static_cast<const long long*>(idx), k, bs, p, c_bytes, n, gh,
              gw, piece, share, depth, (int)pieces, fast_div(cuts),
              fast_div((int)w)};
  auto s = static_cast<cudaStream_t>(stream);
  if (unit == 16) return run<uint4, STRIPS>(g, ctas, (int)smem, s);
  if (unit == 4) return run<uint32_t, STRIPS>(g, ctas, (int)smem, s);
  return run<uint16_t, STRIPS>(g, ctas, (int)smem, s);
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

// The assembled entries take halo_plan's plan as (cuts, piece, share,
// ctas, depth, span).
extern "C" int halo_gather_canvas(void* out, const void* canvas,
                                  const void* center, const void* idx, int k,
                                  int bs, int c_bytes, int p, int n, int gh,
                                  int gw, int cuts, int piece, int share,
                                  int ctas, int depth, int span,
                                  void* stream) {
  return launch<false>(out, canvas, nullptr, center, idx, k, bs, c_bytes, p,
                       n, gh, gw, cuts, piece, share, ctas, depth, span,
                       stream);
}

extern "C" int halo_gather_strips(void* out, const void* rows,
                                  const void* cols, const void* center,
                                  const void* idx, int k, int bs, int c_bytes,
                                  int p, int n, int gh, int gw, int cuts,
                                  int piece, int share, int ctas, int depth,
                                  int span, void* stream) {
  return launch<true>(out, rows, cols, center, idx, k, bs, c_bytes, p, n, gh,
                      gw, cuts, piece, share, ctas, depth, span, stream);
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
