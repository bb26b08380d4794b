// Halo gather: assemble each executed block's halo-padded tile.
//
// Replaces the Pallas kernel blockcopy_tpu/ops/pallas/halo.py
// (halo_gather_pallas :68, _kernel :34), and adds an entry point over the
// edge-strip storage that the default halo mode keeps
// (blockcopy_tpu/core/blocked.py:213-274).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerTile = 32;
constexpr int kCopiesPerThread = 8;  // sizes the pixel slices

__device__ __forceinline__ long long neighbour(long long i, int j, int n,
                                               int gh, int gw) {
  const long long total = (long long)n * gh * gw;
  if (i < 0 || i >= total) return total;
  const long long per = (long long)gh * gw;
  const long long b = i / per;
  const int g = (int)(i % per);
  const int jj = j + (j >= 4);  // 3x3 window position without the centre
  const int ny = g / gw + jj / 3 - 1;
  const int nx = g % gw + jj % 3 - 1;
  if (ny < 0 || ny >= gh || nx < 0 || nx >= gw) return total;
  return b * per + (long long)ny * gw + nx;
}

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
      const int slot = ry * 3 + rx;
      const long long b = nb[slot - (slot > 4)];
      // row / col read inside the neighbour block
      const int sy = ry == 0 ? bs - p + py : (ry == 1 ? py - p : py - p - bs);
      const int sx = rx == 0 ? bs - p + px : (rx == 1 ? px - p : px - p - bs);
      if (!STRIPS) {
        src = src0 + (((size_t)b * bs + sy) * bs + sx) * units;
      } else if (ry != 1) {
        // rows strip holds [top p; bottom p]: the top halo reads the upper
        // neighbour's bottom rows (p + py), the bottom halo the lower
        // neighbour's top rows (py - p - bs)
        const int r = ry == 0 ? p + py : py - p - bs;
        src = src0 + (((size_t)b * 2 * p + r) * bs + sx) * units;
      } else {
        const int c = rx == 0 ? p + px : px - p - bs;
        src = src1 + (((size_t)b * bs + sy) * 2 * p + c) * units;
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
