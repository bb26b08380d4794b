// The edge-strip halo's neighbour maths, shared by the halo kernel
// (halo.cu) and the fused bottleneck tail (bottleneck.cu), which reads its
// halo straight from the strips.
//
// Strip storage of a halo site at pad p (blockcopy_tpu/core/blocked.py:213):
// rows (T+1, 2p, bs, C) holds [top p; bottom p] rows of every block, cols
// (T+1, bs, 2p, C) its [left p; right p] columns; row T is a zero sentinel.
// A block's (bs+2p)^2 padded tile takes its halo from the 8 neighbours in
// TL, T, TR, L, R, BL, B, BR order: the top halo is the upper neighbour's
// bottom rows, the left halo the left neighbour's right columns, and so on.

#pragma once

#include <stdint.h>

namespace halo {

// Flat index of neighbour j (TL, T, TR, L, R, BL, B, BR) of block i on an
// (n, gh, gw) grid; a neighbour past the image, and every neighbour of a
// padding slot (i == n gh gw), is the zero sentinel row n gh gw.  The grid
// holds fewer than 2^31 blocks, so 32-bit arithmetic does (a 64-bit
// division is a long software routine on the card).
__device__ __forceinline__ long long neighbour(long long i, int j, int n,
                                               int gh, int gw) {
  const int per = gh * gw, total = n * per;
  if (i < 0 || i >= total) return total;
  const int b = (int)i / per, g = (int)i - b * per;
  const int jj = j + (j >= 4);  // 3x3 window position without the centre
  const int gy = g / gw;
  const int ny = gy + jj / 3 - 1, nx = g - gy * gw + jj % 3 - 1;
  if (ny < 0 || ny >= gh || nx < 0 || nx >= gw) return total;
  return (long long)b * per + ny * gw + nx;
}

// The channel row (c elements of T) of halo pixel (py, px) of a block's
// padded tile, in its neighbour's strip; nb holds the block's 8 neighbour
// indices.  (py, px) must lie outside the interior [p, p + bs)^2.
template <typename T>
__device__ __forceinline__ const T* strip_pixel(const T* rows, const T* cols,
                                                const long long* nb, int bs,
                                                int p, int py, int px,
                                                int c) {
  const int ry = py < p ? 0 : (py < p + bs ? 1 : 2);
  const int rx = px < p ? 0 : (px < p + bs ? 1 : 2);
  const int slot = ry * 3 + rx;
  const long long b = nb[slot - (slot > 4)];
  if (ry != 1) {
    // above: the neighbour's bottom rows (p + py); below: its top rows
    const int r = ry == 0 ? p + py : py - p - bs;
    const int sx = rx == 0 ? bs - p + px : (rx == 1 ? px - p : px - p - bs);
    return rows + (((size_t)b * 2 * p + r) * bs + sx) * c;
  }
  // left: the neighbour's right columns (p + px); right: its left ones
  const int col = rx == 0 ? p + px : px - p - bs;
  return cols + (((size_t)b * bs + (py - p)) * 2 * p + col) * c;
}

// Piece j of the 8 pieces (top, bottom, left, right, top_left, top_right,
// bottom_left, bottom_right; gather_halo_strips, blocked.py:234): its
// height and width, and its origin in the padded tile.
struct Piece {
  int h, w, y0, x0;
};

__host__ __device__ __forceinline__ Piece piece(int j, int bs, int p) {
  const bool side = j == 2 || j == 3, corner = j >= 4;
  Piece q;
  q.h = side ? bs : p;
  q.w = corner || side ? p : bs;
  q.y0 = (j == 0 || j == 4 || j == 5) ? 0 : side ? p : p + bs;
  q.x0 = (j == 0 || j == 1) ? p : (j == 2 || j == 4 || j == 6) ? 0 : p + bs;
  return q;
}

}  // namespace halo
