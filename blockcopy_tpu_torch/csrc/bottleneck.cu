// Fused bottleneck tail for stride-1 identity ResNet bottlenecks:
//   y = relu(bn3(conv1x1(relu(bn2(conv3x3(pad(h1)))))) + x)
//
// Replaces the Pallas kernel blockcopy_tpu/ops/pallas/bottleneck.py
// (bottleneck_tail :92, _kernel :50).  The padded tile is built from h1 and
// the 8 halo pieces of the strip exchange; numerics follow :82-89: the 3x3
// conv accumulates in fp32, is cast to the activation dtype, then the BN2
// multiply and add each round to that dtype, ReLU; the 1x1 accumulates in
// fp32, is cast, BN3 multiply, add, + x, ReLU, each rounding likewise.
//
// Bound (bf16, K = 64 blocks, RN50 at 1024x2048): layer2 (bs 16, Cm 128,
// Co 512) moves ~39 MB for ~7 GFLOP, so bytes bound it; layer3 (bs 8,
// Cm 256, Co 1024) ~22 MB for ~7 GFLOP, so tensor-core operations do.
// Design (bf16): one CTA per executed block keeps everything between h1 and
// y on chip: the padded tile and h2 stay in shared memory and neither the
// padded input nor h2 is written to device memory.  The 3x3 conv runs as 9
// shifted-window products over the padded tile flattened to rows of width
// bs+2 (each tap is then a constant row offset, so every A operand is a
// plain strided tile; the 2 wrap-around columns per row are computed and
// dropped), on mma.sync m16n8k16 bf16 with fp32 accumulators, operands
// brought from shared memory by ldmatrix.  Weights stream through shared
// memory in chunks (w2: KC input channels of one tap; w3: 64 output
// channels), double-buffered with cp.async so the next chunk loads while the
// current one is multiplied; every chunk is read once per CTA and shared by
// its 8 warps.  Each warp holds up to 3 16x64 output strips of the 3x3 conv
// (one column strip, so its B fragments serve all three) in registers across
// all chunks (more strips take another pass over w2); the 1x1 conv
// completes a 16x32 strip per chunk, its epilogue operands loaded before the
// products.  Shared-memory rows are padded by 8 elements, so the 8 rows of
// an ldmatrix phase fall on distinct banks.  Epilogues go through a per-warp
// fp32 tile and move 16 bytes a lane.
// Two ablation switches, never set by the library build, let
// blockcopy_tpu_torch/tools/tail_breakdown.py time the parts:
// TAIL_NO_3X3_PRODUCTS drops the 3x3 conv's products (loads, barriers and
// epilogue stay), TAIL_NO_1X1_STAGE ends the kernel once h2 is built.
// fp32 runs a scalar FMA kernel (no tensor core gives fp32 exactly); its h2
// goes through a device-memory scratch buffer.  wgmma/TMA pipelining and
// splitting a block over several CTAs are later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Args {
  const T *h1, *x, *top, *bottom, *left, *right, *tl, *tr, *bl, *br;
  const T *w2;  // (3, 3, Cm, Cm): [dy][dx][ci][co]
  const T *w3;  // (Cm, Co)
  const T *s2, *b2, *s3, *b3;
  T* y;
  int bs, cm, co;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

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

__device__ __forceinline__ bf16 round_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// 8 consecutive bf16 (16 bytes, read-only path) widened to fp32
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = f32(h[i]);
}

// 8 fp32 values that are already bf16-exact, stored as 16 bytes
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = round_bf16(f[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kStrips = 3;    // 16x64 3x3-conv strips a warp accumulates
constexpr int kRowPad = 8;    // shared-memory row padding, in elements
constexpr int kN2 = 64;       // output channels of one 1x1 weight chunk
constexpr size_t kMaxSmem = 232448;

struct Smem {
  int wp, mp, pad_px, mh, lda, ldb2, kc;
  size_t pad_bytes, h2_bytes, buf_bytes, stage_bytes;
  // the 1x1 stage reuses the padded tile's space for two x chunks
  size_t tile_bytes;
  __host__ __device__ Smem(int bs, int cm, int kc_) {
    kc = kc_;
    wp = bs + 2;                      // padded row width
    mp = round_up(bs * wp, 16);       // rows of the shifted-window product
    pad_px = mp + 2 * wp + 2;         // pixels the 9 taps read
    mh = round_up(bs * bs, 16);       // rows of h2
    lda = cm + kRowPad;               // row stride of tile, h2, w2 chunk
    ldb2 = kN2 + kRowPad;             // row stride of a w3 chunk
    pad_bytes = (size_t)pad_px * lda * sizeof(bf16);
    const size_t x_bytes = (size_t)2 * mh * ldb2 * sizeof(bf16);
    tile_bytes = pad_bytes > x_bytes ? pad_bytes : x_bytes;
    h2_bytes = (size_t)mh * lda * sizeof(bf16);
    const size_t b1 = (size_t)2 * kc * lda * sizeof(bf16);
    const size_t b2 = (size_t)2 * cm * ldb2 * sizeof(bf16);
    buf_bytes = b1 > b2 ? b1 : b2;
    stage_bytes = (size_t)kWarps * 16 * 16 * sizeof(float);
  }
  __host__ __device__ size_t buf_half(int cm, bool second) const {
    return second ? (size_t)cm * ldb2 : (size_t)kc * lda;  // elements
  }
  __host__ __device__ size_t total() const {
    return tile_bytes + h2_bytes + buf_bytes + stage_bytes;
  }
};

// The largest w2 chunk depth whose footprint fits; 0 if none does.
int pick_kc(int bs, int cm) {
  const int depths[] = {64, 32, 16};
  for (int kc : depths)
    if (cm % kc == 0 && Smem(bs, cm, kc).total() <= kMaxSmem) return kc;
  return 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  `.trans` delivers them transposed.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16x16 fp32 tile of two 16x8 accumulators, row-major into `stage`.
__device__ __forceinline__ void stage_tile(float* stage, const float (&lo)[4],
                                           const float (&hi)[4], int lane) {
  const int r = lane / 4, c = (lane % 4) * 2;
  *reinterpret_cast<float2*>(stage + r * 16 + c) = make_float2(lo[0], lo[1]);
  *reinterpret_cast<float2*>(stage + (r + 8) * 16 + c) =
      make_float2(lo[2], lo[3]);
  *reinterpret_cast<float2*>(stage + r * 16 + 8 + c) =
      make_float2(hi[0], hi[1]);
  *reinterpret_cast<float2*>(stage + (r + 8) * 16 + 8 + c) =
      make_float2(hi[2], hi[3]);
}

// The lane's 8 values of `stage`: row lane / 2, columns (lane % 2) * 8 + q.
__device__ __forceinline__ void stage_row(const float* stage, int lane,
                                          float (&v)[8]) {
  const float4* p = reinterpret_cast<const float4*>(stage + lane * 8);
  const float4 lo = p[0], hi = p[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// rows x (vecs * 8) bf16 from global (row stride src_ld) into shared memory
// (row stride dst_ld), 16 bytes per cp.async
__device__ __forceinline__ void load_chunk(bf16* dst, int dst_ld,
                                           const bf16* src, size_t src_ld,
                                           int rows, int vecs) {
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs, v = e % vecs;
    __pipeline_memcpy_async(dst + (size_t)r * dst_ld + v * 8,
                            src + r * src_ld + v * 8, 16);
  }
  __pipeline_commit();
}

template <int KC>
__global__ void __launch_bounds__(kThreads, 1)
tail_bf16(Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bs = a.bs, cm = a.cm, co = a.co;
  const Smem L(bs, cm, KC);
  const int lda = L.lda;
  bf16* pad = reinterpret_cast<bf16*>(smem);
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.tile_bytes);
  bf16* buf = reinterpret_cast<bf16*>(smem + L.tile_bytes + L.h2_bytes);
  float* stage = reinterpret_cast<float*>(smem + L.tile_bytes + L.h2_bytes +
                                          L.buf_bytes) + warp * 256;

  // padded tile by cp.async (it lands with the first w2 chunk), zero rows
  // past it and h2's zero tail rows, 16 B a copy
  const int vec = cm / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < L.pad_px * vec; e += kThreads) {
    const int pix = e / vec, v = e % vec;
    bf16* dst = pad + (size_t)pix * lda + v * 8;
    if (pix < L.wp * L.wp)
      __pipeline_memcpy_async(
          dst, padded_pixel(a, k, pix / L.wp, pix % L.wp) + v * 8, 16);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  __pipeline_commit();
  for (int e = bs * bs * vec + tid; e < L.mh * vec; e += kThreads)
    *reinterpret_cast<uint4*>(h2 + (size_t)(e / vec) * lda + e % vec * 8) =
        zero;

  // 3x3 conv -> BN2 -> ReLU into h2.  Chunk c holds w2[tap][k0:k0+KC][:].
  // Warp w owns the 64-column strip ct = w % cols and the row tiles
  // w / cols + j * (kWarps / cols), kStrips of them per pass over w2, so
  // its B fragments serve all of its strips.
  const int cols = cm / 64, warps_per_col = kWarps / cols;
  const int ct = warp % cols, row0 = warp / cols;
  const int row_tiles = L.mp / 16;
  // lane's row and column in an ldmatrix.x4 of a 16x16 tile
  const int ld_row = lane % 8 + (lane / 8) % 2 * 8, ld_col = lane / 16 * 8;
  const int nk = cm / KC, chunks = 9 * nk;
  const size_t half1 = L.buf_half(cm, false);
  auto load_w2 = [&](int c) {
    const int tap = c / nk, k0 = (c % nk) * KC;
    load_chunk(buf + (c & 1) * half1, lda,
               a.w2 + ((size_t)tap * cm + k0) * cm, cm, KC, vec);
  };
  for (int first = 0; first < row_tiles; first += warps_per_col * kStrips) {
    float acc[kStrips][8][4] = {};
    load_w2(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        load_w2(c + 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const bf16* b = buf + (c & 1) * half1 + ct * 64;
      const int tap = c / nk, k0 = (c % nk) * KC;
      const bf16* a0 = pad + (size_t)((tap / 3) * L.wp + tap % 3) * lda + k0;
#ifndef TAIL_NO_3X3_PRODUCTS
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        unsigned fb[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ldsm_x4_t(fb[q], b + (size_t)(kk + ld_row) * lda + q * 16 + ld_col);
#pragma unroll
        for (int j = 0; j < kStrips; ++j) {
          const int rt = first + row0 + j * warps_per_col;
          if (rt < row_tiles) {
            unsigned fa[4];
            ldsm_x4(fa, a0 + (size_t)(rt * 16 + ld_row) * lda + kk + ld_col);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_bf16(acc[j][2 * q], fa, fb[q][0], fb[q][1]);
              mma_bf16(acc[j][2 * q + 1], fa, fb[q][2], fb[q][3]);
            }
          }
        }
      }
#endif
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kStrips; ++j) {
      const int rt = first + row0 + j * warps_per_col;
      if (rt >= row_tiles) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        stage_tile(stage, acc[j][2 * i], acc[j][2 * i + 1], lane);
        __syncwarp();
        // lane: 8 consecutive channels of one output row, 16 bytes a copy
        const int m = rt * 16 + lane / 2, c8 = (lane % 2) * 8;
        const int oy = m / L.wp, ox = m % L.wp;
        if (oy < bs && ox < bs) {
          const int ch = ct * 64 + i * 16 + c8;
          float sc[8], bi[8], v[8];
          load8(a.s2 + ch, sc);
          load8(a.b2 + ch, bi);
          stage_row(stage, lane, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v[q] = f32(round_bf16(v[q]));
            v[q] = f32(round_bf16(__fmul_rn(v[q], sc[q])));
            v[q] = f32(round_bf16(__fadd_rn(v[q], bi[q])));
            v[q] = v[q] > 0.0f ? v[q] : 0.0f;
          }
          store8(h2 + (size_t)(oy * bs + ox) * lda + ch, v);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

#ifdef TAIL_NO_1X1_STAGE
  return;
#endif
  // 1x1 conv -> BN3 -> + x -> ReLU into y.  Chunk c holds w3[:][64c:64c+64]
  // and, in the padded tile's space, x[:][64c:64c+64] of this block.
  const int chunks2 = co / kN2, strips2 = (L.mh / 16) * 2;
  const size_t half2 = L.buf_half(cm, true), halfx = (size_t)L.mh * L.ldb2;
  const size_t base = (size_t)k * bs * bs;
  bf16* xs = pad;
  auto load_w3 = [&](int c) {
    for (int e = tid; e < bs * bs * (kN2 / 8); e += kThreads) {
      const int r = e / (kN2 / 8), v = e % (kN2 / 8);
      __pipeline_memcpy_async(xs + (c & 1) * halfx + (size_t)r * L.ldb2 + v * 8,
                              a.x + (base + r) * co + c * kN2 + v * 8, 16);
    }
    load_chunk(buf + (c & 1) * half2, L.ldb2, a.w3 + (size_t)c * kN2, co, cm,
               kN2 / 8);
  };
  load_w3(0);
  for (int c = 0; c < chunks2; ++c) {
    if (c + 1 < chunks2) {
      load_w3(c + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* b = buf + (c & 1) * half2;
    const bf16* xc = xs + (c & 1) * halfx;
    for (int t = warp; t < strips2; t += kWarps) {
      const int rt = t / 2, col = (t % 2) * 32;
      // lane: 8 consecutive channels of one output row per fragment; the
      // BN operands load before the products, to hide their latency
      const int m = rt * 16 + lane / 2, c8 = (lane % 2) * 8;
      const bool row_ok = m < bs * bs;
      float sc[2][8], bi[2][8];
      if (row_ok) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ch = c * kN2 + col + i * 16 + c8;
          load8(a.s3 + ch, sc[i]);
          load8(a.b3 + ch, bi[i]);
        }
      }
      float acc2[4][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < cm; kk += 16) {
        unsigned fa[4], fb[2][4];
        ldsm_x4(fa, h2 + (size_t)(rt * 16 + ld_row) * lda + kk + ld_col);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          ldsm_x4_t(fb[q], b + (size_t)(kk + ld_row) * L.ldb2 + col + q * 16 +
                               ld_col);
          mma_bf16(acc2[2 * q], fa, fb[q][0], fb[q][1]);
          mma_bf16(acc2[2 * q + 1], fa, fb[q][2], fb[q][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        stage_tile(stage, acc2[2 * i], acc2[2 * i + 1], lane);
        __syncwarp();
        if (row_ok) {
          float v[8], xr[8];
          const uint4 xu = *reinterpret_cast<const uint4*>(
              xc + (size_t)m * L.ldb2 + col + i * 16 + c8);
          const bf16* xh = reinterpret_cast<const bf16*>(&xu);
#pragma unroll
          for (int q = 0; q < 8; ++q) xr[q] = f32(xh[q]);
          stage_row(stage, lane, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v[q] = f32(round_bf16(v[q]));
            v[q] = f32(round_bf16(__fmul_rn(v[q], sc[i][q])));
            v[q] = f32(round_bf16(__fadd_rn(v[q], bi[i][q])));
            v[q] = f32(round_bf16(__fadd_rn(v[q], xr[q])));
            v[q] = v[q] > 0.0f ? v[q] : 0.0f;
          }
          store8(a.y + (base + m) * co + c * kN2 + col + i * 16 + c8, v);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- fp32 ----

__global__ void __launch_bounds__(kThreads)
tail_f32(Args<float> a, float* __restrict__ h2_scratch) {
  const int k = blockIdx.x, tid = threadIdx.x;
  const int bs = a.bs, cm = a.cm, co = a.co, m_all = bs * bs;
  float* h2 = h2_scratch + (size_t)k * m_all * cm;

  for (int e = tid; e < m_all * cm; e += kThreads) {
    const int m = e / cm, c = e % cm;
    const int oy = m / bs, ox = m % bs;
    float acc = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* src = padded_pixel(a, k, oy + tap / 3, ox + tap % 3);
      const float* w = a.w2 + (size_t)tap * cm * cm + c;
      for (int ci = 0; ci < cm; ++ci) acc = fmaf(src[ci], w[(size_t)ci * cm], acc);
    }
    const float v = __fadd_rn(__fmul_rn(acc, a.s2[c]), a.b2[c]);
    h2[e] = v > 0.0f ? v : 0.0f;
  }
  __syncthreads();

  const size_t base = (size_t)k * m_all;
  for (int e = tid; e < m_all * co; e += kThreads) {
    const int m = e / co, o = e % co;
    const float* hrow = h2 + (size_t)m * cm;
    float acc = 0.0f;
    for (int c = 0; c < cm; ++c) acc = fmaf(hrow[c], a.w3[(size_t)c * co + o], acc);
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

// Shared memory the bf16 kernel needs for one block (more than one CTA may
// use if no chunk depth fits).
extern "C" long long bottleneck_tail_smem_bytes(int bs, int cm) {
  const int kc = pick_kc(bs, cm);
  return (long long)Smem(bs, cm, kc ? kc : 16).total();
}

// ptrs: h1, x, top, bottom, left, right, top_left, top_right, bottom_left,
// bottom_right, w2, w3, s2, b2, s3, b3, y (17 device pointers).
// dtype: 0 = fp32 (h2_scratch (K, bs*bs, Cm) fp32 required), 1 = bf16.
extern "C" int bottleneck_tail(void* const* ptrs, void* h2_scratch, int k,
                               int bs, int cm, int co, int dtype,
                               void* stream) {
  if (k <= 0) return (int)cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int kc = pick_kc(bs, cm);
    if (!kc || cm % 64 || kWarps % (cm / 64) || co % kN2)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = Smem(bs, cm, kc).total();
    auto kernel = kc == 64 ? tail_bf16<64>
                           : (kc == 32 ? tail_bf16<32> : tail_bf16<16>);
    // raised once per kernel, never again (a CUDA graph capture may be open)
    static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
    size_t& limit = allowed[kc == 64 ? 0 : (kc == 32 ? 1 : 2)];
    if (bytes > limit) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      limit = bytes;
    }
    kernel<<<k, kThreads, bytes, s>>>(make_args<bf16>(ptrs, bs, cm, co));
  } else {
    tail_f32<<<k, kThreads, 0, s>>>(make_args<float>(ptrs, bs, cm, co),
                                    static_cast<float*>(h2_scratch));
  }
  return (int)cudaGetLastError();
}
