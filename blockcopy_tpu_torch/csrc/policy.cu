// The policy net's train-mode BatchNorm and its RMSprop step, fused.
//
// policy/net.py runs train-mode BatchNorm after each of the policy's
// convolutions; written op by op it is some eight fp32 passes forward
// (mean, variance, subtract, rsqrt, scale, shift, the running statistics)
// and as many again in autograd's backward, and RMSprop (policy/optim.py) a
// dozen ops for each of the parameter leaves.  These kernels replace no TPU
// kernel (XLA fused those ops on the TPU); they were added because on the
// card each op was a launch of its own.  Every one is bound by bytes: it
// reads each element once or twice and does a few flops with it.  So each
// reads the convolution's own output (bf16 NHWC, or fp32) in 16-byte
// vectors, keeps the per-channel numbers in registers, and writes only
// what a later step reads: the next convolution's input in its dtype, and
// fp32 only where the math reads it again (a residual).
//
// bn_stats     per-channel mean and biased variance of an (M, C) tensor:
//              each CTA sums its rows shifted by its first row (sound, as
//              the shift is a sample), turns them into a (count, mean, M2)
//              partial, and the last CTA to finish merges the partials in
//              CTA order (Chan's formula in two passes: the mean, then the
//              M2s plus the counts times the squared distances of the
//              partial means from it), then writes mean, 1/sqrt(var
//              + eps) and, where asked, the running statistics (unbiased
//              variance, momentum).  The order of every sum is fixed, so a
//              replay is bitwise the eager run.
// bn_apply     y' = ((y - mean) * rstd) * gamma + beta [+ residual] [ReLU],
//              rounded as the op-by-op version rounds (no contraction),
//              into the next conv's dtype and/or fp32.
// bn_grad      the backward's reduction: with g the incoming gradient (the
//              sum of those given, masked by the ReLU, whose input is
//              recomputed from y, the statistics and the residual), the
//              per-channel sums of g and g * xhat -> dbeta, dgamma; writes
//              g where the residual takes it.
// bn_grad_apply dy = (gamma * rstd) * ((g - dbeta / M) - xhat * (dgamma /
//              M)), in y's dtype.
// rmsprop      RMSprop over every leaf of a parameter tree in one launch:
//              the leaves' pointers travel in the kernel's arguments (no
//              table to upload, so a CUDA graph captures them as they are),
//              one grid row a leaf.  Written as policy/optim.py's update,
//              rounding for rounding.
//
// Nothing allocates or synchronizes; a reduction's last-CTA counter is its
// stream's (ops/kernels/policy.py _sem), reset by the last CTA, so launches
// on one stream share it and launches on two never do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements of T as floats, in 16- or 8-byte pieces
template <typename T, int V>
__device__ __forceinline__ void ldv(const T* __restrict__ p, float (&v)[V]) {
  constexpr int kB = int(sizeof(T)) * V;
  if constexpr (kB % 16 == 0) {
    constexpr int kE = 16 / int(sizeof(T));
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[j];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kE; ++i) v[j * kE + i] = to_f(e[i]);
    }
  } else {
    static_assert(kB == 8, "8- or 16-byte pieces");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void stv(T* __restrict__ p, const float (&v)[V]) {
  constexpr int kB = int(sizeof(T)) * V;
  if constexpr (kB % 16 == 0) {
    constexpr int kE = 16 / int(sizeof(T));
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < kE; ++i) e[i] = from_f<T>(v[j * kE + i]);
      reinterpret_cast<uint4*>(p)[j] = u;
    }
  } else {
    static_assert(kB == 8, "8- or 16-byte pieces");
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// The per-channel sums of a CTA: `a` and `b` hold [lanes][c] partial sums
// of the row lanes; on return thread t < c holds channel t's sums over the
// lanes, taken in lane order (kThreads / c threads a channel each sum a
// strided share, then thread t sums the shares in order).
__device__ __forceinline__ void channel_sums(const float* a, const float* b,
                                             float* pa, float* pb, int lanes,
                                             int c, float& sa, float& sb) {
  const int t = threadIdx.x, parts = kThreads / c;
  const int ch = t % c, part = t / c;
  if (part < parts) {
    float x = 0.f, y = 0.f;
    for (int r = part; r < lanes; r += parts) {
      x += a[r * c + ch];
      y += b[r * c + ch];
    }
    pa[part * c + ch] = x;
    pb[part * c + ch] = y;
  }
  __syncthreads();
  sa = sb = 0.f;
  if (t < c) {
    for (int p = 0; p < parts; ++p) {
      sa += pa[p * c + t];
      sb += pb[p * c + t];
    }
  }
}

// Whether this CTA is the last of the grid to arrive at `sem` (after its
// global writes are made visible); the last one resets `sem` for the next
// launch and fences before it reads the others' writes.
__device__ __forceinline__ bool arrive_last(unsigned* sem) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(sem, 1u) == gridDim.x - 1;
    if (last) *sem = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct StatsArgs {
  const void* y;
  int m, c, rows;          // rows: a CTA's rows (the last CTA's may be fewer)
  float* part;             // [ctas][2][c]: each CTA's mean and M2
  float* mean;             // [c]
  float* rstd;             // [c]
  const float* run_mean;   // [c], null: no running update
  const float* run_var;
  float* new_mean;
  float* new_var;
  float eps, momentum, keep;   // keep: 1 - momentum, rounded from double
  unsigned* sem;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_stats(StatsArgs a) {
  __shared__ float sa[kThreads * V], sb[kThreads * V];
  __shared__ float pa[kThreads], pb[kThreads];
  const int c = a.c, groups = c / V, lanes = kThreads / groups;
  const int t = threadIdx.x, g = t % groups, r = t / groups;
  const int row0 = blockIdx.x * a.rows;
  const int row1 = min(row0 + a.rows, a.m);
  const T* y = static_cast<const T*>(a.y);
  if (r < lanes) {
    float k[V], s1[V], s2[V];
    ldv<T, V>(y + (int64_t)row0 * c + g * V, k);
#pragma unroll
    for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
#pragma unroll 4
    for (int row = row0 + r; row < row1; row += lanes) {
      float v[V];
      ldv<T, V>(y + (int64_t)row * c + g * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - k[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sa[r * c + g * V + i] = s1[i];
      sb[r * c + g * V + i] = s2[i];
    }
  }
  __syncthreads();
  float s1, s2;
  channel_sums(sa, sb, pa, pb, lanes, c, s1, s2);
  if (t < c) {
    const float n = float(row1 - row0);
    const float shift = to_f(y[(int64_t)row0 * c + t]);
    a.part[(2 * blockIdx.x) * c + t] = shift + s1 / n;
    a.part[(2 * blockIdx.x + 1) * c + t] = fmaxf(s2 - s1 * (s1 / n), 0.f);
  }
  if (!arrive_last(a.sem)) return;
  // the partials in CTA order, in two passes (every CTA but the last has
  // `rows` rows): the mean from the counts and means, then M2 as the sum
  // of the partials' M2 and of n_b (mean_b - mean)^2.  kThreads / c
  // threads a channel each take a contiguous share, then thread t sums the
  // shares in order.
  const int ctas = gridDim.x, parts = kThreads / c;
  const int ch = t % c, part = t / c;
  const int lo = part * ctas / parts, hi = (part + 1) * ctas / parts;
  __shared__ float mean_s[kThreads];
  if (part < parts) {
    float x = 0.f;
    for (int b = lo; b < hi; ++b)
      x = fmaf(float(min(a.rows, a.m - b * a.rows)),
               __ldcg(a.part + (2 * b) * c + ch), x);
    pa[part * c + ch] = x;
  }
  __syncthreads();
  if (t < c) {
    float x = 0.f;
    for (int p = 0; p < parts; ++p) x += pa[p * c + t];
    mean_s[t] = x / float(a.m);
  }
  __syncthreads();
  if (part < parts) {
    const float mean = mean_s[ch];
    float x = 0.f;
    for (int b = lo; b < hi; ++b) {
      const float d = __ldcg(a.part + (2 * b) * c + ch) - mean;
      x += fmaf(float(min(a.rows, a.m - b * a.rows)) * d, d,
                __ldcg(a.part + (2 * b + 1) * c + ch));
    }
    pb[part * c + ch] = x;
  }
  __syncthreads();
  if (t < c) {
    const float mean = mean_s[t];
    float m2 = 0.f;
    for (int p = 0; p < parts; ++p) m2 += pb[p * c + t];
    const float var = m2 / float(a.m);
    a.mean[t] = mean;
    a.rstd[t] = 1.f / sqrtf(var + a.eps);
    if (a.run_mean != nullptr) {
      // policy/net.py's running update, rounding for rounding
      const float unbiased =
          __fdiv_rn(__fmul_rn(var, float(a.m)), float(max(a.m - 1, 1)));
      a.new_mean[t] = __fadd_rn(__fmul_rn(a.keep, a.run_mean[t]),
                                __fmul_rn(a.momentum, mean));
      a.new_var[t] = __fadd_rn(__fmul_rn(a.keep, a.run_var[t]),
                               __fmul_rn(a.momentum, unbiased));
    }
  }
}

struct ApplyArgs {
  const void* y;
  const float* residual;   // null: none
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  void* out;               // the next conv's input (Tc), null: none
  float* out_f;            // fp32, null: none
  int m, c, relu;
};

template <int V>
struct Channel {
  float mean[V], rstd[V], gamma[V], beta[V];
  __device__ __forceinline__ void load(const float* mean_, const float* rstd_,
                                       const float* gamma_,
                                       const float* beta_, int ch0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = mean_[ch0 + i];
      rstd[i] = rstd_[ch0 + i];
      gamma[i] = gamma_[ch0 + i];
      beta[i] = beta_[ch0 + i];
    }
  }
  // xhat, and the ReLU's input less the residual, as net.py rounds them
  __device__ __forceinline__ float xhat(float y, int i) const {
    return __fmul_rn(__fsub_rn(y, mean[i]), rstd[i]);
  }
  __device__ __forceinline__ float affine(float xh, int i) const {
    return __fadd_rn(__fmul_rn(xh, gamma[i]), beta[i]);
  }
};

// The grid strides by a multiple of kThreads vectors and the channel
// groups divide kThreads, so each thread keeps one channel group.
template <typename T, typename Tc, int V>
__global__ void __launch_bounds__(kThreads) bn_apply(ApplyArgs a) {
  const int c = a.c, groups = c / V;
  const int total = a.m * groups, stride = gridDim.x * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  Channel<V> ch;
  ch.load(a.mean, a.rstd, a.gamma, a.beta, (i % groups) * V);
  const T* y = static_cast<const T*>(a.y);
  Tc* out = static_cast<Tc*>(a.out);
  for (; i < total; i += stride) {
    const int e = i * V;
    float v[V], res[V];
    ldv<T, V>(y + e, v);
    if (a.residual != nullptr) ldv<float, V>(a.residual + e, res);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float x = ch.affine(ch.xhat(v[j], j), j);
      if (a.residual != nullptr) x = __fadd_rn(x, res[j]);
      if (a.relu) x = x < 0.f ? 0.f : x;
      v[j] = x;
    }
    if (out != nullptr) stv<Tc, V>(out + e, v);
    if (a.out_f != nullptr) stv<float, V>(a.out_f + e, v);
  }
}

struct GradArgs {
  const void* y;
  const void* g0;          // the gradients arriving (Tc), null: none
  const void* g1;
  const float* gf;         // fp32 arriving gradient, null: none
  const float* residual;   // the forward's residual (with relu), null: none
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  float* d_res;            // the masked gradient for the residual, null: none
  // bn_grad: partial sums and their results; bn_grad_apply: reads dbeta,
  // dgamma and writes dy (T)
  float* part;             // [ctas][2][c]
  float* dbeta;
  float* dgamma;
  void* dy;
  int m, c, rows, relu;
  unsigned* sem;
};

// The gradient reaching the BN's output at V elements from e: the
// arriving gradients summed (g0, g1, then gf) and masked where the ReLU's
// input was negative.  xh gets xhat.
template <typename T, typename Tc, int V>
__device__ __forceinline__ void arriving(const GradArgs& a,
                                         const Channel<V>& ch, int e,
                                         float (&g)[V], float (&xh)[V]) {
  float v[V];
  ldv<T, V>(static_cast<const T*>(a.y) + e, v);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    g[j] = 0.f;
    xh[j] = ch.xhat(v[j], j);
  }
  if (a.g0 != nullptr) {
    ldv<Tc, V>(static_cast<const Tc*>(a.g0) + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = v[j];
  }
  if (a.g1 != nullptr) {
    ldv<Tc, V>(static_cast<const Tc*>(a.g1) + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = __fadd_rn(g[j], v[j]);
  }
  if (a.gf != nullptr) {
    ldv<float, V>(a.gf + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = __fadd_rn(g[j], v[j]);
  }
  if (a.relu) {
    if (a.residual != nullptr) ldv<float, V>(a.residual + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float pre = ch.affine(xh[j], j);
      if (a.residual != nullptr) pre = __fadd_rn(pre, v[j]);
      if (!(pre >= 0.f)) g[j] = 0.f;
    }
  }
}

template <typename T, typename Tc, int V>
__global__ void __launch_bounds__(kThreads) bn_grad(GradArgs a) {
  __shared__ float sa[kThreads * V], sb[kThreads * V];
  __shared__ float pa[kThreads], pb[kThreads];
  const int c = a.c, groups = c / V, lanes = kThreads / groups;
  const int t = threadIdx.x, g = t % groups, r = t / groups;
  const int row0 = blockIdx.x * a.rows;
  const int row1 = min(row0 + a.rows, a.m);
  if (r < lanes) {
    Channel<V> ch;
    ch.load(a.mean, a.rstd, a.gamma, a.beta, g * V);
    float s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
#pragma unroll 2
    for (int row = row0 + r; row < row1; row += lanes) {
      const int e = row * c + g * V;
      float gv[V], xh[V];
      arriving<T, Tc, V>(a, ch, e, gv, xh);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += gv[i];
        s2[i] = fmaf(gv[i], xh[i], s2[i]);
      }
      if (a.d_res != nullptr) stv<float, V>(a.d_res + e, gv);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sa[r * c + g * V + i] = s1[i];
      sb[r * c + g * V + i] = s2[i];
    }
  }
  __syncthreads();
  float s1, s2;
  channel_sums(sa, sb, pa, pb, lanes, c, s1, s2);
  if (t < c) {
    a.part[(2 * blockIdx.x) * c + t] = s1;
    a.part[(2 * blockIdx.x + 1) * c + t] = s2;
  }
  if (!arrive_last(a.sem)) return;
  const int ctas = gridDim.x, parts = kThreads / c;
  const int ch = t % c, part = t / c;
  __syncthreads();
  if (part < parts) {
    float x = 0.f, y = 0.f;
    const int lo = part * ctas / parts, hi = (part + 1) * ctas / parts;
    for (int b = lo; b < hi; ++b) {
      x += __ldcg(a.part + (2 * b) * c + ch);
      y += __ldcg(a.part + (2 * b + 1) * c + ch);
    }
    pa[part * c + ch] = x;
    pb[part * c + ch] = y;
  }
  __syncthreads();
  if (t < c) {
    float x = 0.f, y = 0.f;
    for (int p = 0; p < parts; ++p) {
      x += pa[p * c + t];
      y += pb[p * c + t];
    }
    a.dbeta[t] = x;
    a.dgamma[t] = y;
  }
}

template <typename T, typename Tc, int V>
__global__ void __launch_bounds__(kThreads) bn_grad_apply(GradArgs a) {
  const int c = a.c, groups = c / V;
  const int total = a.m * groups, stride = gridDim.x * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  const int ch0 = (i % groups) * V;
  Channel<V> ch;
  ch.load(a.mean, a.rstd, a.gamma, a.beta, ch0);
  float k[V], mb[V], mg[V];
  const float m = float(a.m);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k[j] = __fmul_rn(ch.gamma[j], ch.rstd[j]);
    mb[j] = __fdiv_rn(a.dbeta[ch0 + j], m);
    mg[j] = __fdiv_rn(a.dgamma[ch0 + j], m);
  }
  T* dy = static_cast<T*>(a.dy);
  for (; i < total; i += stride) {
    const int e = i * V;
    float gv[V], xh[V];
    if (a.d_res != nullptr) {
      float v[V];
      ldv<T, V>(static_cast<const T*>(a.y) + e, v);
      ldv<float, V>(a.d_res + e, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) xh[j] = ch.xhat(v[j], j);
    } else {
      arriving<T, Tc, V>(a, ch, e, gv, xh);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      gv[j] = __fmul_rn(k[j], __fsub_rn(__fsub_rn(gv[j], mb[j]),
                                        __fmul_rn(xh[j], mg[j])));
    stv<T, V>(dy + e, gv);
  }
}

// RMSprop: at most kLeaves leaves a launch, the arguments under 4 KB.
constexpr int kLeaves = 40;

struct Leaf {
  const float* g;
  const float* p;
  const float* sq;
  const float* buf;
  float* p_out;
  float* sq_out;
  float* buf_out;
  long long n;
};

struct RmsArgs {
  Leaf leaf[kLeaves];
  int count, momentum;
  float lr, wd, alpha, one_minus_alpha, eps, mu;
};

// policy/optim.py's update, rounding for rounding (no contraction):
// g + wd * p; alpha * sq + ((1 - alpha) * g) * g; g / (sqrt(sq) + eps);
// mu * buf + step; p - lr * step
__global__ void __launch_bounds__(kThreads) rmsprop(const RmsArgs a) {
  const Leaf& l = a.leaf[blockIdx.y];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < l.n;
       i += (long long)gridDim.x * kThreads) {
    const float p = l.p[i];
    const float g = __fadd_rn(l.g[i], __fmul_rn(a.wd, p));
    const float sq = __fadd_rn(__fmul_rn(a.alpha, l.sq[i]),
                               __fmul_rn(__fmul_rn(a.one_minus_alpha, g), g));
    float step = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(sq), a.eps));
    if (a.momentum) {
      step = __fadd_rn(__fmul_rn(a.mu, l.buf[i]), step);
      l.buf_out[i] = step;
    }
    l.sq_out[i] = sq;
    l.p_out[i] = __fsub_rn(p, __fmul_rn(a.lr, step));
  }
}

// The channel groups must divide kThreads and a reduction's channels
// kThreads (policy_bn_plan refuses other widths first).
bool shape_ok(int c, int v, bool reduce) {
  if (c <= 0 || c % v != 0) return false;
  const int groups = c / v;
  if (kThreads % groups != 0) return false;
  return !reduce || c <= kThreads;
}

enum Dtype { kF32 = 0, kBF16 = 1 };

}  // namespace

// dtype codes: 0 fp32, 1 bf16.  Each entry returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape or dtype it refuses).

extern "C" int policy_bn_stats(const void* y, int dtype, int m, int c,
                               int ctas, int rows, float* part, float* mean,
                               float* rstd, const float* run_mean,
                               const float* run_var, float* new_mean,
                               float* new_var, float eps, float momentum,
                               float keep, unsigned* sem, void* stream) {
  const int v = dtype == kBF16 ? 8 : 4;
  if (!shape_ok(c, v, true) || m <= 0 || ctas <= 0 ||
      (long long)(ctas - 1) * rows >= m || (long long)ctas * rows < m)
    return (int)cudaErrorInvalidValue;
  StatsArgs a = {y, m, c, rows, part, mean, rstd, run_mean, run_var,
                 new_mean, new_var, eps, momentum, keep, sem};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    bn_stats<__nv_bfloat16, 8><<<ctas, kThreads, 0, s>>>(a);
  else if (dtype == kF32)
    bn_stats<float, 4><<<ctas, kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// (dtype of y, dtype of the conv inputs written / gradients read)
#define POLICY_DISPATCH(KERNEL, ARGS)                                      \
  do {                                                                     \
    if (dtype == kBF16 && dtype_c == kBF16)                                \
      KERNEL<__nv_bfloat16, __nv_bfloat16, 8><<<ctas, kThreads, 0, s>>>(   \
          ARGS);                                                           \
    else if (dtype == kF32 && dtype_c == kF32)                             \
      KERNEL<float, float, 4><<<ctas, kThreads, 0, s>>>(ARGS);             \
    else if (dtype == kF32 && dtype_c == kBF16)                            \
      KERNEL<float, __nv_bfloat16, 4><<<ctas, kThreads, 0, s>>>(ARGS);     \
    else                                                                   \
      return (int)cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" int policy_bn_apply(const void* y, int dtype, int dtype_c,
                               const float* residual, const float* mean,
                               const float* rstd, const float* gamma,
                               const float* beta, void* out, float* out_f,
                               int m, int c, int relu, int ctas,
                               void* stream) {
  const int v = dtype == kBF16 ? 8 : 4;
  if (!shape_ok(c, v, false) || m <= 0 || ctas <= 0 ||
      (long long)m * c >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  ApplyArgs a = {y, residual, mean, rstd, gamma, beta, out, out_f, m, c,
                 relu};
  auto s = static_cast<cudaStream_t>(stream);
  POLICY_DISPATCH(bn_apply, a);
  return (int)cudaGetLastError();
}

extern "C" int policy_bn_grad(const void* y, int dtype, int dtype_c,
                              const void* g0, const void* g1, const float* gf,
                              const float* residual, const float* mean,
                              const float* rstd, const float* gamma,
                              const float* beta, float* d_res, float* part,
                              float* dbeta, float* dgamma, int m, int c,
                              int relu, int ctas, int rows, unsigned* sem,
                              void* stream) {
  const int v = dtype == kBF16 ? 8 : 4;
  if (!shape_ok(c, v, true) || m <= 0 || ctas <= 0 ||
      (long long)m * c >= INT32_MAX || (long long)(ctas - 1) * rows >= m ||
      (long long)ctas * rows < m)
    return (int)cudaErrorInvalidValue;
  GradArgs a = {y,    g0,    g1,     gf,      residual, mean, rstd,
                gamma, beta, d_res,  part,    dbeta,    dgamma, nullptr,
                m,    c,     rows,   relu,    sem};
  auto s = static_cast<cudaStream_t>(stream);
  POLICY_DISPATCH(bn_grad, a);
  return (int)cudaGetLastError();
}

extern "C" int policy_bn_grad_apply(const void* y, int dtype, int dtype_c,
                                    const void* g0, const void* g1,
                                    const float* gf, const float* residual,
                                    const float* mean, const float* rstd,
                                    const float* gamma, const float* beta,
                                    const float* d_res, const float* dbeta,
                                    const float* dgamma, void* dy, int m,
                                    int c, int relu, int ctas, void* stream) {
  const int v = dtype == kBF16 ? 8 : 4;
  if (!shape_ok(c, v, false) || m <= 0 || ctas <= 0 ||
      (long long)m * c >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  GradArgs a = {y,     g0,    g1,   gf,
                residual, mean, rstd, gamma,
                beta,  const_cast<float*>(d_res), nullptr,
                const_cast<float*>(dbeta), const_cast<float*>(dgamma), dy,
                m,     c,     0,    relu,
                nullptr};
  auto s = static_cast<cudaStream_t>(stream);
  POLICY_DISPATCH(bn_grad_apply, a);
  return (int)cudaGetLastError();
}

// ptrs: count x 7 pointers (g, p, sq, buf, p_out, sq_out, buf_out; the
// buffers may be null where momentum is 0), sizes: count element counts.
extern "C" int rmsprop_multi(void* const* ptrs, const long long* sizes,
                             int count, int ctas_x, float lr, float wd,
                             float alpha, float one_minus_alpha, float eps,
                             float mu, int momentum, void* stream) {
  if (count <= 0 || count > kLeaves || ctas_x <= 0)
    return (int)cudaErrorInvalidValue;
  RmsArgs a;
  for (int i = 0; i < count; ++i) {
    void* const* q = ptrs + 7 * i;
    a.leaf[i] = {static_cast<const float*>(q[0]),
                 static_cast<const float*>(q[1]),
                 static_cast<const float*>(q[2]),
                 static_cast<const float*>(q[3]),
                 static_cast<float*>(q[4]),
                 static_cast<float*>(q[5]),
                 static_cast<float*>(q[6]),
                 sizes[i]};
    if (momentum && (q[3] == nullptr || q[6] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.count = count;
  a.momentum = momentum;
  a.lr = lr;
  a.wd = wd;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.eps = eps;
  a.mu = mu;
  rmsprop<<<dim3(ctas_x, count), kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
