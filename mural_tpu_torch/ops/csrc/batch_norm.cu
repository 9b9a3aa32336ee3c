// K5: train-mode BatchNorm over (N, C, L) activations, forward and
// backward, for each channel c over its M = N * L elements:
//
//   forward:   mean, var = the batch's mean and biased variance
//              rstd = 1 / sqrt(var + eps)
//              y = (x - mean) * rstd * gamma + beta
//              running_mean = (1 - momentum) * running_mean + momentum * mean
//              running_var  = (1 - momentum) * running_var
//                             + momentum * var * M / (M - 1)
//              num_batches_tracked += 1
//   backward:  dbeta = sum(dy), dgamma = sum(dy * xhat), xhat = (x - mean) * rstd
//              dx = gamma * rstd * (dy - dbeta / M - xhat * dgamma / M)
//
// Replaces no Pallas kernel: the JAX package leaves its BatchNorm to XLA.
// It was added because cuDNN's train-mode BatchNorm kernels took about 65%
// of the INDEL U-Net's train step on an H100 (PERF.md): their spatial
// kernels split the work over channels, and a U-Net level holds 4 to 16
// channels of 128 x 8000 elements, so a handful of blocks held the card.
//
// Bound: bytes.  Forward reads x and writes y, backward reads x and dy and
// writes dx: five passes of the activation, against a few operations an
// element.  The design serves the passes:
//
// 1. A channel's elements are cut into S chunks of whole vectors (4
//    elements when L is a multiple of 4 and the tensors are aligned, else
//    1), one block a chunk: grid (S, C), with S chosen from the shape by
//    the wrapper's launch plan so that even a 4-channel plane of 1M
//    elements a channel fills the card.  A thread keeps kUnroll vector
//    loads in flight.
// 2. Forward takes two launches: the statistics pass writes each block's
//    (mean, M2) partial (Welford within a thread over whole vectors, Chan's
//    merge across threads), and the apply pass merges the channel's S
//    partials in float64, in index order, in every block (a few hundred
//    bytes from L2), then writes y; block 0 of a channel updates the
//    running statistics and saves mean and rstd for the backward.
//    Backward likewise: a pass of partial sums of dy and dy * (x - mean),
//    then one that merges them in float64 and writes dx (block 0 writes
//    dgamma and dbeta).  Every reduction runs in a fixed order, so a step
//    repeats bit for bit.
// 3. The partials live in a workspace that the wrapper allocates from
//    torch with each forward, beside the saved mean and rstd, and the
//    backward reuses it; nothing is synchronised with the host, so the
//    launches may be captured in a CUDA graph.
//
// The reads of x in the second pass of each direction and the partials'
// round trip are the cost of the split over blocks: three passes forward
// and five backward where the floor counts two and three.
//
// Statistics, parameters and gradients of gamma and beta are float32; x,
// y, dy and dx are float32 or bfloat16 (converted to float32 on load and
// rounded to nearest even on store).
//
// Built with nvcc into a shared library with two plain C entry points, each
// taking one argument struct, and loaded through ctypes
// (mural_tpu_torch/ops/batch_norm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// A channel's elements as Q = N * LV vectors of V: vector q lies in row
// n = q / LV at vector l = q % LV of the row.  Block s of a channel owns
// vectors [s * chunk, min(Q, (s + 1) * chunk)).
struct Plane {
  int C;
  int LV;          // vectors a row
  unsigned Q;      // vectors a channel (< 2^31)
  unsigned chunk;  // vectors a block
  int S;           // blocks a channel
  int V;           // elements a vector
};

__device__ __forceinline__ long long vec_offset(const Plane& p, int c,
                                                unsigned q) {
  const unsigned n = q / (unsigned)p.LV;
  const unsigned l = q - n * (unsigned)p.LV;
  return ((long long)n * p.C + c) * p.LV + l;
}

// elements of block s's chunk
__device__ __forceinline__ double chunk_count(const Plane& p, int s) {
  const unsigned long long lo = (unsigned long long)s * p.chunk;
  const unsigned long long hi =
      lo + p.chunk < p.Q ? lo + p.chunk : (unsigned long long)p.Q;
  return (double)(hi - lo) * p.V;
}

// count, mean and sum of squared deviations of a set of elements
template <typename F>
struct Moments {
  F n, mean, m2;
};

// Chan's merge of b into a
template <typename F>
__device__ __forceinline__ void merge(Moments<F>& a, const Moments<F>& b) {
  if (b.n == F(0)) return;
  const F n = a.n + b.n;
  const F d = b.mean - a.mean;
  const F w = b.n / n;
  a.mean += d * w;
  a.m2 += b.m2 + d * d * a.n * w;
  a.n = n;
}

template <typename F>
__device__ __forceinline__ Moments<F> shfl_down(const Moments<F>& m,
                                                int offset) {
  return {__shfl_down_sync(0xffffffffu, m.n, offset),
          __shfl_down_sync(0xffffffffu, m.mean, offset),
          __shfl_down_sync(0xffffffffu, m.m2, offset)};
}

// a warp's moments merged into lane 0, in a fixed tree
template <typename F>
__device__ __forceinline__ void warp_merge(Moments<F>& m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge(m, shfl_down(m, o));
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ __forceinline__ double2 warp_sum(double2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// A block's walk over its chunk: f(offset, x vector, g vector) for each of
// its vectors, with g read from the same offset where kTwo (else g is x),
// kUnroll vectors of each in flight a thread.
template <typename T, int V, bool kTwo, typename Fn>
__device__ __forceinline__ void walk(const Plane& p, const T* __restrict__ x,
                                     const T* __restrict__ g, Fn f) {
  const int c = blockIdx.y;
  const unsigned q0 = blockIdx.x * p.chunk;
  const unsigned q1 = q0 + p.chunk < p.Q ? q0 + p.chunk : p.Q;
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  const Vec<T, V>* gv = reinterpret_cast<const Vec<T, V>*>(g);
  for (unsigned q = q0 + threadIdx.x; q < q1; q += kThreads * kUnroll) {
    Vec<T, V> bx[kUnroll], bg[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned qu = q + u * kThreads;
      off[u] = vec_offset(p, c, qu);
      if (qu < q1) {
        bx[u] = xv[off[u]];
        if (kTwo) bg[u] = gv[off[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q + u * kThreads < q1) f(off[u], bx[u], kTwo ? bg[u] : bx[u]);
  }
}

// --- forward ------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) k5_bn_stats_kernel(
    const T* __restrict__ x, Plane p, float2* __restrict__ partial) {
  Moments<float> acc{0.f, 0.f, 0.f};
  walk<T, V, false>(p, x, x, [&](long long, const Vec<T, V>& v,
                                 const Vec<T, V>&) {
    float e[V], s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += e[i] = to_float(v.v[i]);
    const float mean = s * (1.f / V);
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) m2 += (e[i] - mean) * (e[i] - mean);
    merge(acc, Moments<float>{float(V), mean, m2});
  });
  __shared__ Moments<float> s_warp[kWarps];
  warp_merge(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? s_warp[lane] : Moments<float>{0.f, 0.f, 0.f};
    warp_merge(acc);
    if (lane == 0)
      partial[blockIdx.y * p.S + blockIdx.x] = make_float2(acc.mean, acc.m2);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) k5_bn_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, Plane p,
    const float2* __restrict__ partial, const float* __restrict__ weight,
    const float* __restrict__ bias, float* __restrict__ running_mean,
    float* __restrict__ running_var, long long* __restrict__ num_batches,
    float* __restrict__ save_mean, float* __restrict__ save_rstd, float eps,
    float momentum) {
  __shared__ float s_mean, s_scale, s_shift;
  const int c = blockIdx.y;
  if (threadIdx.x < 32) {
    // the channel's partials, merged in float64 in a fixed order
    Moments<double> m{0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < p.S; i += 32) {
      const float2 pt = partial[c * p.S + i];
      merge(m, Moments<double>{chunk_count(p, i), pt.x, pt.y});
    }
    warp_merge(m);
    if (threadIdx.x == 0) {
      const double var = m.m2 / m.n;
      const float rstd = (float)(1.0 / sqrt(var + (double)eps));
      const float mean = (float)m.mean;
      s_mean = mean;
      s_scale = rstd * weight[c];
      s_shift = bias[c];
      if (blockIdx.x == 0) {
        save_mean[c] = mean;
        save_rstd[c] = rstd;
        const double mom = momentum;
        running_mean[c] =
            (float)((1.0 - mom) * running_mean[c] + mom * m.mean);
        running_var[c] = (float)((1.0 - mom) * running_var[c] +
                                 mom * (m.m2 / (m.n - 1.0)));
        if (c == 0) *num_batches += 1;
      }
    }
  }
  __syncthreads();
  const float mean = s_mean, scale = s_scale, shift = s_shift;
  Vec<T, V>* yv = reinterpret_cast<Vec<T, V>*>(y);
  walk<T, V, false>(p, x, x, [&](long long off, const Vec<T, V>& v,
                                 const Vec<T, V>&) {
    Vec<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i)
      out.v[i] = from_float<T>(fmaf(to_float(v.v[i]) - mean, scale, shift));
    yv[off] = out;
  });
}

// --- backward -----------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) k5_bn_bwd_reduce_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, Plane p,
    const float* __restrict__ save_mean, float2* __restrict__ partial) {
  const float mean = save_mean[blockIdx.y];
  float2 acc = make_float2(0.f, 0.f);
  walk<T, V, true>(p, x, dy, [&](long long, const Vec<T, V>& v,
                                 const Vec<T, V>& g) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gi = to_float(g.v[i]);
      acc.x += gi;
      acc.y = fmaf(gi, to_float(v.v[i]) - mean, acc.y);
    }
  });
  __shared__ float2 s_warp[kWarps];
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? s_warp[lane] : make_float2(0.f, 0.f);
    acc = warp_sum(acc);
    if (lane == 0) partial[blockIdx.y * p.S + blockIdx.x] = acc;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) k5_bn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    Plane p, const float2* __restrict__ partial,
    const float* __restrict__ weight, const float* __restrict__ save_mean,
    const float* __restrict__ save_rstd, float* __restrict__ dweight,
    float* __restrict__ dbias) {
  __shared__ float s_a, s_b, s_c;
  const int c = blockIdx.y;
  if (threadIdx.x < 32) {
    // the channel's partials, summed in float64 in a fixed order
    double2 sum = make_double2(0.0, 0.0);
    for (int i = threadIdx.x; i < p.S; i += 32) {
      const float2 pt = partial[c * p.S + i];
      sum.x += pt.x;
      sum.y += pt.y;
    }
    sum = warp_sum(sum);
    if (threadIdx.x == 0) {
      const double n = (double)p.Q * p.V;
      const double rstd = save_rstd[c];
      const double dbeta = sum.x, dgamma = sum.y * rstd;
      if (blockIdx.x == 0) {
        dweight[c] = (float)dgamma;
        dbias[c] = (float)dbeta;
      }
      // dx = a * dy - b * (x - mean) - k
      const double a = weight[c] * rstd;
      s_a = (float)a;
      s_b = (float)(a * rstd * dgamma / n);
      s_c = (float)(a * dbeta / n);
    }
  }
  if (dx == nullptr) return;
  __syncthreads();
  const float mean = save_mean[c], a = s_a, b = s_b, k = s_c;
  Vec<T, V>* dv = reinterpret_cast<Vec<T, V>*>(dx);
  walk<T, V, true>(p, x, dy, [&](long long off, const Vec<T, V>& v,
                                 const Vec<T, V>& g) {
    Vec<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xm = to_float(v.v[i]) - mean;
      out.v[i] = from_float<T>(fmaf(a, to_float(g.v[i]), -fmaf(b, xm, k)));
    }
    dv[off] = out;
  });
}

Plane make_plane(long long N, int C, long long L, int vec, int S,
                 long long chunk) {
  Plane p;
  p.C = C;
  p.LV = (int)(L / vec);
  p.Q = (unsigned)(N * (L / vec));
  p.chunk = (unsigned)chunk;
  p.S = S;
  p.V = vec;
  return p;
}

bool plan_ok(long long N, int C, long long L, int vec, int S,
             long long chunk) {
  if (N <= 0 || C <= 0 || C > 65535 || L <= 0 || S <= 0 || chunk <= 0)
    return false;
  if (vec != 1 && vec != 4) return false;
  if (L % vec != 0 || L / vec > 0x7fffffffLL) return false;
  const long long Q = N * (L / vec);
  // every block non-empty, the last one reaching Q, Q < 2^31
  return Q < 0x80000000LL && (long long)(S - 1) * chunk < Q &&
         (long long)S * chunk >= Q;
}

template <typename T, int V>
cudaError_t forward(const void* x, void* y, const Plane& p, float2* work,
                    const float* weight, const float* bias,
                    float* running_mean, float* running_var,
                    long long* num_batches, float* save_mean,
                    float* save_rstd, float eps, float momentum,
                    cudaStream_t stream) {
  const dim3 grid(p.S, p.C);
  k5_bn_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), p, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k5_bn_apply_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p, work, weight, bias,
      running_mean, running_var, num_batches, save_mean, save_rstd, eps,
      momentum);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t backward(const void* x, const void* dy, void* dx, const Plane& p,
                     float2* work, const float* weight,
                     const float* save_mean, const float* save_rstd,
                     float* dweight, float* dbias, cudaStream_t stream) {
  k5_bn_bwd_reduce_kernel<T, V><<<dim3(p.S, p.C), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), p, save_mean,
      work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // without dx, one block a channel writes dgamma and dbeta
  k5_bn_bwd_apply_kernel<T, V>
      <<<dim3(dx != nullptr ? p.S : 1, p.C), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dx), p, work, weight, save_mean, save_rstd,
          dweight, dbias);
  return cudaGetLastError();
}

}  // namespace

// One call's arguments (batch_norm.py _Args, field for field): x, y, dy,
// dx: (N, C, L) contiguous, elem_bytes 4 (float32) or 2 (bfloat16),
// 16-byte aligned (8 for bfloat16) where vec is 4; stats: C float32 mean,
// C rstd, then the C * S float2 partials; weight, bias, running_mean,
// running_var, dweight, dbias: C float32; num_batches: one int64; the
// launch plan (vec, S, chunk) from batch_norm.py's bn_launch_plan.  The
// forward reads all but dy, dx, dweight and dbias; the backward reads x,
// dy, dx (null: no data gradient), stats, weight, dweight, dbias, the
// shape, the plan and the stream.
struct K5Args {
  const void* x;
  void* y;
  const void* dy;
  void* dx;
  float* stats;
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  long long* num_batches;
  float* dweight;
  float* dbias;
  cudaStream_t stream;
  long long N, L, chunk;
  int C, elem_bytes, vec, S;
  float eps, momentum;
};

// Both return the launches' cudaError_t.
extern "C" cudaError_t k5_bn_forward(const K5Args* a) {
  if (!plan_ok(a->N, a->C, a->L, a->vec, a->S, a->chunk))
    return cudaErrorInvalidValue;
  const Plane p = make_plane(a->N, a->C, a->L, a->vec, a->S, a->chunk);
  float* mean = a->stats;
  float* rstd = a->stats + a->C;
  float2* work = reinterpret_cast<float2*>(a->stats + 2 * a->C);
#define K5_FORWARD(T, V)                                                   \
  return forward<T, V>(a->x, a->y, p, work, a->weight, a->bias,            \
                       a->running_mean, a->running_var, a->num_batches,    \
                       mean, rstd, a->eps, a->momentum, a->stream)
  if (a->elem_bytes == 4) {
    if (a->vec == 4) K5_FORWARD(float, 4);
    K5_FORWARD(float, 1);
  }
  if (a->elem_bytes == 2) {
    if (a->vec == 4) K5_FORWARD(__nv_bfloat16, 4);
    K5_FORWARD(__nv_bfloat16, 1);
  }
#undef K5_FORWARD
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t k5_bn_backward(const K5Args* a) {
  if (!plan_ok(a->N, a->C, a->L, a->vec, a->S, a->chunk))
    return cudaErrorInvalidValue;
  const Plane p = make_plane(a->N, a->C, a->L, a->vec, a->S, a->chunk);
  const float* mean = a->stats;
  const float* rstd = a->stats + a->C;
  float2* work = reinterpret_cast<float2*>(a->stats + 2 * a->C);
#define K5_BACKWARD(T, V)                                                  \
  return backward<T, V>(a->x, a->dy, a->dx, p, work, a->weight, mean, rstd, \
                        a->dweight, a->dbias, a->stream)
  if (a->elem_bytes == 4) {
    if (a->vec == 4) K5_BACKWARD(float, 4);
    K5_BACKWARD(float, 1);
  }
  if (a->elem_bytes == 2) {
    if (a->vec == 4) K5_BACKWARD(__nv_bfloat16, 4);
    K5_BACKWARD(__nv_bfloat16, 1);
  }
#undef K5_BACKWARD
  return cudaErrorInvalidValue;
}
