// What the stem kernels K1 (code_conv1d.cu) and K2/K3 (code_conv_pool.cu)
// share: the code table's shape, the card's per-block limits, the 16-byte
// cp.async covers that stage their tiles, and the per-tap table lookup
// that both kernels' convolutions run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 16;             // table rows per tap
constexpr int kSentinel = 15;          // the zero row: conv padding
// One block's shared memory and threads: MAX_SMEM and MAX_THREADS of
// mural_tpu_torch/ops/_plan.py, which the launch plans fill
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxThreads = 256;

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ __forceinline__ int low4(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start cp.async copies of the 16-byte aligned chunks that cover each of
// nseg byte segments [src + s*src_stride, + nbytes): segment s lands at
// dst + s*dst_stride + low4(its start), dst and dst_stride 16-byte
// aligned.  A chunk reaches at most 15 bytes past an end of its segment,
// and never past the aligned 16-byte block that holds a byte of it, so
// never outside the segment's allocation.  The chunks land in shared
// memory, so their count fits 32 bits (no 64-bit division per chunk).
// The caller waits (cp_async_wait_all) and synchronises.
__device__ void load_cover(unsigned char* dst, int dst_stride,
                           const unsigned char* src, long long src_stride,
                           int nseg, int nbytes) {
  if (nbytes <= 0) return;
  const int cps = (nbytes + 30) / 16;              // chunks per segment
  for (int q = threadIdx.x; q < nseg * cps; q += blockDim.x) {
    const int s = q / cps;
    const int j = q - s * cps;
    const uintptr_t p = reinterpret_cast<uintptr_t>(src + s * src_stride);
    const uintptr_t a = (p & ~(uintptr_t)15) + 16 * j;
    if (a < p + nbytes)
      cp_async16(dst + s * dst_stride + 16 * j,
                 reinterpret_cast<const void*>(a));
  }
}

// n floats into 16-byte aligned shared memory: by cp.async when the
// source is 16-byte aligned (it lands at dst; the caller waits), else
// element by element.
__device__ void stage(float* dst, const float* src, int n) {
  if (low4(src) == 0)
    load_cover(reinterpret_cast<unsigned char*>(dst), 0,
               reinterpret_cast<const unsigned char*>(src), 0, 1, 4 * n);
  else
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <int V>
__device__ __forceinline__ void add_row(float* acc, const float* row) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(row);
    acc[0] = acc[0] + t.x;
    acc[1] = acc[1] + t.y;
    acc[2] = acc[2] + t.z;
    acc[3] = acc[3] + t.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc[v] + row[v];
  }
}

// The conv at consecutive positions of one row for V channels; ext[t] is
// the code at padded position t.  With K > 0 (k == K known at compile
// time) the window's codes live in registers and each position reads one
// new code; with K == 0 the taps read k codes.
template <int V, int K>
struct Taps {
  int e[K > 1 ? K : 1];

  template <typename Ext>
  __device__ __forceinline__ void start(const Ext& ext, int pos) {
#pragma unroll
    for (int t = 0; t + 1 < K; ++t) e[t] = ext[pos + t];
  }

  // acc = ((0 + T[0]) + T[1]) + ... + bias: the plain version's order
  template <typename Ext>
  __device__ __forceinline__ void conv(const Ext& ext, int pos,
                                       const float* tab, int C, int k,
                                       const float* bv, float* acc) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    if constexpr (K > 0) {
      e[K - 1] = ext[pos + K - 1];
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        add_row<V>(acc, tab + (kk * kCodes + e[kk]) * C);
#pragma unroll
      for (int t = 0; t + 1 < K; ++t) e[t] = e[t + 1];
    } else {
      for (int kk = 0; kk < k; ++kk)
        add_row<V>(acc, tab + (kk * kCodes + ext[pos + kk]) * C);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc[v] + bv[v];
  }
};

}  // namespace
