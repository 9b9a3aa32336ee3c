// Fused training stem of a distal tower: train-mode BatchNorm(one_hot)
// -> Conv1d(k, 'same') -> MaxPool1d(pk, stride pk, pad pp) on uint8
// genome codes, as a per-tap table lookup, plus its backward.
//
// K2, forward (code_conv_pool_fwd_launch):
//   v(b, i, c)     = sum_kk T[kk, ext[b, i + kk], c] + bias[c]
//   pooled[b,c,p]  = max over valid i = p*pk + j of v(b, i, c)
//   jstar[b,c,p]   = the first j that reaches the max (strict '>')
// where i runs over the pool-padded axis (conv position l = i - pp,
// valid when pp <= i < L + pp: pool padding is an excluded position) and
// ext[b, t] = codes[b, t - pp - cp] with cp = (k-1)/2, or the sentinel
// code 15 outside [0, L) (whose table row is zero: the conv's zero
// padding after the BN).  The (B, L, C) conv activation never exists.
//
// K3, backward (code_conv_pool_bwd_launch):
//   dtable[kk, q, c] = sum_(b,p) g[b,c,p] * [ext[b, p*pk + jstar + kk] == q]
// Each block owns a fixed range of (b, p) pairs; inside it thread (grp, c)
// accumulates into its own shared-memory slab, so every float sum runs
// in one fixed order without atomics.  Blocks write (k, 16, C) partials,
// and a second kernel sums them in block order: two runs give
// bit-identical dtable.
//
// Replaces the Pallas TPU kernels of mural_tpu/ops/fused_train_stem.py:
// K2 the call at :339 (_win_pool_fwd_impl, body _fwd_kernel) and K3 the
// call at :375 (_win_pool_bwd_impl, body _bwd_kernel).  Those fed a
// lane-padded window-code array and a placement-expanded table to the
// MXU; here each block gathers table rows from shared memory instead.
//
// Bound: bytes.  K2 reads B*L code bytes and writes B*C*P*(4 + 1) bytes
// of pooled values and argmax offsets; its B*P*pk*C*k adds are far below
// the card's float32 rate.  The design serves the writes: one block per
// row stages the (k, 16, C) table, the bias and the row's codes in shared
// memory, computes the (C, P) tile with consecutive threads on
// consecutive channels (conflict-free table reads) and stores the tile
// in the channels-first (B, C, P) layout with consecutive threads on
// consecutive addresses.  K3 reads codes, g and jstar once and writes
// only (blocks x k x 16 x C) partials.
//
// Built with nvcc into a shared library with a plain C entry point and
// loaded through ctypes (mural_tpu_torch/ops/fused_train_stem.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 16;
constexpr int kSentinel = 15;
constexpr int kFwdThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

__global__ void code_conv_pool_fwd_kernel(
    const uint8_t* __restrict__ codes, long long row_stride,
    const float* __restrict__ table, const float* __restrict__ bias,
    float* __restrict__ pooled, uint8_t* __restrict__ jstar, int L, int k,
    int C, int pk, int pp, int P) {
  extern __shared__ float smem[];
  float* s_table = smem;                              // k * 16 * C
  float* s_bias = s_table + k * kCodes * C;           // C
  float* s_out = s_bias + C;                          // C * P, c-major
  uint8_t* s_js = reinterpret_cast<uint8_t*>(s_out + C * P);  // C * P
  uint8_t* s_ext = s_js + C * P;                      // P * pk + k - 1

  const int b = blockIdx.x;
  const int lo = pp + (k - 1) / 2;
  const int n_ext = P * pk + k - 1;
  for (int i = threadIdx.x; i < k * kCodes * C; i += blockDim.x)
    s_table[i] = table[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_bias[i] = bias[i];
  const uint8_t* row = codes + (long long)b * row_stride;
  for (int t = threadIdx.x; t < n_ext; t += blockDim.x) {
    const int l = t - lo;
    // "& 15" keeps any out-of-range code inside the 16-row table
    s_ext[t] = (l >= 0 && l < L) ? (row[l] & 15) : kSentinel;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P * C; i += blockDim.x) {
    const int p = i / C;
    const int c = i - p * C;
    float best = 0.f;
    int best_j = -1;
    for (int j = 0; j < pk; ++j) {
      const int pos = p * pk + j;
      if (pos < pp || pos >= L + pp) continue;     // pool padding
      // the plain version's order: taps from 0, then the bias
      float acc = 0.f;
      for (int kk = 0; kk < k; ++kk)
        acc += s_table[(kk * kCodes + s_ext[pos + kk]) * C + c];
      acc = acc + s_bias[c];
      if (best_j < 0 || acc > best) {              // first max wins ties
        best = acc;
        best_j = j;
      }
    }
    s_out[c * P + p] = best;
    s_js[c * P + p] = (uint8_t)best_j;
  }
  __syncthreads();

  float* out = pooled + (long long)b * C * P;
  uint8_t* js = jstar + (long long)b * C * P;
  for (int i = threadIdx.x; i < C * P; i += blockDim.x) {
    out[i] = s_out[i];
    js[i] = s_js[i];
  }
}

// blockDim.x = groups * C; thread (grp, c) owns column c of slab grp.
__global__ void code_conv_pool_bwd_kernel(
    const uint8_t* __restrict__ codes, long long row_stride,
    const uint8_t* __restrict__ jstar, const float* __restrict__ g,
    float* __restrict__ partial, int L, int k, int C, int pk, int pp,
    int P, long long n_pairs, long long pairs_per_block) {
  extern __shared__ float s_part[];                   // groups * k*16*C
  const int slab_n = k * kCodes * C;
  const int groups = blockDim.x / C;
  const int grp = threadIdx.x / C;
  const int c = threadIdx.x - grp * C;
  for (int i = threadIdx.x; i < groups * slab_n; i += blockDim.x)
    s_part[i] = 0.f;
  __syncthreads();

  const int cp = (k - 1) / 2;
  const long long r0 = (long long)blockIdx.x * pairs_per_block;
  const long long r1 = min(n_pairs, r0 + pairs_per_block);
  // each group walks its own contiguous run of the block's pairs
  const long long per_group = (r1 - r0 + groups - 1) / groups;
  const long long g0 = r0 + grp * per_group;
  const long long g1 = min(r1, g0 + per_group);
  float* slab = s_part + grp * slab_n;
  for (long long r = g0; r < g1; ++r) {
    const long long b = r / P;
    const int p = (int)(r - b * P);
    const long long e = (b * C + c) * P + p;
    const float gv = g[e];
    const int l = p * pk + (int)jstar[e] - pp;       // conv position
    const uint8_t* row = codes + b * row_stride;
    for (int kk = 0; kk < k; ++kk) {
      const int idx = l + kk - cp;
      const int q = (idx >= 0 && idx < L) ? (row[idx] & 15) : kSentinel;
      slab[(kk * kCodes + q) * C + c] += gv;
    }
  }
  __syncthreads();

  // fold the group slabs in group order into this block's partial
  float* out = partial + (long long)blockIdx.x * slab_n;
  for (int i = threadIdx.x; i < slab_n; i += blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += s_part[gi * slab_n + i];
    out[i] = s;
  }
}

__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dtable,
                                       int n_blocks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) s += partial[(long long)blk * n + i];
  dtable[i] = s;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace

// codes: (B, L) uint8, row stride row_stride, unit column stride;
// table: (k, 16, C) float32; bias: (C,) float32; pooled: (B, C, P)
// float32 and jstar: (B, C, P) uint8, both contiguous.  Launches on
// `stream` and returns the launch status; it does not synchronise.
extern "C" cudaError_t code_conv_pool_fwd_launch(
    const uint8_t* codes, long long row_stride, const float* table,
    const float* bias, float* pooled, uint8_t* jstar, int B, int L, int k,
    int C, int pk, int pp, int P, cudaStream_t stream) {
  if (B == 0 || P == 0) return cudaSuccess;
  if (pk > 255) return cudaErrorInvalidValue;        // jstar is uint8
  const size_t smem = sizeof(float) * ((size_t)k * kCodes * C + C
                                       + (size_t)C * P)
                      + (size_t)C * P + (size_t)P * pk + k - 1;
  cudaError_t err = set_smem((const void*)code_conv_pool_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  code_conv_pool_fwd_kernel<<<B, kFwdThreads, smem, stream>>>(
      codes, row_stride, table, bias, pooled, jstar, L, k, C, pk, pp, P);
  return cudaGetLastError();
}

// codes as above; jstar and g: (B, C, P) contiguous; partial: scratch of
// n_blocks * k*16*C float32; dtable: (k, 16, C) float32.  n_blocks is
// the caller's choice; the pair ranges, and so the summation order,
// depend only on (B, P, n_blocks).
extern "C" cudaError_t code_conv_pool_bwd_launch(
    const uint8_t* codes, long long row_stride, const uint8_t* jstar,
    const float* g, float* partial, float* dtable, int B, int L, int k,
    int C, int pk, int pp, int P, int n_blocks, cudaStream_t stream) {
  const int n = k * kCodes * C;
  if (C > 1024 || n_blocks < 1) return cudaErrorInvalidValue;
  const int groups = C >= 256 ? 1 : 256 / C;
  const long long n_pairs = (long long)B * P;
  const long long per_block = (n_pairs + n_blocks - 1) / n_blocks;
  const size_t smem = sizeof(float) * (size_t)groups * n;
  cudaError_t err = set_smem((const void*)code_conv_pool_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  code_conv_pool_bwd_kernel<<<n_blocks, groups * C, smem, stream>>>(
      codes, row_stride, jstar, g, partial, L, k, C, pk, pp, P, n_pairs,
      per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, dtable, n_blocks, n);
  return cudaGetLastError();
}
