// K1: fused one-hot + eval-mode BatchNorm + first Conv1d of a distal
// tower, as a per-tap table lookup on uint8 genome codes:
//
//   out[b, l, c] = sum_kk T[kk, codes_pad[b, l + kk], c] + bias[c]
//
// codes_pad is codes padded by (k-1)/2 on each side with the sentinel
// code 15, whose table row is zero (the conv's zero padding).
//
// Replaces the Pallas TPU kernel of mural_tpu/ops/fused_code_conv.py: the
// pallas_call at :115 (op code_conv1d :93, body _kernel :71).  The TPU
// version feeds k pre-shifted code planes to an MXU matmul against a
// one-hot; here threads gather float32 table rows from shared memory, so
// neither a one-hot nor a shifted copy exists.
//
// Bound: bytes, the (B, L, C) float32 output write.  A call reads B*L
// code bytes and writes 4*B*L*C bytes.  One predict batch runs K1 twice,
// B=4096 at L=401 and on tower 1's L=201 crop, C=32: 318 MB, about
// 0.095 ms at 3.35 TB/s (chip_smoke.py k1_bound).  Its k adds per output
// are far below the card's float32 rate.  The design serves the write:
//
// 1. Few, long blocks.  The launch plan (k1_launch_plan in
//    fused_code_conv.py) gives a block R whole rows, or at small B one
//    (row, L-tile) piece, so that a call has a few blocks per SM at
//    B=4096 and at least one per SM at small B.  A block stages the
//    (k, 16, C) table, the bias and its rows' codes with their k-1 halo
//    once, by 16-byte cp.async copies of the aligned chunks that cover
//    them.  A code span keeps its source's offset within 16 bytes, so
//    tower 1's crop (byte 100 of a 401-byte row) is never realigned.
//    Positions outside the row read as the sentinel.
// 2. Four channels per thread.  A thread owns V = 4 adjacent channels
//    (V = 1 when C % 4 != 0; a template parameter) of a run of W
//    consecutive positions of one row.  Per position it reads k float4
//    table rows (eight threads cover a 32-channel row, conflict-free) and,
//    for k == 3, one new code byte: the other two slide through
//    registers (the generic-k path reads k codes).  The loop has no
//    integer division.
// 3. 16-byte stores straight from registers.  The channels-last output is
//    the threads' own layout, so at C=32 a warp's store writes four whole
//    128-byte segments (the ragged ends of a row need no special case).
//    Streaming stores (st.global.cs): the output is six times the L2
//    (PERF.md has the comparison with plain stores).
//
// Exactness: each output sums 0 + T[0] + T[1] + ... in tap order, then
// adds the bias, as code_conv1d_reference does: max abs error 0.
//
// Built with nvcc into a shared library with a plain C entry point and
// loaded through ctypes (mural_tpu_torch/ops/fused_code_conv.py).

#include "stem.cuh"

namespace {

// Shared-memory layout of one block, in bytes; the same formula as
// _k1_smem_bytes in fused_code_conv.py (the launcher checks that they
// agree): table | bias | one code span per row, each with room for a
// 16-byte cover.
struct Layout {
  long long bias, raw, total;
  int raw_stride;
  __host__ __device__ Layout(int k, int C, int R, int TL) {
    bias = 4LL * k * kCodes * C;
    raw = bias + 4 * round_up(C, 4);
    raw_stride = (int)round_up(TL + k - 1 + 15, 16);
    total = raw + (long long)R * raw_stride;
  }
};

// The staged codes of one row of a piece: ext[t] is the code at position
// l0 - p + t of the row, or the sentinel outside it.
struct RowCodes {
  const unsigned char* raw;   // raw[off + t] holds ext[t] for valid t
  int off, t_lo, n;           // valid t: [t_lo, t_lo + n)

  __device__ __forceinline__ int operator[](int t) const {
    // "& 15" keeps any out-of-range code inside the 16-row table
    return (unsigned)(t - t_lo) < (unsigned)n ? (raw[off + t] & 15)
                                              : kSentinel;
  }
};

template <int V>
__device__ __forceinline__ void store(float* dst, const float* acc) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  else
    __stcs(dst, acc[0]);
}

// Block blockIdx.x = rb * n_lt + lt owns rows [rb*R, rb*R + R) and
// positions [lt*TL, lt*TL + TL) (clipped to B and L); a thread owns V
// channels of a run of W positions of one row.
template <int V, int K>
__global__ void __launch_bounds__(kMaxThreads) code_conv1d_kernel(
    const uint8_t* __restrict__ codes, long long row_stride,
    const float* __restrict__ table, const float* __restrict__ bias,
    float* __restrict__ out, int B, int L, int k, int C, int R, int TL,
    int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(k, C, R, TL);
  const float* s_table = reinterpret_cast<const float*>(smem);
  const float* s_bias = reinterpret_cast<const float*>(smem + lay.bias);
  unsigned char* s_raw = smem + lay.raw;

  const int n_lt = (L + TL - 1) / TL;
  const int rb = blockIdx.x / n_lt;
  const int lt = blockIdx.x - rb * n_lt;
  const int b0 = rb * R, nr = min(R, B - b0);
  const int l0 = lt * TL, nl = min(TL, L - l0);
  const int p = (k - 1) / 2;
  // each row's codes [l0 - p, l0 + nl + p), clipped to the row
  const int l_lo = max(0, l0 - p), l_hi = min(L, l0 + nl + p);
  const uint8_t* row0 = codes + (long long)b0 * row_stride + l_lo;

  stage(reinterpret_cast<float*>(smem), table, k * kCodes * C);
  stage(reinterpret_cast<float*>(smem + lay.bias), bias, C);
  load_cover(s_raw, lay.raw_stride, row0, row_stride, nr, l_hi - l_lo);
  cp_async_wait_all();
  __syncthreads();

  const int CG = C / V;
  const int nw = (nl + W - 1) / W;
  for (int u = threadIdx.x; u < nr * nw * CG; u += blockDim.x) {
    const int rw = u / CG;
    const int c = (u - rw * CG) * V;
    const int r = rw / nw;
    const int w = rw - r * nw;
    const RowCodes ext{s_raw + r * lay.raw_stride,
                       low4(row0 + r * row_stride) - (l_lo - (l0 - p)),
                       l_lo - (l0 - p), l_hi - l_lo};
    const float* tab = s_table + c;
    float bv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) bv[v] = s_bias[c + v];
    const int lp0 = w * W, lp1 = min(nl, lp0 + W);
    float* o = out + ((long long)(b0 + r) * L + l0 + lp0) * C + c;
    Taps<V, K> taps;
    taps.start(ext, lp0);
    for (int lp = lp0; lp < lp1; ++lp, o += C) {
      float acc[V];
      taps.conv(ext, lp, tab, C, k, bv, acc);
      store<V>(o, acc);
    }
  }
}

template <int V, int K>
cudaError_t launch(const uint8_t* codes, long long row_stride,
                   const float* table, const float* bias, float* out, int B,
                   int L, int k, int C, int R, int TL, int W, int grid,
                   int threads, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)code_conv1d_kernel<V, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  code_conv1d_kernel<V, K><<<grid, threads, smem, stream>>>(
      codes, row_stride, table, bias, out, B, L, k, C, R, TL, W);
  return cudaGetLastError();
}

}  // namespace

// codes: (B, L) uint8, row stride row_stride elements, unit column
// stride; table: (k, 16, C) float32; bias: (C,) float32; out: (B, L, C)
// float32 contiguous.  (R, TL, W, grid, threads, smem) is the launch plan
// (k1_launch_plan); a plan whose shared memory or grid differs from this
// file's own derivation is refused.  Launches on `stream` and returns the
// launch status; it does not synchronise.
extern "C" cudaError_t code_conv1d_launch(
    const uint8_t* codes, long long row_stride, const float* table,
    const float* bias, float* out, int B, int L, int k, int C, int R, int TL,
    int W, int grid, int threads, long long smem, cudaStream_t stream) {
  if (B == 0 || L == 0) return cudaSuccess;
  const Layout lay(k, C, R, TL);
  if (R < 1 || R > B || TL < 1 || TL > L || W < 1 || threads < 1
      || threads > kMaxThreads || smem != lay.total || smem > kMaxSmem
      || grid != (long long)((B + R - 1) / R) * ((L + TL - 1) / TL))
    return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0;
  if (vec && low4(out) != 0) return cudaErrorMisalignedAddress;
  if (k == 3)
    return vec ? launch<4, 3>(codes, row_stride, table, bias, out, B, L, k,
                              C, R, TL, W, grid, threads, smem, stream)
               : launch<1, 3>(codes, row_stride, table, bias, out, B, L, k,
                              C, R, TL, W, grid, threads, smem, stream);
  return vec ? launch<4, 0>(codes, row_stride, table, bias, out, B, L, k, C,
                            R, TL, W, grid, threads, smem, stream)
             : launch<1, 0>(codes, row_stride, table, bias, out, B, L, k, C,
                            R, TL, W, grid, threads, smem, stream);
}
