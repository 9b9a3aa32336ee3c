// K4: the strand-resolved fractional one-hot of genome windows, in one
// pass from a 1-D uint8 code array:
//
//   plus row b:   out[b, j, :] = table[src[start_b + j], :]
//   minus row b:  out[b, j, c] = table[src[start_b + width - 1 - j], 3 - c]
//
// start_b = starts[b], or b * row_stride where no starts are given (a 2-D
// code tensor read row by row); the minus row is the plus row flipped on
// both axes, oh.flip((1, 2)).  table is the (16, 4) one-hot table of
// mural_tpu_torch/ops/window_one_hot.py in the output's dtype; code 15
// (the sentinel) has a zero row.
//
// Replaces no Pallas kernel.  The JAX package builds this one-hot with
// an iota matmul (mural_tpu/models/layers.py _onehot_dot) and flips
// minus rows as the port did before K4: the window gather of an unfold
// view, a cast of the codes to int64, a 16-byte-row table gather
// (PyTorch's vectorized_gather_kernel, one thread block per index), then
// the flip and a torch.where.  On an H100 the table gather alone ran at
// 0.60 ns a row: 19.5 ms of each 114-ms batch of the INDEL genome-wide
// map (B=4096 windows of W=8000), and the same 0.6 ns a row in INDEL
// training (PERF.md).
//
// Bound: bytes.  A call reads B*W code bytes (overlapping windows hit in
// L2, so this counts each window's bytes once) and writes B*W*16 bytes in
// float32, B*W*8 in bf16: at B=4096, W=8000 in float32 557 MB, 0.166 ms
// at 3.35 TB/s.  There is no arithmetic.  The design serves the write:
//
// 1. A block owns one row and a tile of kTile positions of it (grid
//    (B, ceil(W / kTile))), so a row's start and strand are read once a
//    block, in 64 bits.
// 2. The 16 table rows and their 16 channel-reversed copies sit in
//    shared memory; a position's row is one 8- or 16-byte load from it.
// 3. A thread stores kPerThread whole positions, kThreads apart: each
//    store instruction of a warp writes 32 neighbouring positions, 512
//    contiguous bytes in float32.  Plain stores: at the training batch
//    (B=128) the 16-MB output stays in L2 for the U-Net's first read.
//
// Exactness: every output element is a bit copy of a table element, so
// the output equals the plain composition's bit for bit.
//
// Built with nvcc into a shared library with a plain C entry point and
// loaded through ctypes (mural_tpu_torch/ops/window_one_hot.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;   // positions of a block
constexpr int kCodes = 16;

// Elem: an unsigned integer of the output element's width (the bits are
// copied, never converted); Row: four of them.
template <typename Elem, typename Row>
__global__ void __launch_bounds__(kThreads) window_one_hot_kernel(
    const uint8_t* __restrict__ src, long long n_src,
    const long long* __restrict__ starts, long long row_stride,
    const uint8_t* __restrict__ neg, const Elem* __restrict__ table,
    Row* __restrict__ out, int width) {
  static_assert(sizeof(Row) == 4 * sizeof(Elem), "a row is 4 elements");
  // rows 0-15: the table; rows 16-31: the same rows, channels reversed
  __shared__ Row s_rows[2 * kCodes];
  if (threadIdx.x < 2 * kCodes) {
    const int code = threadIdx.x & (kCodes - 1);
    const bool rev = threadIdx.x >= kCodes;
    Elem e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = table[code * 4 + (rev ? 3 - c : c)];
    Row r;
    memcpy(&r, e, sizeof(Row));
    s_rows[threadIdx.x] = r;
  }
  const long long b = blockIdx.x;
  const long long start = starts != nullptr ? starts[b] : b * row_stride;
  const bool minus = neg != nullptr && neg[b] != 0;
  // a window outside the source stops the kernel, as an out-of-range
  // index stops torch's gather
  assert(start >= 0 && start + width <= n_src);
  const uint8_t* row = src + start;
  Row* dst = out + b * width;
  const int j0 = blockIdx.y * kTile + threadIdx.x;
  int code[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = j0 + k * kThreads;
    // "& 15" keeps any code inside the 16-row table
    code[k] = j < width ? (row[minus ? width - 1 - j : j] & 15) : 0;
  }
  __syncthreads();
  const int flip = minus ? kCodes : 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = j0 + k * kThreads;
    if (j < width) dst[j] = s_rows[code[k] + flip];
  }
}

template <typename Elem, typename Row>
cudaError_t launch(const uint8_t* src, long long n_src,
                   const long long* starts, long long row_stride,
                   const uint8_t* neg, const void* table, void* out, int B,
                   int width, int n_tiles, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % sizeof(Row) != 0)
    return cudaErrorMisalignedAddress;
  window_one_hot_kernel<Elem, Row><<<dim3(B, n_tiles), kThreads, 0, stream>>>(
      src, n_src, starts, row_stride, neg,
      static_cast<const Elem*>(table), static_cast<Row*>(out), width);
  return cudaGetLastError();
}

}  // namespace

// src: n_src code bytes; starts: B int64 window starts, or null for
// b * row_stride; neg: B bool strand flags, or null for all plus; table:
// (16, 4) contiguous elements of elem_bytes bytes (4: float32, 2:
// bfloat16); out: (B, width, 4) contiguous.  Returns the launch's
// cudaError_t.
extern "C" cudaError_t window_one_hot_launch(
    const uint8_t* src, long long n_src, const long long* starts,
    long long row_stride, const uint8_t* neg, const void* table, void* out,
    int elem_bytes, long long B, int width, cudaStream_t stream) {
  if (B == 0 || width == 0) return cudaSuccess;
  const long long n_tiles = (width + kTile - 1) / kTile;
  if (B < 0 || B > 0x7fffffffLL || width < 0 || n_tiles > 65535)
    return cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch<uint32_t, uint4>(src, n_src, starts, row_stride, neg,
                                   table, out, (int)B, width, (int)n_tiles,
                                   stream);
  if (elem_bytes == 2)
    return launch<uint16_t, uint2>(src, n_src, starts, row_stride, neg,
                                   table, out, (int)B, width, (int)n_tiles,
                                   stream);
  return cudaErrorInvalidValue;
}
