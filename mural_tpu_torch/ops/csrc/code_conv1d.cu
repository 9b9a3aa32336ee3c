// Fused one-hot + eval-mode BatchNorm + first Conv1d of a distal tower,
// as a per-tap table lookup on uint8 genome codes:
//
//   out[b, l, c] = sum_kk T[kk, codes_pad[b, l + kk], c] + bias[c]
//
// codes_pad is codes padded by (k-1)/2 on each side with the sentinel
// code 15, whose table row is zero (the conv's zero padding).
//
// Replaces the Pallas TPU kernel mural_tpu/ops/fused_code_conv.py
// code_conv1d (body _kernel).  The TPU version feeds k pre-shifted code
// planes to an MXU matmul against a one-hot; here each block gathers
// table rows straight from shared memory, so no shifted copy exists.
//
// Bound: the (B, L, C) float32 output write.  Per call it reads B*L
// bytes of codes and writes B*L*C*4 bytes (about 210 MB at B=4096,
// L=401, C=32), so on an H100 (3.35 TB/s) the floor is about 63 us.  The
// design serves that write: one block per (row, L-tile); the (k,16,C)
// table, the bias and the tile's codes with their k-1 halo sit in shared
// memory; consecutive threads produce consecutive channels of the
// channels-last output, so every warp stores a contiguous 128-byte run.
//
// Built with nvcc into a shared library with a plain C entry point and
// loaded through ctypes (mural_tpu_torch/ops/fused_code_conv.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 16;
constexpr int kSentinel = 15;
constexpr int kThreads = 256;

__global__ void code_conv1d_kernel(const uint8_t* __restrict__ codes,
                                   long long row_stride,
                                   const float* __restrict__ table,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out,
                                   int L, int k, int C, int tile_l) {
  extern __shared__ float smem[];
  float* s_table = smem;                               // k * 16 * C
  float* s_bias = s_table + k * kCodes * C;            // C
  uint8_t* s_codes = reinterpret_cast<uint8_t*>(s_bias + C);  // tile+k-1

  const int b = blockIdx.x;
  const int l0 = blockIdx.y * tile_l;
  const int n_l = min(tile_l, L - l0);
  const int p = (k - 1) / 2;

  for (int i = threadIdx.x; i < k * kCodes * C; i += blockDim.x)
    s_table[i] = table[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_bias[i] = bias[i];
  const uint8_t* row = codes + (long long)b * row_stride;
  for (int i = threadIdx.x; i < n_l + k - 1; i += blockDim.x) {
    const int l = l0 - p + i;
    // "& 15" keeps any out-of-range code inside the 16-row table
    s_codes[i] = (l >= 0 && l < L) ? (row[l] & 15) : kSentinel;
  }
  __syncthreads();

  float* out_tile = out + ((long long)b * L + l0) * C;
  for (int i = threadIdx.x; i < n_l * C; i += blockDim.x) {
    const int l = i / C;
    const int c = i - l * C;
    // same summation order as the plain version: taps first, then bias
    float acc = 0.f;
    for (int kk = 0; kk < k; ++kk)
      acc += s_table[(kk * kCodes + s_codes[l + kk]) * C + c];
    out_tile[i] = acc + s_bias[c];
  }
}

size_t smem_bytes(int k, int C, int tile_l) {
  return sizeof(float) * ((size_t)k * kCodes * C + C) + tile_l + k - 1;
}

}  // namespace

// codes: (B, L) uint8, row stride row_stride elements, unit column
// stride; table: (k, 16, C) float32; bias: (C,) float32; out: (B, L, C)
// float32 contiguous.  Launches on `stream` and returns the launch
// status; it does not synchronise.
extern "C" cudaError_t code_conv1d_launch(const uint8_t* codes,
                                          long long row_stride,
                                          const float* table,
                                          const float* bias, float* out,
                                          int B, int L, int k, int C,
                                          int tile_l, cudaStream_t stream) {
  if (B == 0 || L == 0) return cudaSuccess;
  const size_t smem = smem_bytes(k, C, tile_l);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        code_conv1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  // rows on x (up to 2^31-1 blocks), L-tiles on y (up to 65535)
  dim3 grid(B, (L + tile_l - 1) / tile_l);
  code_conv1d_kernel<<<grid, kThreads, smem, stream>>>(
      codes, row_stride, table, bias, out, L, k, C, tile_l);
  return cudaGetLastError();
}
