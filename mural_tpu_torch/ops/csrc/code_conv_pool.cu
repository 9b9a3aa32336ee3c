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
//
// Replaces the Pallas TPU kernels of mural_tpu/ops/fused_train_stem.py:
// K2 the call at :339 (_win_pool_fwd_impl, body _fwd_kernel) and K3 the
// call at :375 (_win_pool_bwd_impl, body _bwd_kernel).  Those fed a
// lane-padded window-code array and a placement-expanded table to the
// MXU; here blocks gather table rows from shared memory instead, in true
// float32 and without a matrix product.
//
// Two modes, as the Pallas kernels' `split`: float32 (pooled and g
// float32, the table exact) and bf16, the single-pass mode of --bf16
// training (split=False): K2 rounds each table entry to bfloat16 (round
// to nearest even) as it stages the table, sums the taps and adds the
// float32 bias in float32, and stores pooled as bfloat16, the layer's
// cast folded into the store; K3 reads a bfloat16 g (the gradient of a
// bfloat16 output) and accumulates in float32.  Both kernels are
// templates on the element type of pooled and g.
//
// Bound: bytes, for both.  K2 reads B*L code bytes and writes B*C*P*
// (E+1) bytes (pooled of E = 4 or 2 bytes, uint8 jstar); K3 reads the
// codes and those bytes of g and jstar and writes (k, 16, C) floats.  Their adds
// are far below the card's float32 rate.  Three things hold them back
// from that bound instead, and the design answers each:
//
// 1. Shared-memory traffic per output.  K2 gathers one table row per
//    conv position and tap: 4 bytes per (position, tap, channel), more
//    than the device-memory bytes.  A K2 thread owns V adjacent channels
//    (V = 4 when C % 4 == 0, else 1; a template parameter) of a run of W
//    pool windows: it reads table rows as float4 (8 threads cover a
//    32-channel row, conflict-free), keeps V maxima and argmaxes in
//    registers, and for k == 3 slides the codes through registers, so
//    that each conv position reads one code byte.  Pool padding is in
//    the bounds of the window loop, not inside it.  K3 adds g into
//    private shared-memory slab columns: for k == 3 a pair's three slab
//    rows are distinct, so it loads all three before storing, and it
//    loads the next pair's g and jstar before this pair's stores.
// 2. Latency of the staging loads.  Every tile a block needs (the table,
//    each row's codes, K3's g and jstar) comes in by 16-byte cp.async
//    copies of the aligned chunks that cover it, all in flight at once;
//    the shared copy keeps the source's misalignment, so both sides of
//    each chunk line up.  Codes become the sentinel-padded ext codes in
//    one shared-to-shared pass.  K2 writes its whole-row tiles with
//    16-byte stores, the ragged ends element by element.
// 3. A small grid at the training batch (B=128).  The launch plan
//    (stem_launch_plan in fused_train_stem.py) cuts a call into pieces
//    of R whole rows, or at small B (row, P-tile) pieces, so that a call
//    has at least one piece per SM at B=128 and a few per SM at B=2048,
//    within 227 KB of shared memory.  K2 runs one block per piece and
//    stages the table once for its R rows.  K3 runs at most two blocks
//    per SM, each walking several pieces into its slabs, so the blocks
//    write few (k, 16, C) partials; reduce_partials_kernel then sums
//    them with 32 warps per 32 adjacent outputs.
//
// Exactness.  K2 sums each output's taps in order from tap 0, then adds
// the bias, then takes the max (strict '>': the first max wins), as the
// plain version does: max abs error 0 and identical jstar.  K3 uses no
// float atomics: slab columns have one owner thread, groups fold in
// order, and the reduce sums partials in a fixed order (warp w takes
// partials w, w + 32, ...; warp 0 adds the warp sums in order), so two
// runs give bit-identical dtable.  In the bf16 mode K2 rounds the same
// table entries and runs the same sums as the plain version's bf16 mode,
// so pooled (after the one rounding to bfloat16) and jstar are equal to
// it, and K3 adds the same float32 values of g.
//
// Built with nvcc into a shared library with a plain C entry point and
// loaded through ctypes (mural_tpu_torch/ops/fused_train_stem.py).

#include <cuda_bf16.h>

#include "stem.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(x);
  else
    return x;
}

constexpr int kRedWarps = 32;          // warps per reduce block

// Shared-memory layout of one block, in bytes; the same formula as
// _smem_bytes in fused_train_stem.py (the launchers check that they agree).
// E is the element size of pooled and g (4, or 2 in the bf16 mode).
//   K2: table, bias | pooled tile (+16 bytes of shift) | jstar tile (+16
//       bytes) | raw code spans | ext codes
//   K3: groups slabs | g segments | jstar segments | raw code spans | ext
struct Layout {
  long long out, js, raw, ext, total;  // offsets of the regions, size
  int seg_g, seg_j, raw_stride;        // K3 tile segment strides; code rows
  __host__ __device__ Layout(int k, int C, int R, int TP, int pk,
                             int groups, bool backward, int E) {
    const int per = 16 / E;            // elements per 16 bytes
    const long long slab = (long long)k * kCodes * C;
    const long long n = (long long)R * C * TP;
    const int n_ext = TP * pk + k - 1;
    raw_stride = (int)round_up(n_ext + 15, 16);
    if (backward) {
      seg_g = (int)round_up(E * TP + 15, 16);
      seg_j = (int)round_up(TP + 15, 16);
      out = 4 * groups * slab;
      js = out + (long long)R * C * seg_g;
      raw = js + (long long)R * C * seg_j;
    } else {
      seg_g = seg_j = 0;
      out = 4 * (slab + round_up(C, 4));
      js = out + E * round_up(n + per, per);
      raw = js + round_up(n + 16, 16);
    }
    ext = raw + (long long)R * raw_stride;
    total = ext + (long long)R * n_ext;
  }
};

// The reverse for one run: dst[e] (device memory) = src[sh + e] for the
// n elements of a run, sh = dst's misalignment in elements, src 16-byte
// aligned: 16-byte stores inside, element stores at the ragged ends.
template <typename T>
__device__ void store_run(T* dst, const T* src, long long n) {
  constexpr int per = 16 / sizeof(T);
  const int sh = low4(dst) / sizeof(T);
  const long long head = min((long long)((per - sh) % per), n);
  const long long chunks = (n - head) / per;
  const long long tail = head + chunks * per;
  for (long long q = threadIdx.x; q < chunks; q += blockDim.x)
    *reinterpret_cast<uint4*>(dst + head + q * per) =
        *reinterpret_cast<const uint4*>(src + sh + head + q * per);
  for (long long e = threadIdx.x; e < head; e += blockDim.x)
    dst[e] = src[sh + e];
  for (long long e = tail + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = src[sh + e];
}

// The codes that a piece needs: ext[b0 + r, p0*pk + t] for t < n_ext is
// codes[b0 + r, l0 + t], l0 = p0*pk - lo, inside [0, L), else the
// sentinel.  load() starts the copy of each row's span [l_lo, l_hi) of
// codes; to_ext(), after the wait and a barrier, writes s_ext.
struct CodeRows {
  const uint8_t* codes;
  long long row_stride;
  int b0, nr, l0, l_lo, l_hi, n_ext, L;

  __device__ CodeRows(const uint8_t* codes_, long long row_stride_, int b0_,
                      int nr_, int p0, int pk, int lo, int n_ext_, int L_)
      : codes(codes_), row_stride(row_stride_), b0(b0_), nr(nr_),
        l0(p0 * pk - lo), n_ext(n_ext_), L(L_) {
    l_lo = max(0, l0);
    l_hi = min(L, l0 + n_ext);
  }

  __device__ const uint8_t* row(int r) const {
    return codes + (long long)(b0 + r) * row_stride + l_lo;
  }

  __device__ void load(unsigned char* raw, int raw_stride) const {
    load_cover(raw, raw_stride, row(0), row_stride, nr, l_hi - l_lo);
  }

  __device__ void to_ext(uint8_t* s_ext, const unsigned char* raw,
                         int raw_stride) const {
    for (int t = threadIdx.x; t < nr * n_ext; t += blockDim.x) {
      const int r = t / n_ext;
      const int l = l0 + t - r * n_ext;
      // "& 15" keeps any out-of-range code inside the 16-row table
      s_ext[t] = (l >= 0 && l < L)
                     ? (raw[r * raw_stride + low4(row(r)) + l - l_lo] & 15)
                     : kSentinel;
    }
  }
};

// Block blockIdx.x = rb * n_pt + pt owns rows [rb*R, rb*R + R) and
// windows [pt*TP, pt*TP + TP) (clipped to B and P); a thread owns V
// channels of a run of W windows of one row.
template <int V, int K, typename TOut>
__global__ void __launch_bounds__(kMaxThreads) code_conv_pool_fwd_kernel(
    const uint8_t* __restrict__ codes, long long row_stride,
    const float* __restrict__ table, const float* __restrict__ bias,
    TOut* __restrict__ pooled, uint8_t* __restrict__ jstar, int B, int L,
    int k, int C, int pk, int pp, int P, int R, int TP, int W) {
  constexpr int E = sizeof(TOut);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(k, C, R, TP, pk, 0, false, E);
  const int slab_n = k * kCodes * C;
  float* s_table = reinterpret_cast<float*>(smem);
  float* s_bias = s_table + slab_n;
  TOut* s_out = reinterpret_cast<TOut*>(smem + lay.out);
  uint8_t* s_js = smem + lay.js;
  uint8_t* s_ext = smem + lay.ext;

  const int n_pt = (P + TP - 1) / TP;
  const int rb = blockIdx.x / n_pt;
  const int pt = blockIdx.x - rb * n_pt;
  const int b0 = rb * R, nr = min(R, B - b0);
  const int p0 = pt * TP, np = min(TP, P - p0);
  const bool whole = n_pt == 1;        // the rows' tiles are one run
  const int n_ext = TP * pk + k - 1;

  stage(s_table, table, slab_n);
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_bias[i] = bias[i];
  const CodeRows rows(codes, row_stride, b0, nr, p0, pk, pp + (k - 1) / 2,
                      n_ext, L);
  rows.load(smem + lay.raw, lay.raw_stride);
  const long long out0 = (long long)b0 * C * P;
  const int sh_o = whole ? low4(pooled + out0) / E : 0;
  const int sh_j = whole ? low4(jstar + out0) : 0;
  cp_async_wait_all();
  __syncthreads();
  rows.to_ext(s_ext, smem + lay.raw, lay.raw_stride);
  if constexpr (E == 2)                // the bf16 mode's rounded table
    for (int i = threadIdx.x; i < slab_n; i += blockDim.x)
      s_table[i] = __bfloat162float(__float2bfloat16_rn(s_table[i]));
  __syncthreads();

  const int CG = C / V;
  const int nw = (np + W - 1) / W;
  for (int u = threadIdx.x; u < nr * nw * CG; u += blockDim.x) {
    const int rw = u / CG;
    const int c = (u - rw * CG) * V;
    const int r = rw / nw;
    const int w = rw - r * nw;
    const uint8_t* ext = s_ext + r * n_ext;
    const float* tab = s_table + c;
    float bv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) bv[v] = s_bias[c + v];
    Taps<V, K> taps;
    int have = -1;                     // position whose codes are loaded
    const int lp_end = min(np, (w + 1) * W);
    for (int lp = w * W; lp < lp_end; ++lp) {
      const int i0 = (p0 + lp) * pk;   // pool-padded index of j == 0
      const int jlo = max(0, pp - i0), jhi = min(pk, L + pp - i0);
      const int base = lp * pk;        // its index in the staged ext
      float best[V], acc[V];
      int bj[V];
      if (jhi > jlo) {
        if (base + jlo != have) taps.start(ext, base + jlo);
        taps.conv(ext, base + jlo, tab, C, k, bv, best);
#pragma unroll
        for (int v = 0; v < V; ++v) bj[v] = jlo;
        for (int j = jlo + 1; j < jhi; ++j) {
          taps.conv(ext, base + j, tab, C, k, bv, acc);
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (acc[v] > best[v]) {    // first max wins ties
              best[v] = acc[v];
              bj[v] = j;
            }
        }
        have = base + jhi;
      } else {                         // no valid position (L == 0)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          best[v] = __int_as_float((int)0xff800000);   // -inf
          bj[v] = 0;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int idx = (r * C + c + v) * TP + lp;
        s_out[sh_o + idx] = from_float<TOut>(best[v]);
        s_js[sh_j + idx] = (uint8_t)bj[v];
      }
    }
  }
  __syncthreads();

  if (whole) {                         // TP == P: (nr, C, P) in one run
    store_run(pooled + out0, s_out, (long long)nr * C * P);
    store_run(jstar + out0, s_js, (long long)nr * C * P);
  } else {
    for (int i = threadIdx.x; i < nr * C * np; i += blockDim.x) {
      const int rc = i / np;
      const int lp = i - rc * np;
      const long long o = ((long long)b0 * C + rc) * P + p0 + lp;
      pooled[o] = s_out[rc * TP + lp];
      jstar[o] = s_js[rc * TP + lp];
    }
  }
}

// Pieces as the forward's blocks; block blockIdx.x walks pieces
// blockIdx.x, blockIdx.x + gridDim.x, ...  blockDim.x = groups * ct:
// thread (grp, t) owns columns t, t + ct, ... of slab grp and walks
// group grp's run of each piece's (row, window) pairs.  Writes the
// block's (k, 16, C) partial.
template <int K, typename TG>
__global__ void __launch_bounds__(kMaxThreads) code_conv_pool_bwd_kernel(
    const uint8_t* __restrict__ codes, long long row_stride,
    const uint8_t* __restrict__ jstar, const TG* __restrict__ g,
    float* __restrict__ partial, int B, int L, int k, int C, int pk,
    int pp, int P, int R, int TP, int groups) {
  constexpr int E = sizeof(TG);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(k, C, R, TP, pk, groups, true, E);
  const int slab_n = k * kCodes * C;
  float* s_part = reinterpret_cast<float*>(smem);
  unsigned char* s_g = smem + lay.out;
  uint8_t* s_js = smem + lay.js;
  uint8_t* s_ext = smem + lay.ext;

  float4* s_part4 = reinterpret_cast<float4*>(s_part);
  for (int i = threadIdx.x; i < groups * slab_n / 4; i += blockDim.x)
    s_part4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_pt = (P + TP - 1) / TP;
  const int n_pieces = (B + R - 1) / R * n_pt;
  const int n_ext = TP * pk + k - 1;
  const int ct = blockDim.x / groups;
  const int grp = threadIdx.x / ct;
  const unsigned char* gb = reinterpret_cast<const unsigned char*>(g);
  for (int piece = blockIdx.x; piece < n_pieces; piece += gridDim.x) {
    const int rb = piece / n_pt;
    const int pt = piece - rb * n_pt;
    const int b0 = rb * R, nr = min(R, B - b0);
    const int p0 = pt * TP, np = min(TP, P - p0);
    const long long in0 = (long long)b0 * C * P + p0;
    if (n_pt == 1) {                   // TP == P: (nr, C, P) in one run
      load_cover(s_g, 0, gb + E * in0, 0, 1, E * nr * C * P);
      load_cover(s_js, 0, jstar + in0, 0, 1, nr * C * P);
    } else {                           // nr * C segments of np windows
      load_cover(s_g, lay.seg_g, gb + E * in0, (long long)E * P, nr * C,
                 E * np);
      load_cover(s_js, lay.seg_j, jstar + in0, P, nr * C, np);
    }
    const CodeRows rows(codes, row_stride, b0, nr, p0, pk,
                        pp + (k - 1) / 2, n_ext, L);
    rows.load(smem + lay.raw, lay.raw_stride);
    cp_async_wait_all();
    __syncthreads();
    rows.to_ext(s_ext, smem + lay.raw, lay.raw_stride);
    __syncthreads();

    const int n_pairs = nr * np;
    const int per = (n_pairs + groups - 1) / groups;
    const int q0 = min(n_pairs, grp * per), q1 = min(n_pairs, q0 + per);
    for (int c = threadIdx.x - grp * ct; c < C; c += ct) {
      float* slab = s_part + grp * slab_n + c;
      // byte offsets of (row r, channel c)'s g and jstar windows
      auto g_at = [&](int r) {
        const long long e = in0 + ((long long)r * C + c) * P;
        return n_pt == 1 ? low4(gb + E * in0) + E * (r * C + c) * P
                         : (r * C + c) * lay.seg_g + low4(gb + E * e);
      };
      auto j_at = [&](int r) {
        const long long e = in0 + ((long long)r * C + c) * P;
        return n_pt == 1 ? low4(jstar + in0) + (r * C + c) * P
                         : (r * C + c) * lay.seg_j + low4(jstar + e);
      };
      int r = q0 / np, lp = q0 - r * np;
      int go = g_at(r), jo = j_at(r);
      float gv = 0.f;
      int js = 0;
      if (q0 < q1) {
        gv = to_float(*reinterpret_cast<const TG*>(s_g + go + E * lp));
        js = s_js[jo + lp];
      }
      for (int q = q0; q < q1; ++q) {
        const uint8_t* e = s_ext + r * n_ext + lp * pk + js;
        const float gq = gv;
        // the next pair's g and jstar, loaded before this pair's stores
        if (++lp == np) {
          lp = 0;
          ++r;
          go = g_at(r);
          jo = j_at(r);
        }
        if (q + 1 < q1) {
          gv = to_float(*reinterpret_cast<const TG*>(s_g + go + E * lp));
          js = s_js[jo + lp];
        }
        if constexpr (K > 0) {
          // taps hit distinct slab rows kk*16 + code: all K loads first
          int a[K];
          float v[K];
#pragma unroll
          for (int kk = 0; kk < K; ++kk) a[kk] = (kk * kCodes + e[kk]) * C;
#pragma unroll
          for (int kk = 0; kk < K; ++kk) v[kk] = slab[a[kk]];
#pragma unroll
          for (int kk = 0; kk < K; ++kk) slab[a[kk]] = v[kk] + gq;
        } else {
          for (int kk = 0; kk < k; ++kk)
            slab[(kk * kCodes + e[kk]) * C] += gq;
        }
      }
    }
    __syncthreads();                   // before the next piece's tiles
  }

  // fold the group slabs in group order into this block's partial
  float* out = partial + (long long)blockIdx.x * slab_n;
  for (int i = threadIdx.x; i < slab_n; i += blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += s_part[gi * slab_n + i];
    out[i] = s;
  }
}

// dtable[i] = sum over blocks of partial[blk, i], in a fixed order:
// warp w sums blocks w, w + kRedWarps, ... for 32 adjacent outputs
// (each load coalesced), then warp 0 adds the warps' sums in warp order.
__global__ void __launch_bounds__(kRedWarps * 32) reduce_partials_kernel(
    const float* __restrict__ partial, float* __restrict__ dtable,
    int n_blocks, int n) {
  __shared__ float s[kRedWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int blk = w; blk < n_blocks; blk += kRedWarps)
      acc += partial[(long long)blk * n + i];
  }
  s[w][lane] = acc;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int ww = 0; ww < kRedWarps; ++ww) t += s[ww][lane];
    dtable[i] = t;
  }
}

cudaError_t set_smem(const void* kernel, long long smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// The shared memory that the caller's plan gives must be the one this
// file derives from (R, TP): a mismatch is refused.
bool plan_ok(int B, int P, int R, int TP, long long smem,
             const Layout& lay) {
  return R >= 1 && R <= B && TP >= 1 && TP <= P && smem == lay.total;
}

long long n_pieces(int B, int P, int R, int TP) {
  return (long long)((B + R - 1) / R) * ((P + TP - 1) / TP);
}

template <int V, int K, typename TOut>
cudaError_t launch_fwd(const uint8_t* codes, long long row_stride,
                       const float* table, const float* bias, TOut* pooled,
                       uint8_t* jstar, int B, int L, int k, int C, int pk,
                       int pp, int P, int R, int TP, int W, int grid,
                       int threads, long long smem, cudaStream_t stream) {
  const void* kernel = (const void*)code_conv_pool_fwd_kernel<V, K, TOut>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  code_conv_pool_fwd_kernel<V, K, TOut><<<grid, threads, smem, stream>>>(
      codes, row_stride, table, bias, pooled, jstar, B, L, k, C, pk, pp, P,
      R, TP, W);
  return cudaGetLastError();
}

// K2 on pooled elements of type TOut: the channel vector width V and
// the unrolled kernel size K for this call
template <typename TOut>
cudaError_t fwd_for(const uint8_t* codes, long long row_stride,
                    const float* table, const float* bias, void* pooled,
                    uint8_t* jstar, int B, int L, int k, int C, int pk,
                    int pp, int P, int R, int TP, int W, int grid,
                    int threads, long long smem, cudaStream_t stream) {
  TOut* out = static_cast<TOut*>(pooled);
  const bool vec = C % 4 == 0;
  if (k == 3)
    return vec ? launch_fwd<4, 3>(codes, row_stride, table, bias, out,
                                  jstar, B, L, k, C, pk, pp, P, R, TP, W,
                                  grid, threads, smem, stream)
               : launch_fwd<1, 3>(codes, row_stride, table, bias, out,
                                  jstar, B, L, k, C, pk, pp, P, R, TP, W,
                                  grid, threads, smem, stream);
  return vec ? launch_fwd<4, 0>(codes, row_stride, table, bias, out, jstar,
                                B, L, k, C, pk, pp, P, R, TP, W, grid,
                                threads, smem, stream)
             : launch_fwd<1, 0>(codes, row_stride, table, bias, out, jstar,
                                B, L, k, C, pk, pp, P, R, TP, W, grid,
                                threads, smem, stream);
}

// K3 on g elements of type TG, then the fixed-order reduce
template <typename TG>
cudaError_t bwd_for(const uint8_t* codes, long long row_stride,
                    const uint8_t* jstar, const void* g, float* partial,
                    float* dtable, int B, int L, int k, int C, int pk,
                    int pp, int P, int R, int TP, int groups, int threads,
                    int grid, long long smem, cudaStream_t stream) {
  const int n = k * kCodes * C;
  const TG* gt = static_cast<const TG*>(g);
  const void* kernel = k == 3
                           ? (const void*)code_conv_pool_bwd_kernel<3, TG>
                           : (const void*)code_conv_pool_bwd_kernel<0, TG>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (k == 3)
    code_conv_pool_bwd_kernel<3, TG><<<grid, threads, smem, stream>>>(
        codes, row_stride, jstar, gt, partial, B, L, k, C, pk, pp, P, R, TP,
        groups);
  else
    code_conv_pool_bwd_kernel<0, TG><<<grid, threads, smem, stream>>>(
        codes, row_stride, jstar, gt, partial, B, L, k, C, pk, pp, P, R, TP,
        groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(n + 31) / 32, kRedWarps * 32, 0, stream>>>(
      partial, dtable, grid, n);
  return cudaGetLastError();
}

}  // namespace

// codes: (B, L) uint8, row stride row_stride, unit column stride;
// table: (k, 16, C) float32; bias: (C,) float32; pooled: (B, C, P)
// float32, or bfloat16 when bf16 != 0 (the single-pass mode), and
// jstar: (B, C, P) uint8, both contiguous.  (R, TP, W, grid, threads,
// smem) is the launch plan (stem_launch_plan).  Launches on `stream`
// and returns the launch status; it does not synchronise.
extern "C" cudaError_t code_conv_pool_fwd_launch(
    const uint8_t* codes, long long row_stride, const float* table,
    const float* bias, void* pooled, uint8_t* jstar, int B, int L, int k,
    int C, int pk, int pp, int P, int R, int TP, int W, int grid,
    int threads, long long smem, int bf16, cudaStream_t stream) {
  if (B == 0 || P == 0) return cudaSuccess;
  if (pk > 255 || W < 1 || threads < 1 || threads > kMaxThreads)
    return cudaErrorInvalidValue;      // jstar is uint8
  const int E = bf16 ? 2 : 4;
  if (!plan_ok(B, P, R, TP, smem, Layout(k, C, R, TP, pk, 0, false, E))
      || grid != n_pieces(B, P, R, TP))
    return cudaErrorInvalidValue;
  return bf16 ? fwd_for<__nv_bfloat16>(codes, row_stride, table, bias,
                                       pooled, jstar, B, L, k, C, pk, pp, P,
                                       R, TP, W, grid, threads, smem, stream)
              : fwd_for<float>(codes, row_stride, table, bias, pooled,
                               jstar, B, L, k, C, pk, pp, P, R, TP, W, grid,
                               threads, smem, stream);
}

// codes as above; jstar and g: (B, C, P) contiguous, g float32 or, when
// bf16 != 0, bfloat16; partial: scratch of grid * k*16*C float32;
// dtable: (k, 16, C) float32.  (R, TP, groups, threads, grid, smem) is
// the launch plan; the pair runs, and so the summation order, depend
// only on the plan and the shapes.
extern "C" cudaError_t code_conv_pool_bwd_launch(
    const uint8_t* codes, long long row_stride, const uint8_t* jstar,
    const void* g, float* partial, float* dtable, int B, int L, int k,
    int C, int pk, int pp, int P, int R, int TP, int groups, int threads,
    int grid, long long smem, int bf16, cudaStream_t stream) {
  if (B == 0 || P == 0 || groups < 1 || threads > kMaxThreads
      || threads % groups != 0)
    return cudaErrorInvalidValue;
  const Layout lay(k, C, R, TP, pk, groups, true, bf16 ? 2 : 4);
  if (!plan_ok(B, P, R, TP, smem, lay) || grid < 1
      || grid > n_pieces(B, P, R, TP))
    return cudaErrorInvalidValue;
  return bf16 ? bwd_for<__nv_bfloat16>(codes, row_stride, jstar, g, partial,
                                       dtable, B, L, k, C, pk, pp, P, R, TP,
                                       groups, threads, grid, smem, stream)
              : bwd_for<float>(codes, row_stride, jstar, g, partial, dtable,
                               B, L, k, C, pk, pp, P, R, TP, groups, threads,
                               grid, smem, stream);
}
