// Fused non-causal self-attention forward with a key-padding mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_attn_kernel` launched by `_fused_attn_fwd_impl`
// (speechflow_tpu/ops/attention.py). It computes, per (batch, head),
//     out = softmax(q k^T / sqrt(dh) + (1 - valid) * (-1e30)) v
// with f32 logits and f32 accumulation, writes the output in the input's type, and
// writes zeros in padded query rows (valid == 0), as the TPU wrapper does.
//
// What bounds it on the H100: at the main path's shapes (T = 1024, dh = 128) the work is
// 4 * T^2 * dh operations per (batch, head) against 4 * T * dh elements moved, about
// 1000 operations per element: it is bound by operations, not bytes. The TPU kernel
// keeps all of K/V of one (batch, head) in VMEM; Hopper's 227 KB of shared memory cannot
// hold that at T = 1024, so both kernels below are flash forwards instead: K/V stream
// through shared memory in tiles past a tile of query rows, and an online softmax
// (running max and sum per row, in f32) keeps the T x T logits out of device memory.
// Both skip the work of padding: a key tile whose keys are all padded is neither loaded
// nor multiplied, and a query tile whose rows are all padded is written as zeros. That is
// exact: a padded key's logit is -1e30, so in a row with at least one valid key its
// weight exp(-1e30 - m) is exactly 0 once the running max m is a real logit, which it is
// from the first tile that holds a valid key on (every tile a kernel skips to has one).
// A row with no valid key is a padded query row, written as zero. So dropping an
// all-padded tile changes no bit of any valid row.
//
// - bfloat16 at dh <= 128 (the serving path): `tc::`, a warp-specialised, persistent
//   flash forward on `wgmma` and TMA. One block an SM walks over work tiles of 128 query
//   rows of one (batch, head): one producer thread issues TMA loads of each work tile's Q
//   and of its 128-key K/V tiles into a two-stage ring (full and empty mbarriers per
//   stage), running ahead into the next work tile while the consumers finish this one,
//   and three more warps count the next work tile's valid keys; two consumer warpgroups
//   of 64 rows each compute S = Q K^T with `wgmma` from shared memory, the masked online
//   softmax in f32 registers (base 2), and O += P V with P, rounded to bf16 as the TPU
//   kernel casts its weights to v's type, fed from registers as wgmma's A operand.
//   `setmaxnreg` moves registers from the producer to the consumers. The output leaves
//   through its own shared buffer and a TMA store, which clips rows past T, while the
//   next work tile starts. Needs dh % 8 == 0 and 16-byte aligned pointers (TMA strides
//   and addresses).
// - float32 at any dh <= 256, and bfloat16 at 128 < dh <= 256 (the XTTS prompt encoder:
//   4 heads of 256): `mma::`, a flash forward on the tensor cores in TF32 at f32
//   accuracy, with `mma.sync.m16n8k8` (design and numbers in the note above it).
//
// Layout: q, k, v and out are (B, T, H, dh), contiguous, the layout the projections
// produce, so no transpose is needed; valid is read in place as bytes (a bool tensor,
// 0 = padded) at valid[b * valid_batch_stride + t * valid_time_stride], so a strided
// view such as mask[:, 0, 0, :] costs no copy. Any T (the tail tile is masked), B * H
// <= 65535 and 1 <= dh <= 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int MAX_DH = 128;       // the wgmma kernel's widest head
constexpr int MAX_DH_WIDE = 256;  // the TF32 kernel's
constexpr int MAX_DEVICES = 64;   // per-device state the launchers ask for once

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; -inf -> +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the current device and its SM count, which is asked once per device
int device_state(int* device, int* sms) {
  static int counts[MAX_DEVICES] = {};
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (*device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (counts[*device] == 0 &&
      (err = cudaDeviceGetAttribute(&counts[*device], cudaDevAttrMultiProcessorCount,
                                    *device)) != cudaSuccess)
    return (int)err;
  *sms = counts[*device];
  return 0;
}

// -- tensor cores in TF32: float32 at any dh <= 256, bfloat16 at 128 < dh <= 256 ---------
//
// Numbers: a TF32 operand keeps 10 of f32's 23 mantissa bits (~3 decimal digits), which
// cannot meet an f32 tolerance of 5e-5 on a dot product of 256 terms. So each f32 operand
// x is split in registers into hi, x rounded to TF32 (to nearest), and lo = x - hi (exact
// in f32, |lo| <= 2^-11 |x|), which the tensor core reads truncated to TF32, within
// 2^-10 |lo|; each product is taken as three TF32 products, hi*hi + hi*lo + lo*hi
// ("3xTF32"): the dropped lo*lo and the truncation of lo leave ~2^-21 of each product,
// about f32's own error. The logits Q K^T and the output P V both take three products. A
// bfloat16 input is exact in TF32 (8 mantissa bits), so its Q K^T is one product, and P
// (kept in f32, the plain version's order) is split into two products against the exact
// V. Logits, softmax and sums stay f32.
//
// What bounds it: operations, three TF32 products at 495 TFLOP/s (0.93 ms at the f32 CFM
// shape, B64 T1024 H6 dh128). On the card the kernel is bound by issuing instructions:
// each warp splits every Q, K and V element it reads (the four warps of a block split the
// same K and V), beside the mma.sync products. Variants timed on the card and dropped:
// `cvt.rna.tf32.f32` for hi and lo (same errors, slower: that instruction compiles to a
// compare-and-select sequence, where the integer rounding below takes two operations);
// 16 accumulator chains instead of 8, and 128-row blocks (no change); Q split once into
// hi and lo in shared memory (8 warps, 218 KB, one block an SM: slower than 4 warps at
// two blocks an SM). ptxas: 196-206 registers, no spills.
//
// Route: `mma.sync.m16n8k8.tf32`, not `wgmma ... .tf32`. wgmma reads a TF32 operand from
// shared memory only K-major, so V would have to be stored transposed and both hi and lo
// copies of every tile kept in shared memory: at dh 256, Q, K and V^T in two copies need
// 128 + 64 + 64 KB at 64 rows and 32 keys, over the 227 KB a block has. With mma.sync the
// fragments are loaded from one f32 copy of each tile and split in registers, at a lower
// peak rate than wgmma's.
//
// Block: 4 warps, 64 query rows (16 a warp), K/V tiles of 32 keys (one 32-bit validity
// word a tile) in a two-stage ring filled by `cp.async` with zero-fill: rows past T and
// columns past dh land as zeros, which add nothing to any product. 16-byte copies where
// rows are 16-byte aligned (f32 with dh % 4 == 0), else 4-byte copies, so any f32 dh and
// H work; a bf16 tile is widened to f32 by ordinary loads (no cp.async of 2 bytes).
// Shared memory: 107.6 KB at dh <= 128 (two blocks an SM), 173 KB at dh 256.
// Fragments are read from shared memory as float4 (LDS.128): within each 16-column chunk
// of Q/K the k index is permuted so that a thread's four consecutive floats are its A
// and B elements of two k-steps, and the 32-column groups of V and O are permuted so that
// a thread's four consecutive V floats are its B elements of four n-tiles; row strides of
// dp + 16 floats (Q, K) and 32 g + 4 (V) keep each quarter-warp's loads on distinct
// banks. The logits' accumulator layout is the A layout of P V as it stands under that
// permutation, so P needs no shuffle.
//
// Work skipped, exactly: each block counts the valid keys of every key tile first (a
// ballot a tile, words kept in shared memory for the first MASK_CAP tiles) and neither
// loads nor multiplies a tile without one; a query tile without a valid row writes zeros
// (why that is exact: the note at the top). Tiles past MASK_CAP are masked but never
// skipped, which is also exact.
//
// Blocks at small shapes: a block holds at most 128 output columns (4 groups of 32, 64 f32
// registers a thread), so dh > 128 is always split across blocks (grid z); when the
// (query tile, batch * head) blocks are fewer than the SMs, the columns are split further,
// down to 32 a block. Each block recomputes S over all of dh and writes its columns: at
// the XTTS prompt's B1 T112 H4 dh256 that is 64 blocks, not 8. `cudaFuncSetAttribute` and
// the SM count are asked once per device; the launch is the only device work.

namespace mma {

constexpr int BM = 64;          // query rows a block: 4 warps of 16
constexpr int BN = 32;          // keys a K/V tile
constexpr int THREADS = 128;
constexpr int MAX_GROUPS = 4;   // 32-column output groups a block holds
constexpr int MASK_CAP = 2048;  // key tiles whose validity words stay in shared memory

template <int DP> __host__ __device__ constexpr int ld_qk() { return DP + 16; }
__host__ __device__ constexpr int ld_v(int groups) { return 32 * groups + 4; }

template <int DP>
size_t smem_bytes(int groups, int n_tiles) {
  return sizeof(float) * (size_t(BM + 2 * BN) * ld_qk<DP>() + size_t(2 * BN) * ld_v(groups)) +
         sizeof(uint32_t) * size_t(std::min(n_tiles, MASK_CAP));
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from zero (what
// `cvt.rna.tf32.f32` gives, in two integer operations instead of the compare-and-select
// sequence that instruction compiles to); lo = x - hi is exact in f32 and goes to the
// tensor core as it is, which reads a TF32 operand's top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, TF32, row-major) B (8 x 8, TF32, column-major). Lane
// (g = lane / 4, c = lane % 4) holds A at (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4),
// B at (k c, n g), (k c + 4, n g), and D at (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [t0, t0 + rows) and columns [c0, c0 + 4 << lg) of one head of x (B, T, H, dh),
// whose head starts at src with rs elements between time steps, into shared memory at
// row stride ld (floats); past T and past dh: zeros. vec: 16-byte copies (f32) or loads
// (bf16) are aligned.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long rs,
                                          int t0, int seq, int rows, int c0, int lg, int dh,
                                          bool vec) {
  if (vec) {  // a thread copies one 16-byte column of every (THREADS >> lg)-th row
    const int c = (threadIdx.x & ((1 << lg) - 1)) * 4, r0 = threadIdx.x >> lg;
    const int step = THREADS >> lg;
    const bool col_in = c0 + c < dh;
    const float* s = src + (t0 + r0) * rs + c0 + c;
    float* d = dst + r0 * ld + c;
    for (int r = r0; r < rows; r += step, s += step * rs, d += step * ld) {
      const bool in = col_in && t0 + r < seq;
      cp_async16(d, in ? s : src, in);
    }
  } else {
    const int n = rows << (lg + 2);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i >> (lg + 2), c = i & ((4 << lg) - 1);
      const int t = t0 + r;
      const bool in = t < seq && c0 + c < dh;
      cp_async4(dst + r * ld + c, in ? src + t * rs + c0 + c : src, in);
    }
  }
}

__device__ __forceinline__ void load_tile(float* dst, int ld, const __nv_bfloat16* src,
                                          long long rs, int t0, int seq, int rows, int c0,
                                          int lg, int dh, bool vec) {
  if (vec) {  // 8 values a load, one column of 8 of every (THREADS >> (lg - 1))-th row
    const int c = (threadIdx.x & ((1 << (lg - 1)) - 1)) * 8, r0 = threadIdx.x >> (lg - 1);
    const int step = THREADS >> (lg - 1);
    const bool col_in = c0 + c < dh;
    for (int r = r0; r < rows; r += step) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (col_in && t0 + r < seq)
        raw = __ldg(reinterpret_cast<const uint4*>(src + (t0 + r) * rs + c0 + c));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
      d[0] = make_float4(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                         __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u));
      d[1] = make_float4(__uint_as_float(w[2] << 16), __uint_as_float(w[2] & 0xffff0000u),
                         __uint_as_float(w[3] << 16), __uint_as_float(w[3] & 0xffff0000u));
    }
  } else {
    const int n = rows << (lg + 2);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i >> (lg + 2), c = i & ((4 << lg) - 1);
      const int t = t0 + r;
      dst[r * ld + c] =
          t < seq && c0 + c < dh ? __bfloat162float(src[t * rs + c0 + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[8], int n, bool vec) {
  if (vec && n == 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = x[i];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[8], int n,
                                       bool vec) {
  if (vec && n == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                                pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else {
    for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16(x[i]);
  }
}

// DP: dh padded to 64, 128 or 256 (Q/K columns held); T: float or bfloat16. groups:
// 32-column output groups a block holds (1, 2 or 4); blockIdx.z picks which.
template <int DP, typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_fwd_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ valid, long long vsb, long long vst,
                     T* __restrict__ out, int seq, int heads, int dh, int groups,
                     float scale_log2, int vec_in, int vec_out) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDK = ld_qk<DP>();
  constexpr int LG_QK = DP == 64 ? 4 : (DP == 128 ? 5 : 6);  // log2(DP / 4)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldv = ld_v(groups);
  const int lg_v = groups == 1 ? 3 : (groups == 2 ? 4 : 5);  // log2(32 groups / 4)
  float* Qs = smem;                   // BM x LDK
  float* Ks = Qs + BM * LDK;          // stage s at Ks + s * BN * LDK
  float* Vs = Ks + 2 * BN * LDK;      // stage s at Vs + s * BN * ldv
  uint32_t* masks = reinterpret_cast<uint32_t*>(Vs + 2 * BN * ldv);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int c0 = blockIdx.z * groups * 32;                     // first output column
  const int n_groups = min(groups, (dh - c0 + 31) / 32);       // groups inside dh
  const long long rs = (long long)heads * dh;
  const long long head = (long long)b * seq * rs + (long long)h * dh;
  const uint8_t* valid_b = valid + b * vsb;
  const int n_tiles = (seq + BN - 1) / BN;
  const int n_masks = min(n_tiles, MASK_CAP);

  load_tile(Qs, LDK, q + head, rs, q0, seq, BM, 0, LG_QK, dh, vec_in);
  cp_async_commit();

  // bit i of masks[j]: key 32 j + i is valid
  for (int j = warp; j < n_masks; j += THREADS / 32) {
    const int t = j * BN + lane;
    const uint32_t w = __ballot_sync(0xffffffffu, t < seq && valid_b[t * vst] != 0);
    if (lane == 0) masks[j] = w;
  }
  const bool row_valid = tid < BM && q0 + tid < seq && valid_b[(q0 + tid) * vst] != 0;
  T* out_h = out + head;
  if (!__syncthreads_or(row_valid)) {  // every query row padded: zeros
    cp_async_wait<0>();
    const float zero[8] = {};
    const int rows = min(BM, seq - q0);
    for (int i = tid; i < rows * n_groups * 4; i += THREADS) {
      const int r = i / (n_groups * 4), c = c0 + (i - r * n_groups * 4) * 8;
      store8(out_h + (q0 + r) * rs + c, zero, min(8, dh - c), vec_out);
    }
    return;
  }

  auto multiplied = [&](int j) { return j >= MASK_CAP || masks[j] != 0; };
  auto next_tile = [&](int j) {
    while (j < n_tiles && !multiplied(j)) ++j;
    return j;
  };
  auto load_kv = [&](int j, int s) {
    load_tile(Ks + s * BN * LDK, LDK, k + head, rs, j * BN, seq, BN, 0, LG_QK, dh, vec_in);
    load_tile(Vs + s * BN * ldv, ldv, v + head, rs, j * BN, seq, BN, c0, lg_v, dh, vec_in);
    cp_async_commit();
  };

  float o[MAX_GROUPS][4][4];
#pragma unroll
  for (int x = 0; x < MAX_GROUPS; ++x)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[x][i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (raw logits)
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums
  const float* q_row = Qs + (warp * 16 + g) * LDK + 4 * qd;

  int j = next_tile(0), s = 0;
  load_kv(j, 0);
  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    if (jn < n_tiles) {
      load_kv(jn, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + s * BN * LDK;
    const float* Vt = Vs + s * BN * ldv;

    // S (16 x 32 a warp) = Q K^T: in chunk kc, lane (g, qd) holds columns 16 kc + 4 qd ..
    // + 3 of rows g, g + 8 of Q and of key g of each 8-key n-tile; k-step st uses the
    // pair 2 st, 2 st + 1 as its k = qd and k = qd + 4, and sums into its own
    // accumulator (sc2[st]): eight independent chains of products, not four, so the
    // tensor cores' latency is hidden. Columns past dh are zeros in Q and K.
    float sc2[2][4][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc2[st][i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      const float4 x0 = *reinterpret_cast<const float4*>(q_row + 16 * kc);
      const float4 x1 = *reinterpret_cast<const float4*>(q_row + 8 * LDK + 16 * kc);
      uint32_t ah[2][4], al[2][4];
      const float qa[2][4] = {{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}};
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (F32) split(qa[st][e], ah[st][e], al[st][e]);
          else ah[st][e] = __float_as_uint(qa[st][e]);  // bf16: exact in TF32
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Kt + (8 * nt + g) * LDK + 16 * kc + 4 * qd);
        const float kb[2][2] = {{kv.x, kv.y}, {kv.z, kv.w}};
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          if constexpr (F32) {
            uint32_t bh0, bl0, bh1, bl1;
            split(kb[st][0], bh0, bl0);
            split(kb[st][1], bh1, bl1);
            mma_tf32(sc2[st][nt], al[st], bh0, bh1);
            mma_tf32(sc2[st][nt], ah[st], bl0, bl1);
            mma_tf32(sc2[st][nt], ah[st], bh0, bh1);
          } else {
            mma_tf32(sc2[st][nt], ah[st], __float_as_uint(kb[st][0]),
                     __float_as_uint(kb[st][1]));
          }
        }
      }
    }
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = sc2[0][i][e] + sc2[1][i][e];

    // the key mask, only where the tile has padded keys or runs past T: a padded key
    // gets -1e30, as the TPU's additive mask gives; a key past the end gets -inf
    uint32_t word;
    if (j < MASK_CAP) {
      word = masks[j];
    } else {
      const int t = j * BN + lane;
      word = __ballot_sync(0xffffffffu, t < seq && valid_b[t * vst] != 0);
    }
    if (word != 0xffffffffu) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * nt + 2 * qd + e;
          if (!((word >> key) & 1u)) {
            const float fill = j * BN + key >= seq ? -INFINITY : -1e30f;
            sc[nt][e] = fill;
            sc[nt][2 + e] = fill;
          }
        }
    }

    // online softmax in f32, base 2: p = 2^((s - m) log2(e) / sqrt(dh))
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: key 0 of a tile is never past T
      alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      const float ms = m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(sc[nt][2 * r + e], scale_log2, -ms));
          sc[nt][2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int x = 0; x < MAX_GROUPS; ++x)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[x][i][e] *= alpha[e / 2];

    // O += P V: k-step kk covers keys 8 kk .. + 7, k = qd and qd + 4 being keys 2 qd and
    // 2 qd + 1, so P's A fragment is the logits' registers (0, 2, 1, 3) of n-tile kk; in
    // group x, lane (g, qd) reads V columns 32 x + 4 g .. + 3 of those two keys, column
    // 4 g + i being n = g of n-tile i
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      uint32_t ph[4], pl[4];
      const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(pa[e], ph[e], pl[e]);
      const float* v0 = Vt + (8 * kk + 2 * qd) * ldv + 4 * g;
#pragma unroll
      for (int x = 0; x < MAX_GROUPS; ++x) {
        if (x < n_groups) {
          const float4 y0 = *reinterpret_cast<const float4*>(v0 + 32 * x);
          const float4 y1 = *reinterpret_cast<const float4*>(v0 + ldv + 32 * x);
          const float vb[2][4] = {{y0.x, y0.y, y0.z, y0.w}, {y1.x, y1.y, y1.z, y1.w}};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (F32) {
              uint32_t bh0, bl0, bh1, bl1;
              split(vb[0][i], bh0, bl0);
              split(vb[1][i], bh1, bl1);
              mma_tf32(o[x][i], pl, bh0, bh1);
              mma_tf32(o[x][i], ph, bl0, bl1);
              mma_tf32(o[x][i], ph, bh0, bh1);
            } else {  // V exact in TF32
              const uint32_t b0 = __float_as_uint(vb[0][i]), b1 = __float_as_uint(vb[1][i]);
              mma_tf32(o[x][i], pl, b0, b1);
              mma_tf32(o[x][i], ph, b0, b1);
            }
          }
        }
      }
    }
    __syncthreads();  // stage s is read: the load two tiles on may refill it
    j = jn;
    s ^= 1;
  }

  // epilogue: O / l, zero in padded query rows; lane (g, qd) holds columns 32 x + 8 qd ..
  // + 7 of rows g, g + 8 (register e % 2 of n-tile i is column 8 qd + 4 (e % 2) + i)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= seq) continue;
    const float keep = valid_b[t * vst] != 0 ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int x = 0; x < MAX_GROUPS; ++x) {
      const int c = c0 + 32 * x + 8 * qd;
      if (x < n_groups && c < dh) {
        float y[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i] = o[x][i][2 * r] * keep;
          y[4 + i] = o[x][i][2 * r + 1] * keep;
        }
        store8(out_h + t * rs + c, y, min(8, dh - c), vec_out);
      }
    }
  }
}

template <int DP, typename T>
int launch_dp(const void* q, const void* k, const void* v, const uint8_t* valid, long long vsb,
              long long vst, void* out, int batch, int seq, int heads, int dh,
              cudaStream_t stream) {
  int device = 0, sms = 0;
  const int status = device_state(&device, &sms);
  if (status != 0) return status;
  // the largest shared memory this instantiation takes, granted once per device
  static bool granted[MAX_DEVICES] = {};
  if (!granted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_tf32_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<DP>(MAX_GROUPS, MASK_CAP));
    if (e != cudaSuccess) return (int)e;
    granted[device] = true;
  }
  const int q_tiles = (seq + BM - 1) / BM;
  const long long blocks = (long long)q_tiles * batch * heads;
  const int n_groups = (dh + 31) / 32;
  // groups a block: a power of two (the V tile's row of 32 groups floats), 3 taking 4
  int groups = std::min(MAX_GROUPS, n_groups == 3 ? 4 : n_groups);
  // fewer blocks than SMs: split the output columns further
  while (groups > 1 && blocks * ((n_groups + groups - 1) / groups) < sms) groups /= 2;
  const dim3 grid(q_tiles, batch * heads, (n_groups + groups - 1) / groups);
  const size_t smem = smem_bytes<DP>(groups, (seq + BN - 1) / BN);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec_width = std::is_same<T, float>::value ? 4 : 8;  // elements in 16 bytes
  const int vec_in = dh % vec_width == 0 && (ptrs & 15u) == 0;
  const int vec_out = dh % vec_width == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  attn_fwd_tf32_kernel<DP, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid, vsb,
      vst, static_cast<T*>(out), seq, heads, dh, groups,
      1.4426950408889634f / sqrtf((float)dh), vec_in, vec_out);  // log2(e) / sqrt(dh)
  return (int)cudaGetLastError();
}

// float32 at dh <= 256 (dtype 0), bfloat16 at 128 < dh <= 256 (dtype 1)
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, long long vsb,
           long long vst, void* out, int batch, int seq, int heads, int dh, int dtype,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_dp<256, __nv_bfloat16>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh,
                                         stream);
  if (dh <= 64)
    return launch_dp<64, float>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh, stream);
  if (dh <= 128)
    return launch_dp<128, float>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh, stream);
  return launch_dp<256, float>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh, stream);
}

}  // namespace mma

// -- bfloat16: wgmma + TMA, warp-specialised --------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;              // query rows per block (two warpgroups of 64)
constexpr int BN = 128;              // keys per K/V tile
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr uint32_t BOX = 64 * 128 * sizeof(bf16);  // one TMA box: 128 rows x 64 columns
constexpr int BAR_BYTES = 128;  // q_full, q_empty, then k_full, v_full, kv_empty,
                                 // cnt_full, cnt_empty two each
static_assert(BM == BN, "a query tile is also a key tile: its mask state is shared");

// shared memory of a block for padded head dim dhp (64 or 128): Q, the outgoing output,
// two stages of K and V, the barriers, and two buffers of one valid-key count a key tile
__host__ __device__ constexpr uint32_t tile_bytes(int dhp) { return (dhp / 64) * BOX; }
size_t smem_bytes(int dhp, int n_tiles) {
  return 1024 + 6 * size_t(tile_bytes(dhp)) + BAR_BYTES + 2 * sizeof(int) * size_t(n_tiles);
}

// -- mbarriers --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of the given parity; a wait that lasts
// seconds is a fault of the pipeline, so it traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 33)) __trap();
}

// -- TMA: 4-D boxes of (dh, H, T, B); coordinates innermost first --

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// -- wgmma --

// Shared-memory matrix descriptor, 128-byte swizzle (the layout TMA's SWIZZLE_128B
// writes: 8 rows x 128 bytes form one 1024-byte atom, 16-byte chunk c of row r stored at
// chunk c ^ (r % 8)). Offsets in bytes. K-major operands: sbo = 1024 between 8-row
// groups, lbo unused. MN-major operands: lbo between 64-element groups along MN (the two
// boxes of a 128-wide head), sbo = 1024 between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8
#undef REGS32
#undef REGS64

// Fragment layouts (warpgroup of 4 warps, warp w owns rows 16w .. 16w + 15; g = lane / 4,
// qd = lane % 4): accumulator register 4j + e of an m64nN product holds row
// 16w + g + 8 (e / 2), column 8j + 2qd + (e % 2). The A register fragment of an m64k16
// product holds rows g and g + 8, columns 2qd, 2qd + 1, 2qd + 8, 2qd + 9 of its 16-wide
// chunk: so two neighbouring 8-column blocks of S, rounded to bf16 and paired, are the
// A operand of P V as they stand.
template <int DHP>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                const uint8_t* __restrict__ valid, long long vsb, long long vst,
                bf16* __restrict__ out, int seq, int heads, int dh, int n_work,
                float scale_log2) {
  constexpr int HALVES = DHP / 64;                 // TMA boxes across the head dim
  constexpr uint32_t TILE = tile_bytes(DHP);
  constexpr int NO = DHP / 2;                      // output accumulator registers
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_addr(smem);            // Q of the current work tile
  const uint32_t s_o = s_q + TILE;                 // the previous output, on its way out
  const uint32_t s_k = s_o + TILE;                 // K stage s at s_k + s * TILE
  const uint32_t s_v = s_k + 2 * TILE;             // V stage s at s_v + s * TILE
  const uint32_t bar = s_v + 2 * TILE;
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto k_full = [&](int s) { return bar + 16 + 8 * s; };
  auto v_full = [&](int s) { return bar + 32 + 8 * s; };
  auto kv_empty = [&](int s) { return bar + 48 + 8 * s; };
  auto cnt_full = [&](int s) { return bar + 64 + 8 * s; };
  auto cnt_empty = [&](int s) { return bar + 80 + 8 * s; };
  const int n_tiles = (seq + BN - 1) / BN;         // key tiles, and query tiles (BM == BN)
  // valid keys of each key tile, two buffers (work tiles k and k + 1)
  int* counts = reinterpret_cast<int*>(smem + 6 * TILE + BAR_BYTES);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 8);
      mbar_init(cnt_full(s), 3);   // the three counting warps
      mbar_init(cnt_empty(s), 9);  // the loading thread and the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: block i takes work tiles i, i + gridDim.x, ...; work tile w is query tile
  // w % n_tiles of (batch, head) w / n_tiles, so the blocks in flight share K/V in L2.
  // While the consumers finish one work tile, the producer already loads the next one's
  // Q and K/V, and three warps count its valid keys.
  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32;
    if (warp == 0) {
      // -- one thread issues every TMA load --
      if (lane != 0) return;
      int n = 0, nq = 0;  // K/V tiles and Q tiles loaded so far
      for (int w = blockIdx.x, k = 0; w < n_work; w += gridDim.x, ++k) {
        const int bh = w / n_tiles, qt = w - bh * n_tiles;
        const int b = bh / heads, h = bh - b * heads;
        mbar_wait(cnt_full(k & 1), (k >> 1) & 1);
        const int* cnt = counts + (k & 1) * n_tiles;
        if (cnt[qt] != 0) {  // else every query row is padded: nothing to load
          if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
          mbar_expect_tx(q_full, TILE);
          for (int x = 0; x < HALVES; ++x)
            tma_load(s_q + x * BOX, &tm_q, q_full, 64 * x, h, qt * BM, b);
          for (int j = 0; j < n_tiles; ++j) {
            if (cnt[j] == 0) continue;  // all keys padded: never loaded
            const int s = n & 1;
            if (n >= 2) mbar_wait(kv_empty(s), ((n >> 1) - 1) & 1);
            mbar_expect_tx(k_full(s), TILE);
            for (int x = 0; x < HALVES; ++x)
              tma_load(s_k + s * TILE + x * BOX, &tm_k, k_full(s), 64 * x, h, j * BN, b);
            mbar_expect_tx(v_full(s), TILE);
            for (int x = 0; x < HALVES; ++x)
              tma_load(s_v + s * TILE + x * BOX, &tm_v, v_full(s), 64 * x, h, j * BN, b);
            ++n;
          }
          ++nq;
        }
        mbar_arrive(cnt_empty(k & 1));
      }
    } else {
      // -- warps 1-3 count the valid keys of each key tile of the next work tiles --
      for (int w = blockIdx.x, k = 0; w < n_work; w += gridDim.x, ++k) {
        if (k >= 2) mbar_wait(cnt_empty(k & 1), ((k >> 1) - 1) & 1);
        const uint8_t* valid_b = valid + (w / n_tiles / heads) * vsb;
        int* cnt = counts + (k & 1) * n_tiles;
        for (int j = warp - 1; j < n_tiles; j += 3) {
          int c = 0;
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int t = j * BN + 32 * i + lane;
            c += t < seq && valid_b[t * vst] != 0;
          }
          c = __reduce_add_sync(0xffffffffu, c);
          if (lane == 0) cnt[j] = c;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(cnt_full(k & 1));
      }
    }
  } else {
    // -- consumer warpgroups: 64 query rows each --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const uint32_t q_rows = s_q + cw * 64 * 128;   // this warpgroup's 64 rows of Q
    int n = 0, nq = 0;

    for (int w = blockIdx.x, k = 0; w < n_work; w += gridDim.x, ++k) {
      const int bh = w / n_tiles, qt = w - bh * n_tiles;
      const int b = bh / heads, h = bh - b * heads;
      const int q0 = qt * BM;
      const uint8_t* valid_b = valid + b * vsb;
      mbar_wait(cnt_full(k & 1), (k >> 1) & 1);
      const int* cnt = counts + (k & 1) * n_tiles;

      if (cnt[qt] == 0) {  // every query row of this tile is padded: zeros
        const long long row_stride = (long long)heads * dh;
        bf16* o_b = out + (long long)b * seq * row_stride + (long long)h * dh;
        const int r0 = q0 + cw * 64;
        const int rows = max(0, min(64, seq - r0));
        for (int i = wtid; i < rows * dh; i += 128) {
          const int r = i / dh;
          o_b[(r0 + r) * row_stride + i - r * dh] = __float2bfloat16(0.f);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(cnt_empty(k & 1));
        continue;
      }
      int last = n_tiles - 1;  // the last key tile multiplied (this query tile's own is one)
      while (cnt[last] == 0) --last;

      float o[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (raw logits)
      float l[2] = {0.f, 0.f};              // this thread's share of the running sums

      mbar_wait(q_full, nq & 1);
      for (int j = 0; j <= last; ++j) {
        const int count = cnt[j];
        if (count == 0) continue;
        const int s = n & 1;
        const uint32_t parity = (n >> 1) & 1;
        const int k0 = j * BN;

        // S (64 x 128) = Q K^T, both K-major; 16-wide steps along the head dim advance
        // 32 bytes inside a 128-byte row, and the second box holds dims 64 .. 127
        float sc[64];
        mbar_wait(k_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
          const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
          wgmma_ss_n128(sc, desc_sw128(q_rows + off, 16, 1024),
                        desc_sw128(s_k + s * TILE + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        if (j == last && lane == 0) mbar_arrive(q_empty);  // this warp is done with Q

        // the key mask, only where the tile has padded keys or runs past T: a padded
        // key gets -1e30, far below any logit, as the TPU's additive mask gives; a key
        // past the end gets -inf
        if (count != BN) {
#pragma unroll
          for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * jb + 2 * qd + e;
              const float fill =
                  key >= seq ? -INFINITY : (valid_b[key * vst] != 0 ? 0.f : -1e30f);
              if (fill != 0.f) {
                sc[4 * jb + e] = fill;
                sc[4 * jb + 2 + e] = fill;
              }
            }
          }
        }

        // online softmax in f32, base 2: p = 2^((s - m) log2(e) / sqrt(dh))
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        float alpha[2], ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a valid key
          alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
          m[r] = m_new;
          ms[r] = m_new * scale_log2;
          l[r] *= alpha[r];
        }
        uint32_t pa[32];
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int r = (i / 2) % 2;
          const float p0 = fast_exp2(fmaf(sc[i], scale_log2, -ms[r]));
          const float p1 = fast_exp2(fmaf(sc[i + 1], scale_log2, -ms[r]));
          l[r] += p0 + p1;
          pa[i / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

        // O (64 x DHP) += P V; V is MN-major (keys x dims, dims contiguous): 16 keys are
        // 2048 bytes, the second box of dims sits one box further (lbo)
        mbar_wait(v_full(s), parity);
        reg_fence(o);
        reg_fence(pa);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc)
          wgmma_rs(o, pa + 4 * kc, desc_sw128(s_v + s * TILE + kc * 2048, BOX, 1024));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o);
        reg_fence(pa);  // P stays in its registers until the product has read it
        if (lane == 0) mbar_arrive(kv_empty(s));  // this warp is done with the stage
        ++n;
      }
      if (lane == 0) mbar_arrive(cnt_empty(k & 1));
      ++nq;

      // epilogue: O / l (zero in padded query rows), as bf16, into this warpgroup's rows
      // of the output buffer in the swizzled layout, once the previous store has read
      // them, then one TMA store per box (rows past T and dims past dh are clipped)
      if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = cw * 64 + warp * 16 + g + 8 * r;   // row in the block's tile
        const int t = q0 + row;
        const float keep = (t < seq && valid_b[t * vst] != 0) ? 1.f / l[r] : 0.f;
#pragma unroll
        for (int jb = 0; jb < DHP / 8; ++jb) {
          const uint32_t addr =
              TILE + (jb / 8) * BOX + row * 128 + (((jb % 8) ^ (row % 8)) * 16) + 4 * qd;
          *reinterpret_cast<uint32_t*>(smem + addr) =
              pack_bf16(o[4 * jb + 2 * r] * keep, o[4 * jb + 2 * r + 1] * keep);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      if (wtid == 0 && q0 + cw * 64 < seq) {
        for (int x = 0; x < HALVES; ++x)
          tma_store(&tm_o, s_o + cw * 64 * 128 + x * BOX, 64 * x, h, q0 + cw * 64, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has already loaded
// into the process: looked up there, so this library links only the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// (B, T, H, dh) bf16 as a 4-D tensor map, boxes of 64 dims x 1 head x rows x 1 batch,
// 128-byte swizzle; reads outside the tensor are zero-filled, writes outside are dropped
bool encode(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int dh,
            int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = sizeof(bf16);
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(heads), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {dh * es, cuuint64_t(heads) * dh * es,
                                 cuuint64_t(seq) * heads * dh * es};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DHP>
int launch_dhp(const void* q, const void* k, const void* v, const uint8_t* valid, long long vsb,
               long long vst, void* out, int batch, int seq, int heads, int dh,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, q, batch, seq, heads, dh, BM) || !encode(&tk, k, batch, seq, heads, dh, BN) ||
      !encode(&tv, v, batch, seq, heads, dh, BN) || !encode(&to, out, batch, seq, heads, dh, 64))
    return (int)cudaErrorInvalidValue;
  // the largest shared memory granted so far, per device, asked once and not at every
  // launch: at the encoder's shape the kernel itself is shorter than the host's work
  // around a launch
  static size_t granted[MAX_DEVICES] = {};
  int device = 0, sms = 0;
  int status = device_state(&device, &sms);
  if (status != 0) return status;
  const int n_tiles = (seq + BN - 1) / BN;
  const size_t smem = smem_bytes(DHP, n_tiles);
  if (smem > granted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[device] = smem;
  }
  const long long n_work = (long long)n_tiles * batch * heads;
  if (n_work > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)std::min<long long>(n_work, sms);  // a persistent block an SM
  attn_fwd_kernel<DHP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, to, valid, vsb, vst, static_cast<bf16*>(out), seq, heads, dh, (int)n_work,
      1.4426950408889634f / sqrtf((float)dh));  // log2(e) / sqrt(dh)
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const uint8_t* valid, long long vsb,
           long long vst, void* out, int batch, int seq, int heads, int dh,
           cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dh % 8 != 0 || (ptrs & 15u) != 0) return (int)cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_dhp<64>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh, stream);
  return launch_dhp<128>(q, k, v, valid, vsb, vst, out, batch, seq, heads, dh, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; valid: bytes (0 = padded) at
// valid[b * valid_batch_stride + t * valid_time_stride]. Returns the cudaError_t of the
// launch.
extern "C" int sf_attention_fwd(const void* q, const void* k, const void* v,
                                const void* valid, long long valid_batch_stride,
                                long long valid_time_stride, void* out, int batch, int seq,
                                int heads, int dh, int dtype, void* stream) {
  if (dh < 1 || dh > MAX_DH_WIDE || seq < 1 || batch < 1 || heads < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vb = static_cast<const uint8_t*>(valid);
  if (dtype == 1 && dh <= MAX_DH)
    return tc::launch(q, k, v, vb, valid_batch_stride, valid_time_stride, out, batch, seq,
                      heads, dh, s);
  return mma::launch(q, k, v, vb, valid_batch_stride, valid_time_stride, out, batch, seq,
                     heads, dh, dtype, s);
}
