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
// hold that at T = 1024, so both paths below are flash forwards instead: K/V stream
// through shared memory in tiles past a tile of query rows, and an online softmax
// (running max and sum per row, in f32) keeps the T x T logits out of device memory.
//
// - bfloat16 (the serving path): a warp-specialised, persistent flash forward on `wgmma`
//   and TMA. One block an SM walks over work tiles of 128 query rows of one (batch,
//   head): one producer thread issues TMA loads of each work tile's Q and of its 128-key
//   K/V tiles into a two-stage ring (full and empty mbarriers per stage), running ahead
//   into the next work tile while the consumers finish this one, and three more warps
//   count the next work tile's valid keys; two consumer warpgroups of 64 rows each compute
//   S = Q K^T with `wgmma` from shared memory, the masked online softmax in f32
//   registers (base 2), and O += P V with P, rounded to bf16 as the TPU kernel casts its
//   weights to v's type, fed from registers as wgmma's A operand. `setmaxnreg` moves
//   registers from the producer to the consumers. Key tiles whose keys are all padded
//   are neither loaded nor multiplied, and a query tile whose rows are all padded
//   is written as zeros; both are exact (module note below). The output leaves
//   through its own shared buffer and a TMA store, which clips rows past T, while the
//   next work tile starts. Persistence hides each work tile's first loads and last
//   store, which a block an SM (its shared memory allows one) would otherwise expose.
//   Needs dh % 8 == 0 and 16-byte aligned pointers (TMA strides and addresses).
// - float32: the arithmetic runs on the CUDA cores in f32 (FMA), one block per (64-row
//   query tile, batch * head), which caps it at the f32 rate (67 TFLOP/s) but keeps
//   full f32 logits.
// - 128 < dh <= 256, float32 and bfloat16 (the XTTS prompt encoder: 4 heads of 256 at
//   width 1024, T <= 112): the same CUDA-core kernel with 16 output columns a thread.
//   A bf16 input is widened to f32 as it is loaded and the output rounded once, so
//   P stays f32 (the plain version's order). Why not the wgmma kernel: at dh 128 its
//   consumers already hold 232 registers a thread, and a 64 x 256 f32 output tile
//   would add 128 more. At the prompt encoder's shapes the work is a few MFLOP a
//   launch, so the launch, not the arithmetic, is what the card waits for.
//
// Layout: q, k, v and out are (B, T, H, dh), contiguous, the layout the projections
// produce, so no transpose is needed; valid is (B, T) f32 0/1. Any T (the tail tile is
// masked) and 1 <= dh <= 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_DH = 128;       // the wgmma kernel's and the f32 kernel's widest head
constexpr int MAX_DH_WIDE = 256;  // the wide CUDA-core kernel's

// -- CUDA cores: float32 at dh <= 128, both types at 128 < dh <= 256 --------------------

namespace simt {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // keys per shared-memory tile
constexpr int THREADS = 256; // 16 row groups x 16 lanes
constexpr int ROWS = BQ / 16;          // query rows per thread (4)
constexpr int SCOLS = BK / 16;         // logits columns per thread (2)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int dh) {
  const int ld = dh + 1;  // +1 float of padding: rows land on different banks
  return sizeof(float) * (size_t(BQ) * ld + size_t(BK) * ld + size_t(BK) * dh +
                          size_t(BQ) * (BK + 1) + BK);
}

// MAXD: the widest head a thread's OCOLS = MAXD / 16 output columns cover; T: the type
// of q, k, v and out (shared memory and all arithmetic are f32)
template <int MAXD, typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ valid,
                T* __restrict__ out, int seq, int heads, int dh, float scale) {
  constexpr int OCOLS = MAXD / 16;  // output columns per thread
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Qs = smem;                     // BQ x ld, pre-scaled by 1/sqrt(dh)
  float* Ks = Qs + BQ * ld;             // BK x ld
  float* Vs = Ks + BK * ld;             // BK x dh
  float* Ps = Vs + BK * dh;             // BQ x (BK + 1) probabilities of this tile
  float* Kf = Ps + BQ * (BK + 1);       // BK key flags: 0 valid, 1 masked, 2 past the end

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // lane within the row group
  const int ty = tid >> 4;              // row group: rows ty*ROWS .. +ROWS
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  const long long row_stride = (long long)heads * dh;  // elements between time steps
  const long long base = (long long)b * seq * row_stride + (long long)h * dh;
  const float* valid_b = valid + (long long)b * seq;

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int r = idx / dh, d = idx - r * dh;
    const int t = q0 + r;
    Qs[r * ld + d] = t < seq ? to_f32(q[base + t * row_stride + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OCOLS; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < BK * dh; idx += THREADS) {
      const int r = idx / dh, d = idx - r * dh;
      const int t = k0 + r;
      const bool in = t < seq;
      Ks[r * ld + d] = in ? to_f32(k[base + t * row_stride + d]) : 0.f;
      Vs[r * dh + d] = in ? to_f32(v[base + t * row_stride + d]) : 0.f;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      Kf[tid] = t >= seq ? 2.f : (valid_b[t] > 0.f ? 0.f : 1.f);
    }
    __syncthreads();

    float s[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[ROWS], kv[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(ty * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const float f = Kf[tx + 16 * j];
        // masked keys get exactly -1e30, as logits + (1 - valid) * (-1e30) rounds to in f32
        s[i][j] = f == 0.f ? s[i][j] : (f == 1.f ? -1e30f : -INFINITY);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);  // finite: key 0 is never past the end
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(ty * ROWS + i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OCOLS; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(ty * ROWS + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < OCOLS; ++j) {
        const int d = tx + 16 * j;
        if (d < dh) {
          const float vv = Vs[c * dh + d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + ty * ROWS + i;
    if (t >= seq) continue;
    const float keep = valid_b[t] > 0.f ? 1.f / l[i] : 0.f;  // padded query rows -> 0
#pragma unroll
    for (int j = 0; j < OCOLS; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) out[base + t * row_stride + d] = from_f32<T>(acc[i][j] * keep);
    }
  }
}

template <int MAXD, typename T>
int launch_t(const void* q, const void* k, const void* v, const void* valid, void* out,
             int batch, int seq, int heads, int dh, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);  // 140 KB at dh 256
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<MAXD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  attn_fwd_kernel<MAXD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(valid), static_cast<T*>(out), seq, heads, dh,
      1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

// float32 at dh <= 128
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int batch, int seq, int heads, int dh, cudaStream_t stream) {
  return launch_t<MAX_DH, float>(q, k, v, valid, out, batch, seq, heads, dh, stream);
}

// 128 < dh <= 256: dtype 0 float32, 1 bfloat16
int launch_wide(const void* q, const void* k, const void* v, const void* valid, void* out,
                int batch, int seq, int heads, int dh, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_t<MAX_DH_WIDE, float>(q, k, v, valid, out, batch, seq, heads, dh, stream);
  return launch_t<MAX_DH_WIDE, __nv_bfloat16>(q, k, v, valid, out, batch, seq, heads, dh,
                                              stream);
}

}  // namespace simt

// -- bfloat16: wgmma + TMA, warp-specialised --------------------------------------------
//
// Why skipping padded tiles is exact: a padded key's logit is -1e30, so in a row with at
// least one valid key its weight exp(-1e30 - m) is exactly 0 once the running max m is a
// real logit, which it is from the first tile that holds a valid key on (every tile this
// kernel multiplies holds one). A row with no valid key is a padded query row, written
// as zero. So dropping an all-padded tile changes no bit of any valid row.

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; -inf -> +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
                const float* __restrict__ valid, bf16* __restrict__ out, int seq, int heads,
                int dh, int n_work, float scale_log2) {
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
        const float* valid_b = valid + (long long)(w / n_tiles / heads) * seq;
        int* cnt = counts + (k & 1) * n_tiles;
        for (int j = warp - 1; j < n_tiles; j += 3) {
          int c = 0;
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int t = j * BN + 32 * i + lane;
            c += t < seq && valid_b[t] > 0.f;
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
      const float* valid_b = valid + (long long)b * seq;
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
              const float fill = key >= seq ? -INFINITY : (valid_b[key] > 0.f ? 0.f : -1e30f);
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
        const float keep = (t < seq && valid_b[t] > 0.f) ? 1.f / l[r] : 0.f;
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
int launch_dhp(const void* q, const void* k, const void* v, const void* valid, void* out,
               int batch, int seq, int heads, int dh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, q, batch, seq, heads, dh, BM) || !encode(&tk, k, batch, seq, heads, dh, BN) ||
      !encode(&tv, v, batch, seq, heads, dh, BN) || !encode(&to, out, batch, seq, heads, dh, 64))
    return (int)cudaErrorInvalidValue;
  // the SM count and the largest shared memory granted so far, per device, asked once
  // and not at every launch: at the encoder's shape the kernel itself is shorter than
  // the host's work around a launch
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  static size_t granted[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return (int)err;
  const int n_tiles = (seq + BN - 1) / BN;
  const size_t smem = smem_bytes(DHP, n_tiles);
  if (smem > granted[device]) {
    err = cudaFuncSetAttribute(attn_fwd_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[device] = smem;
  }
  const long long n_work = (long long)n_tiles * batch * heads;
  if (n_work > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)std::min<long long>(n_work, sms[device]);  // a persistent block an SM
  attn_fwd_kernel<DHP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, to, static_cast<const float*>(valid), static_cast<bf16*>(out), seq, heads,
      dh, (int)n_work, 1.4426950408889634f / sqrtf((float)dh));  // log2(e) / sqrt(dh)
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int batch, int seq, int heads, int dh, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dh % 8 != 0 || (ptrs & 15u) != 0) return (int)cudaErrorInvalidValue;
  if (dh <= 64) return launch_dhp<64>(q, k, v, valid, out, batch, seq, heads, dh, stream);
  return launch_dhp<128>(q, k, v, valid, out, batch, seq, heads, dh, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int sf_attention_fwd(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int batch, int seq,
                                int heads, int dh, int dtype, void* stream) {
  if (dh < 1 || dh > MAX_DH_WIDE || seq < 1 || batch < 1 || heads < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > MAX_DH)
    return simt::launch_wide(q, k, v, valid, out, batch, seq, heads, dh, dtype, s);
  if (dtype == 0) return simt::launch(q, k, v, valid, out, batch, seq, heads, dh, s);
  if (dtype == 1) return tc::launch(q, k, v, valid, out, batch, seq, heads, dh, s);
  return (int)cudaErrorInvalidValue;
}
