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
// hold that at T = 1024, so both paths below are flash forwards instead: one block per
// (64-row query tile, batch * head); K/V stream through shared memory in tiles, and an
// online softmax (running max and sum per row, in f32) keeps the T x T logits out of
// device memory.
//
// - bfloat16 (the serving path): both products run on the tensor cores through
//   `mma.sync` m16n8k16 (bf16 in, f32 accumulation). Four warps own 16 query rows each;
//   per 64-key tile a warp computes its 16 x 64 logits into registers, applies the mask
//   and the online softmax in f32 there, rounds the probabilities to bf16 (as the TPU
//   kernel casts them to v's type before its second product) and feeds them, still in
//   registers, as the A operand of P V into an f32 accumulator that also stays in
//   registers. K/V tiles are double-buffered with cp.async, so the next tile loads
//   while this one is multiplied. It stays far below the bf16 peak (PERF.md); wgmma,
//   TMA and a deeper pipeline are later work.
// - float32: the arithmetic runs on the CUDA cores in f32 (FMA), which caps it at the
//   f32 rate (67 TFLOP/s) but keeps full f32 logits.
//
// Layout: q, k, v and out are (B, T, H, dh), contiguous, the layout the projections
// produce, so no transpose is needed; valid is (B, T) f32 0/1. Any T (the tail tile is
// masked) and 1 <= dh <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DH = 128;

// -- float32: CUDA cores ----------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // keys per shared-memory tile
constexpr int THREADS = 256; // 16 row groups x 16 lanes
constexpr int ROWS = BQ / 16;          // query rows per thread (4)
constexpr int SCOLS = BK / 16;         // logits columns per thread (2)
constexpr int OCOLS = MAX_DH / 16;     // output columns per thread (8)

size_t smem_bytes(int dh) {
  const int ld = dh + 1;  // +1 float of padding: rows land on different banks
  return sizeof(float) * (size_t(BQ) * ld + size_t(BK) * ld + size_t(BK) * dh +
                          size_t(BQ) * (BK + 1) + BK);
}

__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ valid,
                float* __restrict__ out, int seq, int heads, int dh, float scale) {
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
    Qs[r * ld + d] = t < seq ? q[base + t * row_stride + d] * scale : 0.f;
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
      Ks[r * ld + d] = in ? k[base + t * row_stride + d] : 0.f;
      Vs[r * dh + d] = in ? v[base + t * row_stride + d] : 0.f;
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
      if (d < dh) out[base + t * row_stride + d] = acc[i][j] * keep;
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int batch, int seq, int heads, int dh, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  attn_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(valid),
      static_cast<float*>(out), seq, heads, dh, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bfloat16: tensor cores through mma.sync ------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;             // query rows per block, 16 per warp
constexpr int BK = 64;             // keys per shared-memory tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int ND = MAX_DH / 16;    // 16-wide head-dim chunks at most
constexpr int NT = BK / 8;         // 8-key column tiles of the logits
// row stride of the Q/K/V tiles in bf16: 272 bytes, so the 8 rows that one fragment
// load or one ldmatrix touches start on 8 different 4-bank groups (no bank conflicts),
// and every row start stays 16-byte aligned, as ldmatrix and the 16-byte copies require
constexpr int LDH = MAX_DH + 8;

// two stages of (K tile, V tile, key mask); Q is staged in stage 1's K tile before the
// loop, since it is read once into registers
constexpr size_t TILE = sizeof(bf16) * BK * LDH;
constexpr size_t OFF_F = 4 * TILE;
constexpr size_t SMEM = OFF_F + 2 * sizeof(float) * BK;
static_assert(BQ == BK, "Q is staged in a K tile");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies to shared memory; with pred false nothing is read and the
// destination is zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows x dhp tile of (B, T, H, dh) starting at time t0, zero outside [0, seq) x [0, dh):
// asynchronous 16-byte copies where dh % 8 == 0 and the pointers are aligned, else
// plain loads
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int t0, int rows, int seq, long long row_stride,
                                          int dh, int dhp, bool vec) {
  if (vec) {
    const int per_row = dhp / 8;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
      const int r = idx / per_row, c = (idx - r * per_row) * 8;
      const int t = t0 + r;
      const bool in = t < seq && c < dh;
      cp_async16(dst + r * LDH + c, in ? src + t * row_stride + c : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dhp; idx += THREADS) {
      const int r = idx / dhp, c = idx - r * dhp;
      const int t = t0 + r;
      dst[r * LDH + c] = (t < seq && c < dh) ? src[t * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed on the way: lane L gives the row address of
// matrix L / 8, row L % 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4): the accumulator holds
// rows g and g + 8, columns 2q and 2q + 1 of its 16 x 8 tile; an A fragment holds rows
// g and g + 8, columns 2q, 2q + 1 and 2q + 8, 2q + 9 of its 16 x 16 tile. So the
// probabilities of two neighbouring 8-key logit tiles are, once rounded to bf16, the A
// fragment of the next product as they stand: P never leaves the registers.
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ valid,
                bf16* __restrict__ out, int seq, int heads, int dh, float scale_log2,
                int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // stage s: K tile at 2s, V tile at 2s + 1, and the keys' valid flags
  auto k_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + 2 * s * TILE); };
  auto v_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + (2 * s + 1) * TILE); };
  auto flags = [&](int s) { return reinterpret_cast<float*>(smem + OFF_F) + s * BK; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  const long long row_stride = (long long)heads * dh;
  const long long base = (long long)b * seq * row_stride + (long long)h * dh;
  const float* valid_b = valid + (long long)b * seq;
  const int dhp = (dh + 15) & ~15;  // head dim padded with zeros to whole chunks
  const int nd = dhp / 16;
  const int w0 = warp * 16;         // the warp's first row in the tile

  auto load_stage = [&](int stage, int k0) {
    load_tile(k_tile(stage), k + base, k0, BK, seq, row_stride, dh, dhp, vec);
    load_tile(v_tile(stage), v + base, k0, BK, seq, row_stride, dh, dhp, vec);
    if (tid < BK) {
      const bool in = k0 + tid < seq;
      cp_async4(flags(stage) + tid, in ? valid_b + k0 + tid : valid_b, in);
    }
  };

  const bf16* Qs = k_tile(1);
  load_tile(k_tile(1), q + base, q0, BQ, seq, row_stride, dh, dhp, vec);
  cp_async_commit();
  load_stage(0, 0);
  cp_async_commit();
  cp_async_wait_one();  // Q has landed; K/V tile 0 may still be in flight
  __syncthreads();
  uint32_t qf[ND][4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    if (kk < nd) {
      const bf16* p = Qs + (w0 + g) * LDH + kk * 16 + 2 * qd;
      qf[kk][0] = ld32(p);
      qf[kk][1] = ld32(p + 8 * LDH);
      qf[kk][2] = ld32(p + 8);
      qf[kk][3] = ld32(p + 8 * LDH + 8);
    }
  }
  __syncthreads();  // stage 1 is free for the next tile

  float o[2 * ND][4];  // output rows g, g + 8 of the warp; 8-wide head-dim tiles
#pragma unroll
  for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's share of the running sums

  for (int k0 = 0, stage = 0; k0 < seq; k0 += BK, stage ^= 1) {
    if (k0 + BK < seq) load_stage(stage ^ 1, k0 + BK);  // prefetch the next tile
    cp_async_commit();
    cp_async_wait_one();  // this tile has landed
    __syncthreads();
    const bf16* Kt = k_tile(stage);
    const bf16* Vt = v_tile(stage);
    const float* vf = flags(stage);

    // S (16 x BK) = Q K^T; K stored (keys x d) row-major is B column-major
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        if (kk < nd) {
          const bf16* p = Kt + (n * 8 + g) * LDH + kk * 16 + 2 * qd;
          mma16816(s[n], qf[kk], ld32(p), ld32(p + 8));
        }
      }
    }

    // online softmax in f32, base 2; the four lanes of a quad share a row
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * qd + (e & 1);
        // a padded key gets -1e30, far below any logit, as the TPU's additive mask
        // gives; a key past the end gets -inf and weight 0
        s[n][e] = k0 + c >= seq ? -INFINITY : (vf[c] > 0.f ? s[n][e] * scale_log2 : -1e30f);
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);  // finite: key k0 is never past the end
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O (16 x dhp) += P V, P rounded to bf16 (as the TPU kernel casts it to v's type)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      // matrices: keys +0..7 / +8..15 of head-dim tile 2j, then the same of tile 2j + 1
      const bf16* vrow = Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                         (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        if (j < nd) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vrow + j * 16);
          mma16816(o[2 * j], pa, vb[0], vb[1]);
          mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = q0 + w0 + g + 8 * r;
    if (t >= seq) continue;
    const float keep = valid_b[t] > 0.f ? 1.f / l[r] : 0.f;  // padded query rows -> 0
    bf16* orow = out + base + t * row_stride;
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j) {
      const int d = j * 8 + 2 * qd;
      if (d < dh) orow[d] = __float2bfloat16(o[j][2 * r] * keep);
      if (d + 1 < dh) orow[d + 1] = __float2bfloat16(o[j][2 * r + 1] * keep);
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int batch, int seq, int heads, int dh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  const int vec = (dh % 8 == 0) && aligned;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  attn_fwd_kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(valid), static_cast<bf16*>(out), seq, heads, dh,
      1.4426950408889634f / sqrtf((float)dh), vec);  // log2(e) / sqrt(dh)
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int sf_attention_fwd(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int batch, int seq,
                                int heads, int dh, int dtype, void* stream) {
  if (dh < 1 || dh > MAX_DH || seq < 1 || batch < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  if (batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32::launch(q, k, v, valid, out, batch, seq, heads, dh, s);
  if (dtype == 1) return tc::launch(q, k, v, valid, out, batch, seq, heads, dh, s);
  return (int)cudaErrorInvalidValue;
}
