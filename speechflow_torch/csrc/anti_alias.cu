// Anti-aliased snake-beta activation for Hopper (sm_90a): three entry points.
//
// Replaces the TPU kernel `anti_alias_snake_pallas` (tile math `_aa_tile`,
// speechflow_tpu/ops/anti_alias.py). It computes, per channel, in polyphase form:
//   1. 2x upsample + K-tap Kaiser-sinc FIR  -> even/odd phase signals at input rate
//   2. snake-beta  z = y + sin^2(e^alpha * y) / (e^beta + 1e-9)
//   3. the same FIR + 2x decimation          -> output at input rate
// Padding is anchored like XLA's SAME conv (pad_left = (K-1)/2); stage-1 values outside
// [0, T) are zero before the snake, as `_aa_tile` zeroes them.
//
//   fused     x -> out            (stages 1-3; the 2x intermediate stays in registers)
//   upsample  x -> (y_even, y_odd) (stage 1; shared by the branches of an MRF group)
//   down      (y_even, y_odd) -> out (stages 2-3)
//
// What bounds it on the H100: each input element is read once and each output written
// once (2 * sizeof(T) bytes a sample in the fused entry), against about 4K + 10 f32
// operations a sample; it is bound by bytes, with the instruction count close behind
// (about 40 f32 instructions a sample at K = 12 against ~20 bytes' worth of issue).
// So the design spends as few instructions a sample as it can:
// - Register sliding windows. A thread owns 2 adjacent channels and a run of
//   run_len() consecutive output samples, which it walks in chunks of CHUNK rows. Per chunk it
//   loads CHUNK new input rows (2 channels per load; the next chunk's loads are in
//   flight while this one computes), runs both stage-1 phases, the snake and the
//   stage-2 FIR over windows held in registers, and carries the windows' last rows over
//   to the next chunk, so each stage-1 value is computed once per thread and the FIR
//   halo is recomputed only once per run. The taps live in registers too; there is no
//   shared memory.
// - No idle lanes. Threads map linearly over (batch, run, channel pair), channel pair
//   fastest, so neighbouring threads read neighbouring addresses along C, and no lane
//   idles at C = 24 or 48. An odd C takes scalar loads (its rows are not 4-byte aligned)
//   and a guarded last channel. Runs that touch neither edge skip all bounds checks.
// - A cheap sine. sin^2(u) = (1 - cos(2u)) / 2, and cos runs on the special-function
//   unit (`__cosf`) after a two-constant Cody-Waite reduction of w = 2u to [-pi, pi]
//   (cos_reduced below). `__cosf` alone, unreduced, loses accuracy as |w| grows.
// The tap counts the JAX package uses (12, 8, 6) are unrolled; any other count up to 16
// runs as the 16-tap kernel with its filter placed so that the anchoring is the same.
//
// The VJPs (the backward of the three entries; the TPU package differentiates the XLA
// composition instead, so they replace no TPU kernel) in the same layout, all in f32:
//   fused_vjp  (x, g) -> (dx, dalpha, dbeta)   recompute stage 1 over the run and its halo,
//              dz = the transposed stage-2 FIR of g, dy = dz (1 + a inv_b sin(2ay)), dx =
//              the transposed stage-1 FIR of dy; y, dz and dy never reach device memory
//   down_vjp   (y_even, y_odd, g) -> (dy_even, dy_odd, dalpha, dbeta)
//   up_vjp     (g_even, g_odd) -> dx           (a null cotangent reads as zero)
// A transposed FIR is the same sum with the offsets negated. The fused VJP gathers dz and y
// from register windows of g and x, and scatters each dy row into a window of dx
// accumulators (a chunk's first CHUNK rows are then complete and stored), so it holds no dy
// window. Bound: bytes again (x, g and dx: 6 bytes a sample in bf16) with ~4K + 30 f32
// operations a sample, sin and cos of the snake from one reduction (`sincos_reduced`).
// dalpha and dbeta: each thread sums dz y sin(2ay) and dz (1 - cos(2ay)) over the rows it
// owns (a row of the halo is owned by the neighbouring run) and writes them to a scratch
// row per (batch, run); a second kernel reduces the rows in a fixed order (no float
// atomics), so two calls give the same bits. The run length is the caller's, a multiple of
// CHUNK; an even C and a run at the edges are run-time flags there (one body a dtype, mode
// and tap count: 24 kernels, which keeps the build short).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 8;      // rows a thread computes per step
constexpr int THREADS = 128;
constexpr int MAX_TAPS = 16;

enum Mode { FUSED = 0, UPSAMPLE = 1, DOWN = 2 };

// output samples per thread, a multiple of CHUNK: long runs spread the stage-2 halo
// over more outputs; stage 1 alone has only the input halo and writes two outputs, and
// runs faster with more, shorter runs (measured on the H100, PERF.md)
template <int MODE> __host__ __device__ constexpr int run_len() {
  return MODE == UPSAMPLE ? 16 : 64;
}

// floor(n / 2) for any sign
__host__ __device__ constexpr int floor_half(int n) { return n >= 0 ? n / 2 : -((1 - n) / 2); }

// Polyphase offsets of tap k (pad_left P = (K-1)/2, d = k - P). Stage 1: y_even[i] takes
// x[i + d/2] for even d, y_odd[i] takes x[i + (d+1)/2] for odd d: x offset floor((d+1)/2).
// Stage 2: out[i] takes z_even[i + d/2] for even d and z_odd[i + (d-1)/2] for odd d:
// offset floor(d/2). Both grow with k.
template <int K> __host__ __device__ constexpr int pad_left() { return (K - 1) / 2; }
template <int K> __host__ __device__ constexpr int off1(int k) {
  return floor_half(k - pad_left<K>() + 1);
}
template <int K> __host__ __device__ constexpr int off2(int k) {
  return floor_half(k - pad_left<K>());
}
template <int K> __host__ __device__ constexpr bool odd_tap(int k) {
  return ((k - pad_left<K>()) & 1) != 0;
}

// A row's 2 channels as loaded: one 32-bit word of bf16 pairs, or two floats
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint32_t v; };
template <> struct Raw<float> { float a, b; };

template <typename T, bool VEC, bool EDGE>
__device__ __forceinline__ Raw<T> load_raw(const T* __restrict__ p, int t, int seq,
                                           bool second) {
  Raw<T> r;
  if constexpr (sizeof(T) == 2) {
    r.v = 0u;
    if (!EDGE || unsigned(t) < unsigned(seq)) {
      if (VEC) {
        r.v = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
        const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
        r.v = uint32_t(__ldg(s)) | (second ? uint32_t(__ldg(s + 1)) << 16 : 0u);
      }
    }
  } else {
    r.a = r.b = 0.f;
    if (!EDGE || unsigned(t) < unsigned(seq)) {
      if (VEC) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p));
        r.a = v.x;
        r.b = v.y;
      } else {
        r.a = __ldg(p);
        r.b = second ? __ldg(p + 1) : 0.f;
      }
    }
  }
  return r;
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float (&v)[2]) {
  v[0] = __uint_as_float(r.v << 16);
  v[1] = __uint_as_float(r.v & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const Raw<float>& r, float (&v)[2]) {
  v[0] = r.a;
  v[1] = r.b;
}

template <typename T, bool VEC, bool EDGE>
__device__ __forceinline__ void store_row(T* __restrict__ p, int t, int seq, float a, float b,
                                          bool second) {
  if (EDGE && t >= seq) return;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    if (VEC) {
      *reinterpret_cast<__nv_bfloat162*>(p) = v;
    } else {
      p[0] = v.x;
      if (second) p[1] = v.y;
    }
  } else {
    if (VEC) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      p[0] = a;
      if (second) p[1] = b;
    }
  }
}

// cos(w) for the snake. Cody-Waite: n = rint(w / 2pi), r = (w - n * C1) - n * C2 with
// C1 = 6.28125 (8 significant bits, so n * C1 and w - n * C1 are exact for |n| < 2^16,
// i.e. |w| < 4e5) and C2 = 2pi - C1 in f32; r lies in [-pi, pi] with an error of a few
// f32 ulps of pi, where `__cosf` is within 2^-21.4 absolute (CUDA programming guide).
// So |cos_reduced(w) - cos(w)| < 5e-7 for |w| < 4e5, and the snake term
// inv_b * sin^2 = (inv_b / 2) (1 - cos(2u)) is off by less than inv_b * 2.5e-7.
__device__ __forceinline__ float reduce_2pi(float w) {
  const float n = rintf(w * 0.15915494309189535f);
  const float r = fmaf(-n, 6.28125f, w);
  return fmaf(-n, 1.9353071795864769e-3f, r);
}
__device__ __forceinline__ float cos_reduced(float w) { return __cosf(reduce_2pi(w)); }
// sin(w) and cos(w) after the same reduction (`__sincosf`: the same bound on [-pi, pi])
__device__ __forceinline__ void sincos_reduced(float w, float& s, float& c) {
  __sincosf(reduce_2pi(w), &s, &c);
}

// z = y + inv_b sin^2(a y) = y + hb (1 - cos(2 a y)), hb = inv_b / 2, a2 = 2a
__device__ __forceinline__ float snake(float y, float a2, float hb) {
  return fmaf(-hb, cos_reduced(a2 * y), y + hb);
}

// stage 1 at one row: the even and odd phase from the x window starting at row i0
template <int K, int N>
__device__ __forceinline__ void stage1(const float (&xw)[N][2], int i0, int c, const float (&f2)[K],
                                       float& e, float& d) {
  e = 0.f;
  d = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = xw[i0 + off1<K>(k) - off1<K>(0)][c];
    if (odd_tap<K>(k)) d = fmaf(f2[k], v, d);
    else               e = fmaf(f2[k], v, e);
  }
}

// One thread's work: channels c0, c0 + 1 (`second`: c0 + 1 exists) of one batch row
// (`base` points there), output samples t0 .. t0 + run_len - 1 of its mode (stage-1 rows
// in UPSAMPLE, final rows otherwise). Windows, relative to the chunk: xw row 0 is the x row
// of the chunk's first new stage-1 row shifted by off1(0); ze/zo row 0 is the z row
// of the chunk's first output shifted by off2(0). EDGE: bounds checks on, for runs that
// touch [0, T)'s edges.
template <typename T, int MODE, int K, bool VEC, bool EDGE>
__device__ __forceinline__ void run_thread(const T* __restrict__ x, const T* __restrict__ ye_in,
                                           const T* __restrict__ yo_in, T* __restrict__ out,
                                           T* __restrict__ ye_out, T* __restrict__ yo_out,
                                           const float (&f)[K], const float (&a2)[2],
                                           const float (&hb)[2], long long base, int t0,
                                           int seq, int channels, bool second) {
  constexpr int X0 = off1<K>(0);
  constexpr int HX = off1<K>(K - 1) - X0;                       // stage-1 halo
  constexpr int Y0 = MODE == UPSAMPLE ? 0 : off2<K>(0);
  constexpr int HY = MODE == UPSAMPLE ? 0 : off2<K>(K - 1) - Y0;  // stage-2 halo
  float f2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f2[k] = 2.f * f[k];

  float xw[HX + HY + CHUNK][2];
  float ze[HY + CHUNK][2], zo[HY + CHUNK][2];
  auto snake_row = [&](int i, int t) {  // ze/zo row i (stage-1 row t) through the snake
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool in = !EDGE || unsigned(t) < unsigned(seq);  // zero outside [0, T)
      ze[i][c] = in ? snake(ze[i][c], a2[c], hb[c]) : 0.f;
      zo[i][c] = in ? snake(zo[i][c], a2[c], hb[c]) : 0.f;
    }
  };

  // prologue: the first HY stage-1 rows (the stage-2 halo before the run)
  const T* src = MODE == DOWN ? ye_in : x;
  const int t_first = t0 + Y0 + (MODE == DOWN ? 0 : X0);  // first row read
  if (MODE == DOWN) {
#pragma unroll
    for (int i = 0; i < HY; ++i) {
      const int t = t_first + i;
      const long long o = base + (long long)t * channels;
      unpack(load_raw<T, VEC, EDGE>(ye_in + o, t, seq, second), ze[i]);
      unpack(load_raw<T, VEC, EDGE>(yo_in + o, t, seq, second), zo[i]);
      snake_row(i, t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < HX + HY; ++i) {
      const int t = t_first + i;
      unpack(load_raw<T, VEC, EDGE>(x + base + (long long)t * channels, t, seq, second), xw[i]);
    }
#pragma unroll
    for (int i = 0; i < HY; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) stage1<K>(xw, i, c, f2, ze[i][c], zo[i][c]);
      snake_row(i, t0 + Y0 + i);
    }
#pragma unroll
    for (int i = 0; i < HX; ++i) {
      xw[i][0] = xw[HY + i][0];
      xw[i][1] = xw[HY + i][1];
    }
  }

  // rows read per chunk start at t_new; the next chunk's are loaded ahead
  const int t_new0 = t_first + (MODE == DOWN ? HY : HX + HY);
  Raw<T> raw_e[CHUNK], raw_o[CHUNK];
  auto load_chunk = [&](int t_new) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int t = t_new + i;
      const long long o = base + (long long)t * channels;
      raw_e[i] = load_raw<T, VEC, EDGE>(src + o, t, seq, second);
      if (MODE == DOWN) raw_o[i] = load_raw<T, VEC, EDGE>(yo_in + o, t, seq, second);
    }
  };
  load_chunk(t_new0);

#pragma unroll 1
  for (int c = 0; c < run_len<MODE>(); c += CHUNK) {
    // stage-1 rows of this chunk: t0 + Y0 + HY + c + i, i < CHUNK
    const int ty = t0 + Y0 + HY + c;
    if (MODE == DOWN) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        unpack(raw_e[i], ze[HY + i]);
        unpack(raw_o[i], zo[HY + i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) unpack(raw_e[i], xw[HX + i]);
    }
    if (c + CHUNK < run_len<MODE>()) load_chunk(t_new0 + c + CHUNK);

    if (MODE == DOWN) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) snake_row(HY + i, ty + i);
    } else {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        float e[2], d[2];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) stage1<K>(xw, i, ch, f2, e[ch], d[ch]);
        if (MODE == UPSAMPLE) {
          const long long o = base + (long long)(ty + i) * channels;
          store_row<T, VEC, EDGE>(ye_out + o, ty + i, seq, e[0], e[1], second);
          store_row<T, VEC, EDGE>(yo_out + o, ty + i, seq, d[0], d[1], second);
        } else {
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            ze[HY + i][ch] = e[ch];
            zo[HY + i][ch] = d[ch];
          }
          snake_row(HY + i, ty + i);
        }
      }
#pragma unroll
      for (int i = 0; i < HX; ++i) {
        xw[i][0] = xw[CHUNK + i][0];
        xw[i][1] = xw[CHUNK + i][1];
      }
    }

    if (MODE != UPSAMPLE) {
      // stages 2+3: out[t] = sum_k f[k] z[2t + k - P], folded onto the two phases
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int t = t0 + c + i;
        float acc[2] = {0.f, 0.f};
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int r = i + off2<K>(k) - Y0;
            acc[ch] = fmaf(f[k], odd_tap<K>(k) ? zo[r][ch] : ze[r][ch], acc[ch]);
          }
        store_row<T, VEC, EDGE>(out + base + (long long)t * channels, t, seq, acc[0], acc[1],
                                second);
      }
#pragma unroll
      for (int i = 0; i < HY; ++i)
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          ze[i][ch] = ze[CHUNK + i][ch];
          zo[i][ch] = zo[CHUNK + i][ch];
        }
    }
  }
}

// K is the compiled tap count; `taps` taps of `filt` sit at positions
// shift .. shift + taps - 1 of it (zeros around), which keeps XLA's SAME anchoring of a
// shorter filter. VEC: C is even, so a row's channel pair is one aligned load.
template <typename T, int MODE, int K, bool VEC>
__global__ void __launch_bounds__(THREADS)
aa_kernel(const T* __restrict__ x, const T* __restrict__ ye_in, const T* __restrict__ yo_in,
          const float* __restrict__ log_alpha, const float* __restrict__ log_beta,
          const float* __restrict__ filt, T* __restrict__ out, T* __restrict__ ye_out,
          T* __restrict__ yo_out, int seq, int channels, int taps, int shift, int n_runs,
          int n_pairs, int items) {
  const int item = blockIdx.x * THREADS + threadIdx.x;
  if (item >= items) return;
  const int pair = item % n_pairs;
  const int rest = item / n_pairs;
  const int run = rest % n_runs;
  const int b = rest / n_runs;
  const int c0 = 2 * pair;
  const int t0 = run * run_len<MODE>();
  const bool second = c0 + 1 < channels;
  const long long base = (long long)b * seq * channels + c0;

  float f[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    f[k] = (k >= shift && k - shift < taps) ? __ldg(filt + k - shift) : 0.f;
  float a2[2] = {0.f, 0.f}, hb[2] = {0.f, 0.f};
  if (MODE != UPSAMPLE) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = min(c0 + c, channels - 1);
      a2[c] = 2.f * expf(__ldg(log_alpha + ch));
      hb[c] = 0.5f * (1.0f / (expf(__ldg(log_beta + ch)) + 1e-9f));
    }
  }

  // the rows this thread reads: [lo, hi)
  constexpr int X0 = MODE == DOWN ? 0 : off1<K>(0);
  constexpr int HX = MODE == DOWN ? 0 : off1<K>(K - 1) - off1<K>(0);
  constexpr int Y0 = MODE == UPSAMPLE ? 0 : off2<K>(0);
  constexpr int HY = MODE == UPSAMPLE ? 0 : off2<K>(K - 1) - off2<K>(0);
  const int lo = t0 + Y0 + X0, hi = t0 + Y0 + X0 + run_len<MODE>() + HY + HX;
  if (lo >= 0 && hi <= seq)
    run_thread<T, MODE, K, VEC, false>(x, ye_in, yo_in, out, ye_out, yo_out, f, a2, hb, base,
                                       t0, seq, channels, second);
  else
    run_thread<T, MODE, K, VEC, true>(x, ye_in, yo_in, out, ye_out, yo_out, f, a2, hb, base,
                                      t0, seq, channels, second);
}

template <typename T, int MODE, int K>
int launch(const void* x, const void* ye_in, const void* yo_in, const void* alpha,
           const void* beta, const void* filt, void* out, void* ye_out, void* yo_out,
           int batch, int seq, int channels, int taps, cudaStream_t stream) {
  const int n_runs = (seq + run_len<MODE>() - 1) / run_len<MODE>();
  const int n_pairs = (channels + 1) / 2;
  const long long items = (long long)batch * n_runs * n_pairs;
  if (items > 0x7fffffffLL - THREADS) return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = unsigned((items + THREADS - 1) / THREADS);
  const int shift = pad_left<K>() - (taps - 1) / 2;
  auto kernel = channels % 2 == 0 ? aa_kernel<T, MODE, K, true> : aa_kernel<T, MODE, K, false>;
  kernel<<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ye_in), static_cast<const T*>(yo_in),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(filt), static_cast<T*>(out), static_cast<T*>(ye_out),
      static_cast<T*>(yo_out), seq, channels, taps, shift, n_runs, n_pairs, int(items));
  return (int)cudaGetLastError();
}

// 12 (the default), 8 and 6 (training) unrolled as they are; any other count runs in the
// 16-tap kernel, shifted by pad_left(16) - pad_left(taps) so the anchoring is kept
template <typename T, int MODE>
int launch_taps(const void* x, const void* ye_in, const void* yo_in, const void* alpha,
                const void* beta, const void* filt, void* out, void* ye_out, void* yo_out,
                int batch, int seq, int channels, int taps, cudaStream_t s) {
  switch (taps) {
    case 12:
      return launch<T, MODE, 12>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out, yo_out,
                                 batch, seq, channels, taps, s);
    case 8:
      return launch<T, MODE, 8>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out, yo_out,
                                batch, seq, channels, taps, s);
    case 6:
      return launch<T, MODE, 6>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out, yo_out,
                                batch, seq, channels, taps, s);
    default:
      return launch<T, MODE, MAX_TAPS>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out,
                                       yo_out, batch, seq, channels, taps, s);
  }
}

template <int MODE>
int dispatch(const void* x, const void* ye_in, const void* yo_in, const void* alpha,
             const void* beta, const void* filt, void* out, void* ye_out, void* yo_out,
             int batch, int seq, int channels, int taps, int dtype, void* stream) {
  if (taps < 1 || taps > MAX_TAPS || batch < 1 || seq < 1 || channels < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_taps<float, MODE>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out, yo_out,
                                    batch, seq, channels, taps, s);
  if (dtype == 1)
    return launch_taps<__nv_bfloat16, MODE>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out,
                                            yo_out, batch, seq, channels, taps, s);
  return (int)cudaErrorInvalidValue;
}


// -- the VJPs -------------------------------------------------------------------------
//
// Each FIR is a sum of shifted copies with zeros outside [0, T), so its transpose is the
// same sum with the shifts negated: dz_p[j] = sum_{k of phase p} f[k] g[j - off2(k)] and
// dx[m] = 2 sum_k f[k] dy_{phase(k)}[m - off1(k)], where dy_p = dz_p (1 + a inv_b sin(2 a y_p))
// on stage-1 rows inside [0, T) and 0 outside. A thread owns 2 channels and a run of
// run_len rows, as in the forward; run_len is a multiple of CHUNK chosen by the caller
// from the shape.

enum VjpMode { FUSED_VJP = 0, DOWN_VJP = 1, UP_VJP = 2 };

struct VjpArgs {
  const void* in0;  // FUSED_VJP: x; DOWN_VJP: y_even; UP_VJP: g_even (null: zero)
  const void* in1;  // DOWN_VJP: y_odd; UP_VJP: g_odd (null: zero)
  const void* g;    // FUSED_VJP, DOWN_VJP: the output's cotangent
  const float* log_alpha;
  const float* log_beta;
  const float* filt;
  void* out0;       // FUSED_VJP, UP_VJP: dx; DOWN_VJP: dy_even
  void* out1;       // DOWN_VJP: dy_odd
  float* partial;   // (2, rows, channels): each (batch, run)'s sums for dalpha, then dbeta
  int seq, channels, taps, shift, run_len, n_runs, n_pairs, rows, items;
};

// The VJP kernels take `vec` (C even: a row's channel pair is one aligned access) and `edge`
// (the run's rows reach outside [0, T): bounds checks on) at run time, which keeps them to
// one body a (dtype, mode, taps); both branches are uniform across a thread's run.
template <typename T>
__device__ __forceinline__ Raw<T> load_pair(const T* __restrict__ p, int t, int seq,
                                            bool second, bool vec, bool edge) {
  if (edge && unsigned(t) >= unsigned(seq)) return Raw<T>{};
  return vec ? load_raw<T, true, false>(p, t, seq, second)
             : load_raw<T, false, false>(p, t, seq, second);
}

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int t, int seq, bool second,
                                         bool vec, bool edge, float (&v)[2]) {
  unpack(load_pair<T>(p, t, seq, second, vec, edge), v);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ p, int t, int seq, float a, float b,
                                           bool second, bool vec, bool edge) {
  if (edge && t >= seq) return;
  if (vec) store_row<T, true, false>(p, t, seq, a, b, second);
  else     store_row<T, false, false>(p, t, seq, a, b, second);
}

// Through z = y + inv_b sin^2(a y) at one stage-1 value: returns dy = dz (1 + ab sin(a2 y))
// (a2 = 2a, ab = a inv_b) and adds dz y sin(2ay) to sa and dz (1 - cos(2ay)) = 2 dz sin^2(ay)
// to sb.
__device__ __forceinline__ float snake_vjp(float y, float dz, float a2, float ab, float& sa,
                                           float& sb) {
  float s, c;
  sincos_reduced(a2 * y, s, c);
  const float dzs = dz * s;
  sa = fmaf(dzs, y, sa);
  sb += fmaf(-dz, c, dz);
  return fmaf(dzs, ab, dz);
}

// FUSED_VJP: x, g -> dx over rows t0 .. t0 + run_len - 1. It recomputes the stage-1 rows
// t0 - X1 .. t0 + run_len - 1 - X0 that reach them (dy row j feeds dx rows j + off1(k)) and
// scatters each dy row into acc, the dx rows of the chunk and the HX after it; a chunk's
// first CHUNK dx rows are then complete. Window rows, in chunk c: xw[r] is x row
// t0 + c + r and gw[r] is g row t0 - X0 - Y1 + c + r, so dy row t0 - X0 + c + i reads
// xw[i + off1(k) - X0] and gw[i + Y1 - off2(k)], and acc[a] is dx row t0 + c + a. The
// prologue is the chunk before, HX rows long (dy rows t0 - X1 .. t0 - X0 - 1). Only dy rows
// inside [t0, t0 + run_len) add to the sums, so that each row counts once.
template <typename T, int K>
__device__ __forceinline__ void fused_vjp_thread(const VjpArgs& p, const float (&f)[K],
                                                 const float (&a2)[2], const float (&ab)[2],
                                                 long long base, int t0, bool second, bool vec, bool edge,
                                                 float (&sa)[2], float (&sb)[2]) {
  constexpr int X0 = off1<K>(0), HX = off1<K>(K - 1) - X0, X1 = X0 + HX;
  constexpr int Y0 = off2<K>(0), HY = off2<K>(K - 1) - Y0, Y1 = Y0 + HY;
  static_assert(HX <= CHUNK, "the prologue's x rows fit the window");
  const T* __restrict__ x = static_cast<const T*>(p.in0);
  const T* __restrict__ g = static_cast<const T*>(p.g);
  T* __restrict__ dx = static_cast<T*>(p.out0);
  const int seq = p.seq, channels = p.channels, run = p.run_len;

  float xw[HX + CHUNK][2], gw[HY + CHUNK][2], acc[HX + CHUNK][2];
#pragma unroll
  for (int a = 0; a < HX + CHUNK; ++a) acc[a][0] = acc[a][1] = 0.f;

  // dy row j from window row i, scattered into acc[i + off1(k) - X0 + lag] (those >= 0)
  auto dy_row = [&](int i, int j, bool owned, int lag) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      float ye = 0.f, yo = 0.f, ze = 0.f, zo = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float xv = xw[i + off1<K>(k) - X0][ch];
        const float gv = gw[i + Y1 - off2<K>(k)][ch];
        if (odd_tap<K>(k)) {
          yo = fmaf(f[k], xv, yo);
          zo = fmaf(f[k], gv, zo);
        } else {
          ye = fmaf(f[k], xv, ye);
          ze = fmaf(f[k], gv, ze);
        }
      }
      if (edge && unsigned(j) >= unsigned(seq)) ze = zo = 0.f;  // no stage-1 row there
      float s_a = 0.f, s_b = 0.f;
      const float de = snake_vjp(2.f * ye, ze, a2[ch], ab[ch], s_a, s_b);
      const float dd = snake_vjp(2.f * yo, zo, a2[ch], ab[ch], s_a, s_b);
      if (owned) {
        sa[ch] += s_a;
        sb[ch] += s_b;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = i + off1<K>(k) - X0 + lag;
        if (a >= 0) acc[a][ch] = fmaf(f[k], odd_tap<K>(k) ? dd : de, acc[a][ch]);
      }
    }
  };

  // prologue: x rows t0 - HX .. t0 + HX - 1, g rows t0 - X1 - Y1 .. t0 - X0 - Y0 - 1
#pragma unroll
  for (int i = 0; i < 2 * HX; ++i) {
    const int t = t0 - HX + i;
    load_row<T>(x + base + (long long)t * channels, t, seq, second, vec, edge, xw[i]);
  }
#pragma unroll
  for (int i = 0; i < HX + HY; ++i) {
    const int t = t0 - X1 - Y1 + i;
    load_row<T>(g + base + (long long)t * channels, t, seq, second, vec, edge, gw[i]);
  }
#pragma unroll
  for (int i = 0; i < HX; ++i) dy_row(i, t0 - X1 + i, i >= X1, -HX);
#pragma unroll
  for (int r = 0; r < HX; ++r) {
    xw[r][0] = xw[HX + r][0];
    xw[r][1] = xw[HX + r][1];
  }
#pragma unroll
  for (int r = 0; r < HY; ++r) {
    gw[r][0] = gw[HX + r][0];
    gw[r][1] = gw[HX + r][1];
  }

  // each chunk reads CHUNK new x and g rows; the next chunk's are loaded ahead
  const int x_new0 = t0 + HX, g_new0 = t0 - X0 - Y0;
  Raw<T> rx[CHUNK], rg[CHUNK];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int tx = x_new0 + c + i, tg = g_new0 + c + i;
      rx[i] = load_pair<T>(x + base + (long long)tx * channels, tx, seq, second, vec, edge);
      rg[i] = load_pair<T>(g + base + (long long)tg * channels, tg, seq, second, vec, edge);
    }
  };
  load_chunk(0);

#pragma unroll 1
  for (int c = 0; c < run; c += CHUNK) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      unpack(rx[i], xw[HX + i]);
      unpack(rg[i], gw[HY + i]);
    }
    if (c + CHUNK < run) load_chunk(c + CHUNK);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) dy_row(i, t0 - X0 + c + i, c + i - X0 < run, 0);
#pragma unroll
    for (int a = 0; a < CHUNK; ++a) {
      const int t = t0 + c + a;
      store_pair<T>(dx + base + (long long)t * channels, t, seq, 2.f * acc[a][0],
                              2.f * acc[a][1], second, vec, edge);
    }
#pragma unroll
    for (int a = 0; a < HX; ++a) {
      acc[a][0] = acc[a + CHUNK][0];
      acc[a][1] = acc[a + CHUNK][1];
    }
#pragma unroll
    for (int a = HX; a < HX + CHUNK; ++a) acc[a][0] = acc[a][1] = 0.f;
#pragma unroll
    for (int r = 0; r < HX; ++r) {
      xw[r][0] = xw[CHUNK + r][0];
      xw[r][1] = xw[CHUNK + r][1];
    }
#pragma unroll
    for (int r = 0; r < HY; ++r) {
      gw[r][0] = gw[CHUNK + r][0];
      gw[r][1] = gw[CHUNK + r][1];
    }
  }
}

// DOWN_VJP: y_even, y_odd, g -> dy_even, dy_odd over rows t0 .. t0 + run_len - 1 (no halo
// in the outputs, so every row adds to the sums). gw[r] is g row t0 - Y1 + c + r.
template <typename T, int K>
__device__ __forceinline__ void down_vjp_thread(const VjpArgs& p, const float (&f)[K],
                                                const float (&a2)[2], const float (&ab)[2],
                                                long long base, int t0, bool second, bool vec, bool edge,
                                                float (&sa)[2], float (&sb)[2]) {
  constexpr int Y0 = off2<K>(0), HY = off2<K>(K - 1) - Y0, Y1 = Y0 + HY;
  const T* __restrict__ ye = static_cast<const T*>(p.in0);
  const T* __restrict__ yo = static_cast<const T*>(p.in1);
  const T* __restrict__ g = static_cast<const T*>(p.g);
  T* __restrict__ dye = static_cast<T*>(p.out0);
  T* __restrict__ dyo = static_cast<T*>(p.out1);
  const int seq = p.seq, channels = p.channels, run = p.run_len;

  float gw[HY + CHUNK][2], ev[CHUNK][2], ov[CHUNK][2];
#pragma unroll
  for (int i = 0; i < HY; ++i) {
    const int t = t0 - Y1 + i;
    load_row<T>(g + base + (long long)t * channels, t, seq, second, vec, edge, gw[i]);
  }
  Raw<T> re[CHUNK], ro[CHUNK], rg[CHUNK];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int t = t0 + c + i, tg = t0 - Y0 + c + i;
      const long long o = base + (long long)t * channels;
      re[i] = load_pair<T>(ye + o, t, seq, second, vec, edge);
      ro[i] = load_pair<T>(yo + o, t, seq, second, vec, edge);
      rg[i] = load_pair<T>(g + base + (long long)tg * channels, tg, seq, second, vec, edge);
    }
  };
  load_chunk(0);

#pragma unroll 1
  for (int c = 0; c < run; c += CHUNK) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      unpack(re[i], ev[i]);
      unpack(ro[i], ov[i]);
      unpack(rg[i], gw[HY + i]);
    }
    if (c + CHUNK < run) load_chunk(c + CHUNK);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int t = t0 + c + i;
      float de[2], dd[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float ze = 0.f, zo = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float gv = gw[i + Y1 - off2<K>(k)][ch];
          if (odd_tap<K>(k)) zo = fmaf(f[k], gv, zo);
          else               ze = fmaf(f[k], gv, ze);
        }
        if (edge && t >= seq) ze = zo = 0.f;
        de[ch] = snake_vjp(ev[i][ch], ze, a2[ch], ab[ch], sa[ch], sb[ch]);
        dd[ch] = snake_vjp(ov[i][ch], zo, a2[ch], ab[ch], sa[ch], sb[ch]);
      }
      const long long o = base + (long long)t * channels;
      store_pair<T>(dye + o, t, seq, de[0], de[1], second, vec, edge);
      store_pair<T>(dyo + o, t, seq, dd[0], dd[1], second, vec, edge);
    }
#pragma unroll
    for (int r = 0; r < HY; ++r) {
      gw[r][0] = gw[CHUNK + r][0];
      gw[r][1] = gw[CHUNK + r][1];
    }
  }
}

// UP_VJP: g_even, g_odd -> dx over rows t0 .. t0 + run_len - 1, gathered from windows of
// both phases: we[r] / wo[r] is row t0 - X1 + c + r. An absent phase reads as zeros.
template <typename T, int K>
__device__ __forceinline__ void up_vjp_thread(const VjpArgs& p, const float (&f)[K],
                                              long long base, int t0, bool second,
                                              bool vec, bool edge) {
  constexpr int X0 = off1<K>(0), HX = off1<K>(K - 1) - X0, X1 = X0 + HX;
  const T* __restrict__ ge = static_cast<const T*>(p.in0);
  const T* __restrict__ go = static_cast<const T*>(p.in1);
  T* __restrict__ dx = static_cast<T*>(p.out0);
  const int seq = p.seq, channels = p.channels, run = p.run_len;
  const bool has_e = ge != nullptr, has_o = go != nullptr;

  float we[HX + CHUNK][2], wo[HX + CHUNK][2];
  Raw<T> re[CHUNK], ro[CHUNK];
  auto load = [&](int t, Raw<T>& e, Raw<T>& o) {
    const long long off = base + (long long)t * channels;
    e = has_e ? load_pair<T>(ge + off, t, seq, second, vec, edge) : Raw<T>{};
    o = has_o ? load_pair<T>(go + off, t, seq, second, vec, edge) : Raw<T>{};
  };
#pragma unroll
  for (int i = 0; i < HX; ++i) {
    load(t0 - X1 + i, re[i], ro[i]);
    unpack(re[i], we[i]);
    unpack(ro[i], wo[i]);
  }
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) load(t0 - X0 + c + i, re[i], ro[i]);
  };
  load_chunk(0);

#pragma unroll 1
  for (int c = 0; c < run; c += CHUNK) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      unpack(re[i], we[HX + i]);
      unpack(ro[i], wo[HX + i]);
    }
    if (c + CHUNK < run) load_chunk(c + CHUNK);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int r = i + X1 - off1<K>(k);
          acc[ch] = fmaf(f[k], odd_tap<K>(k) ? wo[r][ch] : we[r][ch], acc[ch]);
        }
      const int t = t0 + c + i;
      store_pair<T>(dx + base + (long long)t * channels, t, seq, 2.f * acc[0],
                              2.f * acc[1], second, vec, edge);
    }
#pragma unroll
    for (int r = 0; r < HX; ++r)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        we[r][ch] = we[CHUNK + r][ch];
        wo[r][ch] = wo[CHUNK + r][ch];
      }
  }
}

// Threads map linearly over (batch, run, channel pair), channel pair fastest, as in the
// forward. A thread of FUSED_VJP / DOWN_VJP writes its two channels' sums to `partial` at
// row batch * n_runs + run.
template <typename T, int MODE, int K>
__global__ void __launch_bounds__(THREADS) aa_vjp_kernel(const VjpArgs p) {
  const int item = blockIdx.x * THREADS + threadIdx.x;
  if (item >= p.items) return;
  const int pair = item % p.n_pairs;
  const int row = item / p.n_pairs;
  const int b = row / p.n_runs;
  const int c0 = 2 * pair;
  const int t0 = (row % p.n_runs) * p.run_len;
  const bool second = c0 + 1 < p.channels, vec = p.channels % 2 == 0;
  const long long base = (long long)b * p.seq * p.channels + c0;
  const int seq = p.seq, run = p.run_len;

  float f[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    f[k] = (k >= p.shift && k - p.shift < p.taps) ? __ldg(p.filt + k - p.shift) : 0.f;

  constexpr int X0 = off1<K>(0), HX = off1<K>(K - 1) - X0, X1 = X0 + HX;
  constexpr int Y0 = off2<K>(0), Y1 = off2<K>(K - 1);
  if constexpr (MODE == UP_VJP) {
    // rows read: t0 - X1 .. t0 + run - X0 - 1
    const bool edge = t0 - X1 < 0 || t0 + run - X0 > seq;
    up_vjp_thread<T, K>(p, f, base, t0, second, vec, edge);
    return;
  } else {
    float a2[2], ab[2], sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = min(c0 + c, p.channels - 1);
      const float a = expf(__ldg(p.log_alpha + ch));
      a2[c] = 2.f * a;
      ab[c] = a * (1.0f / (expf(__ldg(p.log_beta + ch)) + 1e-9f));
    }
    if constexpr (MODE == FUSED_VJP) {
      // rows read: x t0 - HX .. t0 + run + HX - 1; g t0 - X1 - Y1 .. t0 + run - X0 - Y0 - 1
      const bool edge = t0 - HX < 0 || t0 - X1 - Y1 < 0 || t0 + run + HX > seq ||
                        t0 + run - X0 - Y0 > seq;
      fused_vjp_thread<T, K>(p, f, a2, ab, base, t0, second, vec, edge, sa, sb);
    } else {
      // rows read: g t0 - Y1 .. t0 + run - Y0 - 1; y t0 .. t0 + run - 1
      const bool edge = t0 - Y1 < 0 || t0 + run - Y0 > seq;
      down_vjp_thread<T, K>(p, f, a2, ab, base, t0, second, vec, edge, sa, sb);
    }
    float* ps = p.partial + (long long)row * p.channels + c0;
    float* pb = ps + (long long)p.rows * p.channels;
    ps[0] = sa[0];
    pb[0] = sb[0];
    if (second) {
      ps[1] = sa[1];
      pb[1] = sb[1];
    }
  }
}

// dalpha and dbeta from the partial sums, in a fixed order (no atomics, so two calls give
// the same bits): thread (x, y) of a block sums rows y, y + RED_ROWS, ... of channel
// 32 * block + x, then a tree over y in shared memory.
constexpr int RED_CH = 32, RED_ROWS = 32;

__device__ __forceinline__ void store_scalar(void* p, int i, float v, int bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else      static_cast<float*>(p)[i] = v;
}

__global__ void __launch_bounds__(RED_CH * RED_ROWS)
aa_vjp_reduce(const float* __restrict__ partial, const float* __restrict__ log_alpha,
              const float* __restrict__ log_beta, void* d_alpha, void* d_beta, int rows,
              int channels, int alpha_bf16, int beta_bf16) {
  __shared__ float sh[2][RED_ROWS][RED_CH + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int ch = blockIdx.x * RED_CH + x;
  float sa = 0.f, sb = 0.f;
  if (ch < channels) {
    const float* pa = partial + ch;
    const float* pb = partial + (long long)rows * channels + ch;
    for (int r = y; r < rows; r += RED_ROWS) {
      sa += __ldg(pa + (long long)r * channels);
      sb += __ldg(pb + (long long)r * channels);
    }
  }
  sh[0][y][x] = sa;
  sh[1][y][x] = sb;
  __syncthreads();
#pragma unroll
  for (int s = RED_ROWS / 2; s > 0; s >>= 1) {
    if (y < s) {
      sh[0][y][x] += sh[0][y + s][x];
      sh[1][y][x] += sh[1][y + s][x];
    }
    __syncthreads();
  }
  if (y == 0 && ch < channels) {
    // dalpha = a inv_b sum dz y sin(2ay); dbeta = -e^beta inv_b^2 sum dz sin^2(ay)
    const float a = expf(log_alpha[ch]), e_b = expf(log_beta[ch]);
    const float inv_b = 1.0f / (e_b + 1e-9f);
    store_scalar(d_alpha, ch, sh[0][0][x] * (a * inv_b), alpha_bf16);
    store_scalar(d_beta, ch, 0.5f * sh[1][0][x] * (-e_b * inv_b * inv_b), beta_bf16);
  }
}

template <typename T, int MODE, int K>
int launch_vjp(VjpArgs p, int batch, void* d_alpha, void* d_beta, int alpha_bf16,
               int beta_bf16, cudaStream_t stream) {
  p.n_runs = (p.seq + p.run_len - 1) / p.run_len;
  p.n_pairs = (p.channels + 1) / 2;
  const long long rows = (long long)batch * p.n_runs;
  const long long items = rows * p.n_pairs;
  if (items > 0x7fffffffLL - THREADS) return (int)cudaErrorInvalidConfiguration;
  p.rows = int(rows);
  p.items = int(items);
  p.shift = pad_left<K>() - (p.taps - 1) / 2;
  aa_vjp_kernel<T, MODE, K><<<unsigned((items + THREADS - 1) / THREADS), THREADS, 0, stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err != 0 || MODE == UP_VJP) return err;
  aa_vjp_reduce<<<(p.channels + RED_CH - 1) / RED_CH, dim3(RED_CH, RED_ROWS), 0, stream>>>(
      p.partial, p.log_alpha, p.log_beta, d_alpha, d_beta, p.rows, p.channels, alpha_bf16,
      beta_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_vjp_taps(const VjpArgs& p, int batch, void* d_alpha, void* d_beta, int alpha_bf16,
                    int beta_bf16, cudaStream_t s) {
  switch (p.taps) {
    case 12: return launch_vjp<T, MODE, 12>(p, batch, d_alpha, d_beta, alpha_bf16, beta_bf16, s);
    case 8:  return launch_vjp<T, MODE, 8>(p, batch, d_alpha, d_beta, alpha_bf16, beta_bf16, s);
    case 6:  return launch_vjp<T, MODE, 6>(p, batch, d_alpha, d_beta, alpha_bf16, beta_bf16, s);
    default:
      return launch_vjp<T, MODE, MAX_TAPS>(p, batch, d_alpha, d_beta, alpha_bf16, beta_bf16, s);
  }
}

template <int MODE>
int dispatch_vjp(const VjpArgs& p, int batch, int dtype, void* d_alpha, void* d_beta,
                 int alpha_dtype, int beta_dtype, void* stream) {
  if (p.taps < 1 || p.taps > MAX_TAPS || batch < 1 || p.seq < 1 || p.channels < 1 ||
      p.run_len < CHUNK || p.run_len % CHUNK != 0 || (MODE != UP_VJP && p.g == nullptr) ||
      (p.in0 == nullptr && p.in1 == nullptr) || alpha_dtype < 0 || alpha_dtype > 1 ||
      beta_dtype < 0 || beta_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vjp_taps<float, MODE>(p, batch, d_alpha, d_beta, alpha_dtype, beta_dtype, s);
  if (dtype == 1)
    return launch_vjp_taps<__nv_bfloat16, MODE>(p, batch, d_alpha, d_beta, alpha_dtype,
                                                beta_dtype, s);
  return (int)cudaErrorInvalidValue;
}

VjpArgs vjp_args(const void* in0, const void* in1, const void* g, const void* alpha,
                 const void* beta, const void* filt, void* out0, void* out1, void* partial,
                 int seq, int channels, int taps, int run_len) {
  VjpArgs p{};
  p.in0 = in0;
  p.in1 = in1;
  p.g = g;
  p.log_alpha = static_cast<const float*>(alpha);
  p.log_beta = static_cast<const float*>(beta);
  p.filt = static_cast<const float*>(filt);
  p.out0 = out0;
  p.out1 = out1;
  p.partial = static_cast<float*>(partial);
  p.seq = seq;
  p.channels = channels;
  p.taps = taps;
  p.run_len = run_len;
  return p;
}

}  // namespace

// All tensors (B, T, C) contiguous; alpha/beta (C,) f32 log-scale; filt (taps,) f32.
// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
extern "C" int sf_aa_snake_fused(const void* x, const void* alpha, const void* beta,
                                 const void* filt, void* out, int batch, int seq,
                                 int channels, int taps, int dtype, void* stream) {
  return dispatch<FUSED>(x, nullptr, nullptr, alpha, beta, filt, out, nullptr, nullptr,
                         batch, seq, channels, taps, dtype, stream);
}

extern "C" int sf_aa_upsample_fir(const void* x, const void* filt, void* y_even,
                                  void* y_odd, int batch, int seq, int channels, int taps,
                                  int dtype, void* stream) {
  return dispatch<UPSAMPLE>(x, nullptr, nullptr, nullptr, nullptr, filt, nullptr, y_even,
                            y_odd, batch, seq, channels, taps, dtype, stream);
}

extern "C" int sf_aa_snake_downsample(const void* y_even, const void* y_odd,
                                      const void* alpha, const void* beta,
                                      const void* filt, void* out, int batch, int seq,
                                      int channels, int taps, int dtype, void* stream) {
  return dispatch<DOWN>(nullptr, y_even, y_odd, alpha, beta, filt, out, nullptr, nullptr,
                        batch, seq, channels, taps, dtype, stream);
}

// The VJPs. Cotangents and gradients (B, T, C) contiguous in the inputs' dtype; alpha/beta
// (C,) f32 log-scale; d_alpha / d_beta (C,) in alpha_dtype / beta_dtype (0 = float32,
// 1 = bfloat16); partial: 2 * B * ceil(T / run_len) * C floats of scratch; run_len a
// multiple of 8. Each returns the cudaError_t of its launches (the kernel, then the
// reduction of dalpha and dbeta).
extern "C" int sf_aa_snake_fused_vjp(const void* x, const void* g, const void* alpha,
                                     const void* beta, const void* filt, void* dx,
                                     void* d_alpha, void* d_beta, void* partial, int batch,
                                     int seq, int channels, int taps, int run_len, int dtype,
                                     int alpha_dtype, int beta_dtype, void* stream) {
  return dispatch_vjp<FUSED_VJP>(
      vjp_args(x, nullptr, g, alpha, beta, filt, dx, nullptr, partial, seq, channels, taps,
               run_len),
      batch, dtype, d_alpha, d_beta, alpha_dtype, beta_dtype, stream);
}

extern "C" int sf_aa_snake_downsample_vjp(const void* y_even, const void* y_odd,
                                          const void* g, const void* alpha, const void* beta,
                                          const void* filt, void* dy_even, void* dy_odd,
                                          void* d_alpha, void* d_beta, void* partial,
                                          int batch, int seq, int channels, int taps,
                                          int run_len, int dtype, int alpha_dtype,
                                          int beta_dtype, void* stream) {
  return dispatch_vjp<DOWN_VJP>(
      vjp_args(y_even, y_odd, g, alpha, beta, filt, dy_even, dy_odd, partial, seq, channels,
               taps, run_len),
      batch, dtype, d_alpha, d_beta, alpha_dtype, beta_dtype, stream);
}

// g_even or g_odd may be null (a zero cotangent), not both.
extern "C" int sf_aa_upsample_fir_vjp(const void* g_even, const void* g_odd, const void* filt,
                                      void* dx, int batch, int seq, int channels, int taps,
                                      int run_len, int dtype, void* stream) {
  return dispatch_vjp<UP_VJP>(
      vjp_args(g_even, g_odd, nullptr, nullptr, nullptr, filt, dx, nullptr, nullptr, seq,
               channels, taps, run_len),
      batch, dtype, nullptr, nullptr, 0, 0, stream);
}
