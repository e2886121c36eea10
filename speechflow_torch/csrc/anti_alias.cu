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
__device__ __forceinline__ float cos_reduced(float w) {
  const float n = rintf(w * 0.15915494309189535f);
  float r = fmaf(-n, 6.28125f, w);
  r = fmaf(-n, 1.9353071795864769e-3f, r);
  return __cosf(r);
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
