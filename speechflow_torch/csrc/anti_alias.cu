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
//   fused     x -> out            (stages 1-3; the 2x intermediate stays in shared memory)
//   upsample  x -> (y_even, y_odd) (stage 1; shared by the branches of an MRF group)
//   down      (y_even, y_odd) -> out (stages 2-3)
//
// What bounds it on the H100: about 4K + 10 f32 operations per output sample (K = 12:
// ~58) against 2 * sizeof(T) bytes moved, i.e. ~7 operations per byte in f32, below the
// card's ~20 f32 operations per byte: it is bound by bytes. The design therefore reads
// each input once and writes each output once: a block covers (batch, 128-sample time
// tile, 32-channel slab), loads its haloed input window into shared memory with
// coalesced reads along channels (the layout is channels-last, (B, T, C)), computes the
// phase signals and their snake there, and only the result leaves the block. Halo rows
// are re-read by the neighbouring tile (K/128 extra reads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CS = 32;        // channels per block (one warp spans them)
constexpr int TT = 128;       // output samples per block
constexpr int TY = 8;         // thread rows; block = CS x TY threads
constexpr int THREADS = CS * TY;
constexpr int MAX_TAPS = 16;

enum Mode { FUSED = 0, UPSAMPLE = 1, DOWN = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// margin of the stage-1 window around the output tile, and of the input window
// around the stage-1 window: every polyphase shift lies in [-K/2, K/2]
__host__ __device__ __forceinline__ int margin(int taps) { return taps / 2 + 1; }

__host__ __device__ __forceinline__ int mid_margin(int mode, int taps) {
  return mode == UPSAMPLE ? 0 : margin(taps);
}

size_t smem_bytes(int mode, int taps) {
  const int mm = mid_margin(mode, taps);
  const int lm = TT + 2 * mm;
  const int lx = mode == DOWN ? 0 : lm + 2 * margin(taps);
  const int lz = mode == UPSAMPLE ? 0 : 2 * lm;
  return sizeof(float) * (size_t(lx) + size_t(lz)) * CS;
}

// TAPS > 0 fixes the tap count at compile time, so the tap loops unroll and each
// tap's phase is known; TAPS == 0 takes it from `taps` at run time.
template <typename T, int MODE, int TAPS>
__global__ void __launch_bounds__(THREADS)
aa_kernel(const T* __restrict__ x, const T* __restrict__ ye_in, const T* __restrict__ yo_in,
          const float* __restrict__ log_alpha, const float* __restrict__ log_beta,
          const float* __restrict__ filt, T* __restrict__ out, T* __restrict__ ye_out,
          T* __restrict__ yo_out, int seq, int channels, int runtime_taps) {
  extern __shared__ float smem[];
  __shared__ float f[MAX_TAPS];
  const int taps = TAPS > 0 ? TAPS : runtime_taps;

  const int M = margin(taps);
  const int MM = mid_margin(MODE, taps);
  const int LM = TT + 2 * MM;                 // stage-1 rows this block computes
  const int LX = MODE == DOWN ? 0 : LM + 2 * M;
  float* xs = smem;                           // LX x CS input window
  float* ze = xs + LX * CS;                   // LM x CS even phase (after the snake)
  float* zo = ze + LM * CS;                   // LM x CS odd phase

  const int cl = threadIdx.x % CS;
  const int ty = threadIdx.x / CS;
  const int c0 = blockIdx.x * CS;
  const int c = c0 + cl;
  const int t0 = blockIdx.y * TT;
  const long long bbase = (long long)blockIdx.z * seq * channels;
  const int p = (taps - 1) / 2;               // XLA SAME pad_left of the equivalent conv

  if (threadIdx.x < taps) f[threadIdx.x] = filt[threadIdx.x];

  float a = 0.f, inv_b = 0.f;
  if (MODE != UPSAMPLE && c < channels) {
    a = expf(log_alpha[c]);
    inv_b = 1.0f / (expf(log_beta[c]) + 1e-9f);
  }

  if (MODE != DOWN) {
    const int xs0 = t0 - MM - M;              // global time of xs row 0
    for (int idx = threadIdx.x; idx < LX * CS; idx += THREADS) {
      const int r = idx / CS, cc = c0 + idx % CS;
      const int t = xs0 + r;
      xs[idx] = (t >= 0 && t < seq && cc < channels)
                    ? to_f(x[bbase + (long long)t * channels + cc]) : 0.f;
    }
  }
  __syncthreads();

  if (MODE != DOWN) {
    // stage 1: mid row i is global stage-1 index tm = t0 - MM + i
    for (int i = ty; i < LM; i += TY) {
      const int tm = t0 - MM + i;
      float ye = 0.f, yo = 0.f;
#pragma unroll
      for (int k = 0; k < taps; ++k) {
        const int kp = k - p;
        if ((kp & 1) == 0) ye = fmaf(2.f * f[k], xs[(i + M + kp / 2) * CS + cl], ye);
        else               yo = fmaf(2.f * f[k], xs[(i + M + (kp + 1) / 2) * CS + cl], yo);
      }
      if (MODE == UPSAMPLE) {
        if (tm < seq && c < channels) {
          const long long o = bbase + (long long)tm * channels + c;
          ye_out[o] = from_f<T>(ye);
          yo_out[o] = from_f<T>(yo);
        }
      } else {
        if (tm < 0 || tm >= seq) { ye = 0.f; yo = 0.f; }  // zeroed before the snake
        const float se = sinf(a * ye), so = sinf(a * yo);
        ze[i * CS + cl] = ye + inv_b * se * se;
        zo[i * CS + cl] = yo + inv_b * so * so;
      }
    }
  } else {
    // load both phases on the stage-1 window (zero outside [0, T)), then the snake
    const int tm0 = t0 - MM;
    for (int idx = threadIdx.x; idx < LM * CS; idx += THREADS) {
      const int r = idx / CS;
      const int t = tm0 + r;
      float ye = 0.f, yo = 0.f;
      if (t >= 0 && t < seq && c < channels) {
        const long long o = bbase + (long long)t * channels + c;
        ye = to_f(ye_in[o]);
        yo = to_f(yo_in[o]);
      }
      // idx % CS == cl because THREADS is a multiple of CS
      const float se = sinf(a * ye), so = sinf(a * yo);
      ze[idx] = ye + inv_b * se * se;
      zo[idx] = yo + inv_b * so * so;
    }
  }
  if (MODE == UPSAMPLE) return;
  __syncthreads();

  // stages 2+3: out[t] = sum_k f[k] z[2t + k - p], folded onto the two phases
  for (int i = ty; i < TT; i += TY) {
    const int t = t0 + i;
    if (t >= seq || c >= channels) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < taps; ++k) {
      const int kp = k - p;
      if ((kp & 1) == 0) acc = fmaf(f[k], ze[(i + MM + kp / 2) * CS + cl], acc);
      else               acc = fmaf(f[k], zo[(i + MM + (kp - 1) / 2) * CS + cl], acc);
    }
    out[bbase + (long long)t * channels + c] = from_f<T>(acc);
  }
}

template <typename T, int MODE, int TAPS>
int launch(const void* x, const void* ye_in, const void* yo_in, const void* alpha,
           const void* beta, const void* filt, void* out, void* ye_out, void* yo_out,
           int batch, int seq, int channels, int taps, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, taps);
  cudaError_t err = cudaFuncSetAttribute(aa_kernel<T, MODE, TAPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((channels + CS - 1) / CS, (seq + TT - 1) / TT, batch);
  aa_kernel<T, MODE, TAPS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ye_in), static_cast<const T*>(yo_in),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(filt), static_cast<T*>(out), static_cast<T*>(ye_out),
      static_cast<T*>(yo_out), seq, channels, taps);
  return (int)cudaGetLastError();
}

// the tap counts the JAX package uses (12 by default, 8 and 6 for training) unrolled
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
      return launch<T, MODE, 0>(x, ye_in, yo_in, alpha, beta, filt, out, ye_out, yo_out,
                                batch, seq, channels, taps, s);
  }
}

template <int MODE>
int dispatch(const void* x, const void* ye_in, const void* yo_in, const void* alpha,
             const void* beta, const void* filt, void* out, void* ye_out, void* yo_out,
             int batch, int seq, int channels, int taps, int dtype, void* stream) {
  if (taps < 1 || taps > MAX_TAPS || batch < 1 || seq < 1 || channels < 1)
    return (int)cudaErrorInvalidValue;
  if ((seq + TT - 1) / TT > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
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
