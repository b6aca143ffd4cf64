// MFCC fingerprint kernels for Hopper (sm_90a), FFT route: power-of-two
// windows of N = 64..4096 samples (every profile; other windows take the
// DFT route in mfcc.cu).
//
// K1 tiresias_mfcc_rows_fft replaces tiresias_tpu/ops/mfcc_pallas.py::
// _mfcc_kernel (driven by _mfcc_rows): pre-framed rows [R, N] ->
// fingerprint [R, n_coefs]. It serves every search query (3 s -> 94 frames
// in a 128-frame bucket) and short ingest clips.
//
// K2 tiresias_mfcc_framed_fft replaces mfcc_pallas.py::_framing_kernel
// (driven by _fingerprint_framed): float PCM [B, S] -> [B, S/hop, n_coefs]
// with N = 2*hop. Frame f covers samples [(f-1)*hop, (f+1)*hop), zeros
// before t0; each block copies its window of (frames_per_block+1)*hop
// samples from device memory once, with 16-byte loads, and reads every
// frame as an overlapping view of it.
//
// Both compute the function of the Pallas kernels, not their method. The
// TPU kernels write the windowed DFT as a [rows, N] x [N, N/2+1] product
// because the MXU makes products cheap; on the H100 the chain must stay
// float32 (TF32 and bf16 miss the 1e-4 dB bound), and that product costs
// ~263k FP32 FMA per 512-sample frame. A real FFT needs ~15k operations per
// frame for the whole chain, so the work drops ~35x and the function's
// bound becomes its bytes (the frames or PCM read once, 3.35 TB/s). What
// bounds these kernels instead is instruction throughput: every FFT pass, the
// split, the mel sums and the DCT exchange data through shared memory, and
// each exchange costs loads, stores and address arithmetic beside the
// floating-point work (PERF.md section 6).
//
// Design, one warp per frame, every size a template constant (M = N/2 =
// 32..2048), so the loops unroll and the index arithmetic folds:
//  * pack: z[m] = x[2m]*w[2m] + i*x[2m+1]*w[2m+1], M points (one 8-byte
//    load per point, coalesced across the warp);
//  * an M-point complex Stockham FFT in radix-8 passes ending in one or two
//    radix-4 passes (M = 256: 8, 8, 4). Each pass, a lane takes butterfly
//    j's points at j + r*M/radix, turns them by twiddles from a table,
//    transforms them in registers (radix-2 DIF butterflies with exact
//    eighth-turn rotations) and writes them in natural order into the
//    other of two shared-memory buffers (re and im planes, one float of
//    padding every 32, so the strided writes of the first passes spread
//    over the banks);
//  * split into bins 0..M: X[k] = E + W^k O and X[M-k] = conj(E - W^k O)
//    from the same loads of Z[k] and Z[M-k]; DC and Nyquist exactly
//    Re Z[0] +- Im Z[0]; then |X[k]|;
//  * the mel bank over each filter's [first, last] non-zero bins, summed in
//    ascending bin order (a bin lies in at most two Slaney filters; the
//    dense sum's zero terms are dropped, which leaves it unchanged);
//    safe_log10;
//  * the paired DCT terms of common.cuh on all lanes, each coefficient's
//    terms then summed in order on one lane.
// Every table (window, twiddles, split twiddles, mel weights) is built on
// the host in float64 and rounded to float32: no sincos on the card, no
// --use_fast_math, no flush to zero. An all-zero frame gives exactly zero in
// every bin, hence the exact floor. FP32 FMA/ADD only: no tensor cores.
#include "common.cuh"

namespace tiresias {

// Warps (frames in flight) per block: K1 small enough that a 128-row query
// spreads over 32 blocks; K2 larger, to amortise the block's signal window.
constexpr int kRowsWarps = 4;
constexpr int kFramedWarps = 8;
constexpr int kFramedWarpsLarge = 4;  // M > 512: each warp holds 33 KB
constexpr int kMaxFramesPerBlock = 16;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kSqrtHalf = 0.70710678118654752f;  // float32(sqrt(0.5))

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int ilog2(int m) {
  return m <= 1 ? 0 : 1 + ilog2(m / 2);
}

// Floats of shared memory per warp: two buffers of M complex points (re and
// im planes, padded) and the frame's log-mel row.
__host__ __device__ constexpr int warp_floats(int m, int n_filters) {
  return 4 * (m + (m >> 5)) + ((n_filters + 3) & ~3);
}

// (tr + i ti) * exp(-2 pi i eighths / 8), eighths = 0..3, exactly as
// _rotate in ops/mfcc_kernels.py.
__device__ __forceinline__ void rotate(float tr, float ti, int eighths,
                                       float& xr, float& xi) {
  switch (eighths) {
    case 0: xr = tr; xi = ti; break;
    case 1: xr = (tr + ti) * kSqrtHalf; xi = (ti - tr) * kSqrtHalf; break;
    case 2: xr = ti; xi = -tr; break;
    default: xr = (ti - tr) * kSqrtHalf; xi = -(tr + ti) * kSqrtHalf; break;
  }
}

// In-register radix-2 DIF DFT of R = 4 or 8 points: X[k] ends at bitrev(k).
template <int R>
__device__ __forceinline__ void dft_dif(float (&vr)[R], float (&vi)[R]) {
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int base = 0; base < R; base += 2 * h) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const int a = base + i, b = a + h;
        const float tr = vr[a] - vr[b], ti = vi[a] - vi[b];
        vr[a] += vr[b];
        vi[a] += vi[b];
        rotate(tr, ti, i * 8 / (2 * h), vr[b], vi[b]);
      }
    }
  }
}

template <int R>
__device__ __forceinline__ constexpr int bitrev(int k) {
  return R == 8 ? ((k & 1) << 2) | (k & 2) | ((k >> 2) & 1)
                : ((k & 1) << 1) | ((k >> 1) & 1);
}

// One Stockham pass of radix R over M points; NS is the product of the
// earlier passes' radices. The first pass (NS == 1) reads the frame itself
// and applies the window; later passes read the previous buffer and turn
// point r of butterfly j by tw[(j % NS) * r * M / (NS * R)]. Every size is
// a template constant, so the loops unroll and the index arithmetic folds.
template <int M, int R, int NS>
__device__ __forceinline__ void fft_pass(
    const float2* src, const float2* __restrict__ win2, const float* in_re,
    const float* in_im, float* out_re, float* out_im,
    const float2* __restrict__ tw, int lane) {
  constexpr int Q = M / R;
  constexpr int TSTEP = M / (NS * R);
#pragma unroll
  for (int j0 = 0; j0 < Q; j0 += 32) {
    const int j = j0 + lane;
    if (Q % 32 && j >= Q) break;  // M < 32 * R: some lanes idle
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = j + r * Q;
      if (NS == 1) {
        const float2 x = src[e];
        const float2 w = __ldg(win2 + e);
        vr[r] = x.x * w.x;
        vi[r] = x.y * w.y;
      } else {
        vr[r] = in_re[pad(e)];
        vi[r] = in_im[pad(e)];
      }
    }
    const int jm = j & (NS - 1);
    if (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(tw + jm * r * TSTEP);
        const float a = vr[r], b = vi[r];
        vr[r] = a * w.x - b * w.y;
        vi[r] = a * w.y + b * w.x;
      }
    }
    dft_dif<R>(vr, vi);
    const int dst = (j - jm) * R + jm;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int e = pad(dst + k * NS);
      out_re[e] = vr[bitrev<R>(k)];
      out_im[e] = vi[bitrev<R>(k)];
    }
  }
}

// Passes after the first: radix 8 while LEFT8 > 0, then LEFT4 radix-4
// passes, alternating buffers. Returns the buffer that holds Z.
template <int M, int NS, int LEFT8, int LEFT4>
__device__ __forceinline__ float* later_passes(float* cre, float* ore,
                                               int padm,
                                               const float2* __restrict__ tw,
                                               int lane) {
  if constexpr (LEFT8 + LEFT4 == 0) {
    return cre;
  } else {
    constexpr int R = LEFT8 > 0 ? 8 : 4;
    __syncwarp();
    fft_pass<M, R, NS>(nullptr, nullptr, cre, cre + padm, ore, ore + padm,
                       tw, lane);
    return later_passes<M, NS * R, (LEFT8 > 0 ? LEFT8 - 1 : 0),
                        (LEFT8 > 0 ? LEFT4 : LEFT4 - 1)>(ore, cre, padm, tw,
                                                          lane);
  }
}

// The whole chain for one frame of N = 2*M samples at src (8-byte aligned,
// device or shared memory) on one warp; `ws` is the warp's shared memory
// (warp_floats), `out` the frame's n_coefs outputs.
template <int M>
__device__ __forceinline__ void fft_mfcc_frame(
    const float2* src, const float2* __restrict__ win2,
    const float2* __restrict__ tw, const float2* __restrict__ tws,
    const int* __restrict__ mel_idx, const float* __restrict__ mel_w,
    int n_filters, const float* __restrict__ dct_t, int n_coefs, float* ws,
    float* __restrict__ out, int lane) {
  constexpr int PADM = M + (M >> 5);
  // passes: radix 8 while it divides, then one radix 4 (log2 M % 3 == 2)
  // or two (== 1); fft_radices() in ops/mfcc_kernels.py lists the same
  constexpr int L = ilog2(M);
  constexpr int N4 = L % 3 == 0 ? 0 : 3 - L % 3;
  constexpr int N8 = (L - 2 * N4) / 3;
  float* a = ws;
  float* b = ws + 2 * PADM;
  float* logm = ws + 4 * PADM;
  fft_pass<M, 8, 1>(src, win2, nullptr, nullptr, a, a + PADM, tw, lane);
  const float* zr = later_passes<M, 8, N8 - 1, N4>(a, b, PADM, tw, lane);
  const float* zi = zr + PADM;
  float* mags = zr == a ? b : a;  // the free buffer
  __syncwarp();
  // split Z into bins 0..M: X[k] = E + W^k O and X[M-k] = conj(E - W^k O)
  // share their loads, so each lane takes k = 1..M/2; DC and Nyquist are
  // Re Z[0] +- Im Z[0] exactly
  if (lane == 0) {
    mags[0] = fabsf(zr[0] + zi[0]);
    mags[M] = fabsf(zr[0] - zi[0]);
  }
#pragma unroll
  for (int k0 = 1; k0 <= M / 2; k0 += 32) {
    const int k = k0 + lane;
    if ((M / 2) % 32 && k > M / 2) break;
    const float ar = zr[pad(k)], ai = zi[pad(k)];
    const float br = zr[pad(M - k)], bi = -zi[pad(M - k)];
    const float er = (ar + br) * 0.5f, ei = (ai + bi) * 0.5f;
    const float odr = (ai - bi) * 0.5f, odi = (br - ar) * 0.5f;
    const float2 w = __ldg(tws + k);
    const float wr = w.x * odr - w.y * odi;
    const float wi = w.x * odi + w.y * odr;
    const float xr = er + wr, xi = ei + wi;
    mags[k] = sqrtf(xr * xr + xi * xi);
    if (k < M / 2) {
      const float yr = er - wr, yi = ei - wi;
      mags[M - k] = sqrtf(yr * yr + yi * yi);
    }
  }
  __syncwarp();
  for (int j = lane; j < n_filters; j += 32) {
    const int lo = __ldg(mel_idx + 3 * j);
    const int hi = __ldg(mel_idx + 3 * j + 1);
    const float* w = mel_w + __ldg(mel_idx + 3 * j + 2) - lo;
    float s = 0.f;
#pragma unroll 4
    for (int k = lo; k <= hi; ++k) s = fmaf(mags[k], __ldg(w + k), s);
    logm[j] = safe_log10(s);
  }
  __syncwarp();
  // DCT: the terms of every coefficient on all lanes into the free Z
  // buffer, then each coefficient sums its terms in order on one lane (the
  // same sums as dct_log_coef, which takes over when they do not fit)
  float* terms = const_cast<float*>(zr);
  const int n_terms = (n_filters + 1) / 2;
  if (n_terms * n_coefs <= 2 * PADM) {
    for (int o = lane; o < n_terms * n_coefs; o += 32) {
      const int c = o / n_terms;
      terms[o] = dct_term(logm, n_filters, dct_t, n_coefs, c,
                          o - c * n_terms);
    }
    __syncwarp();
    for (int c = lane; c < n_coefs; c += 32) {
      float s = 0.f;
      for (int j = 0; j < n_terms; ++j) {
        s = __fadd_rn(s, terms[c * n_terms + j]);
      }
      out[c] = 10.f * safe_log10(fabsf(s));
    }
  } else {
    for (int c = lane; c < n_coefs; c += 32) {
      out[c] = dct_log_coef(logm, n_filters, dct_t, n_coefs, c);
    }
  }
  __syncwarp();  // the buffers are free for the warp's next frame
}

template <int M>
__global__ void __launch_bounds__(32 * kRowsWarps)
    mfcc_rows_fft_kernel(const float* __restrict__ frames, int rows,
                         const float2* __restrict__ win2,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ tws,
                         const int* __restrict__ mel_idx,
                         const float* __restrict__ mel_w, int n_filters,
                         const float* __restrict__ dct_t, int n_coefs,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsWarps + warp;
  if (row >= rows) return;  // no block-wide barrier follows
  fft_mfcc_frame<M>(
      reinterpret_cast<const float2*>(frames + (size_t)row * 2 * M), win2,
      tw, tws, mel_idx, mel_w, n_filters, dct_t, n_coefs,
      smem + warp * warp_floats(M, n_filters), out + (size_t)row * n_coefs,
      lane);
}

// K2 with hop = M (the window spans two hops).
template <int M>
__global__ void __launch_bounds__(32 * kFramedWarps)
    mfcc_framed_fft_kernel(const float* __restrict__ pcm, int n_samples,
                           int n_frames, int frames_per_block,
                           const float2* __restrict__ win2,
                           const float2* __restrict__ tw,
                           const float2* __restrict__ tws,
                           const int* __restrict__ mel_idx,
                           const float* __restrict__ mel_w, int n_filters,
                           const float* __restrict__ dct_t, int n_coefs,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = (frames_per_block + 1) * M;  // a multiple of 4
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * frames_per_block;
  const int n_valid = min(frames_per_block, n_frames - f0);
  const long start = (long)(f0 - 1) * M;  // frame f0 starts one hop early
  const float* sig = pcm + (size_t)b * n_samples;
  // start and n_samples are multiples of 4: a float4 is all in or all out
  float4* win = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < span / 4; i += blockDim.x) {
    const long s = start + 4L * i;
    win[i] = (s >= 0 && s < n_samples)
                 ? *reinterpret_cast<const float4*>(sig + s)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  float* ws = smem + span + warp * warp_floats(M, n_filters);
  for (int f = warp; f < n_valid; f += warps) {
    fft_mfcc_frame<M>(reinterpret_cast<const float2*>(smem + f * M), win2,
                      tw, tws, mel_idx, mel_w, n_filters, dct_t, n_coefs, ws,
                      out + ((size_t)b * n_frames + f0 + f) * n_coefs, lane);
  }
}

template <int M>
cudaError_t launch_rows(const void* frames, int rows, const void* win2,
                        const void* tw, const void* tws, const void* mel_idx,
                        const void* mel_w, int n_filters, const void* dct_t,
                        int n_coefs, void* out, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kRowsWarps * (size_t)warp_floats(M, n_filters);
  cudaError_t err = set_smem(mfcc_rows_fft_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kRowsWarps - 1) / kRowsWarps);
  mfcc_rows_fft_kernel<M><<<grid, 32 * kRowsWarps, smem, stream>>>(
      (const float*)frames, rows, (const float2*)win2, (const float2*)tw,
      (const float2*)tws, (const int*)mel_idx, (const float*)mel_w,
      n_filters, (const float*)dct_t, n_coefs, (float*)out);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_framed(const void* pcm, int batch, int n_samples,
                          int n_frames, const void* win2, const void* tw,
                          const void* tws, const void* mel_idx,
                          const void* mel_w, int n_filters, const void* dct_t,
                          int n_coefs, void* out, cudaStream_t stream) {
  const int warps = M <= 512 ? kFramedWarps : kFramedWarpsLarge;
  const size_t per_warps = (size_t)warps * warp_floats(M, n_filters);
  int fpb = kMaxFramesPerBlock;
  while (fpb > 1 &&
         sizeof(float) * ((size_t)(fpb + 1) * M + per_warps) > kMaxSmem) {
    fpb /= 2;
  }
  const size_t smem = sizeof(float) * ((size_t)(fpb + 1) * M + per_warps);
  cudaError_t err = set_smem(mfcc_framed_fft_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + fpb - 1) / fpb, batch);
  mfcc_framed_fft_kernel<M><<<grid, 32 * warps, smem, stream>>>(
      (const float*)pcm, n_samples, n_frames, fpb, (const float2*)win2,
      (const float2*)tw, (const float2*)tws, (const int*)mel_idx,
      (const float*)mel_w, n_filters, (const float*)dct_t, n_coefs,
      (float*)out);
  return cudaGetLastError();
}

}  // namespace tiresias

// The windows the FFT kernels take: N = 64..4096, M = N / 2.
#define TIRESIAS_FFT_SIZES(X) \
  X(32) X(64) X(128) X(256) X(512) X(1024) X(2048)

extern "C" int tiresias_mfcc_rows_fft(const void* frames, int rows, int n_fft,
                                      const void* win2, const void* tw,
                                      const void* tws, const void* mel_idx,
                                      const void* mel_w, int n_filters,
                                      const void* dct_t, int n_coefs,
                                      void* out, void* stream) {
  using namespace tiresias;
  switch (n_fft / 2 * (n_fft % 2 == 0)) {
#define TIRESIAS_CASE(M)                                                  \
  case M:                                                                 \
    return (int)launch_rows<M>(frames, rows, win2, tw, tws, mel_idx,      \
                               mel_w, n_filters, dct_t, n_coefs, out,     \
                               (cudaStream_t)stream);
    TIRESIAS_FFT_SIZES(TIRESIAS_CASE)
#undef TIRESIAS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tiresias_mfcc_framed_fft(
    const void* pcm, int batch, int n_samples, int hop, int n_frames,
    const void* win2, const void* tw, const void* tws, const void* mel_idx,
    const void* mel_w, int n_filters, const void* dct_t, int n_coefs,
    void* out, void* stream) {
  using namespace tiresias;
  switch (hop) {
#define TIRESIAS_CASE(M)                                                  \
  case M:                                                                 \
    return (int)launch_framed<M>(pcm, batch, n_samples, n_frames, win2,   \
                                 tw, tws, mel_idx, mel_w, n_filters,      \
                                 dct_t, n_coefs, out, (cudaStream_t)stream);
    TIRESIAS_FFT_SIZES(TIRESIAS_CASE)
#undef TIRESIAS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
