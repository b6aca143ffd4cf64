// Shared device code of the fingerprint kernels (mfcc.cu).
//
// Numerics follow tiresias_tpu/ops/mfcc_pallas.py::_mfcc_chain: float32
// throughout, FP32 FMA only (no TF32, no bf16), and aubio's SAFE_LOG10 floor
// as a select on the exact constant log10(2e-42). The floor value is
// subnormal, so this file must never be built with -ftz=true or
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace tiresias {

// Frames (rows) per thread block of both MFCC kernels, in two groups of RG;
// each thread keeps the real and imaginary DFT sums of two bins for the RG
// rows of its group in registers.
constexpr int RT = 32;
constexpr int RG = RT / 2;
// Block size cap: 288 threads = 2 row groups x 129 bin pairs of a 512-point
// frame (one pass; larger frames loop over their bin pairs). With two
// resident blocks per SM (__launch_bounds__ in mfcc.cu) the compiler keeps
// the 64 sums in <= 113 registers; measured on an H100, two blocks per SM
// run the chain 1.3x faster than one block with unbounded registers.
constexpr int kMaxThreads = 288;
constexpr int kMinBlocksPerSM = 2;

constexpr float kFloorThreshold = 1e-37f;
constexpr float kLog10Floor = -41.69897000433602f;  // float32(log10(2e-42))

__device__ __forceinline__ float safe_log10(float x) {
  return x >= kFloorThreshold ? log10f(fmaxf(x, kFloorThreshold))
                              : kLog10Floor;
}

// The windowed-DFT -> |.| -> mel -> safe_log10 -> DCT -> 10*log10|.| chain
// for RT frames held in shared memory. Frame r starts at fr + r*row_stride
// and holds `win` samples (row_stride == win for pre-framed rows; == hop for
// the overlapping frames of an in-kernel-framed signal window). `mags`
// (RT*n_bins floats) and `logm` (RT*n_filters floats) are shared-memory
// scratch. Writes the first n_valid rows to out[r*n_coefs + c].
//
// Both kernels call this one function, so a numerics change reaches both.
__device__ __forceinline__ void mfcc_chain(
    const float* fr, int row_stride, int win, int n_valid,
    const float* __restrict__ dft_re, const float* __restrict__ dft_im,
    int n_bins, const float* __restrict__ mel_t, int n_filters,
    const float* __restrict__ dct_t, int n_coefs, float* mags, float* logm,
    float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // 1. windowed DFT as a matrix product. The block's threads form two row
  //    groups (rows 0..RG-1 and RG..RT-1); each thread owns two bins, p and
  //    p + n_pairs, for its group's RG rows: 4*RG sums in registers. Frame
  //    samples are broadcast float4 loads from shared memory (16 per 256
  //    FMAs: each 128-bit shared load occupies the shared-memory pipe for
  //    four cycles, so this ratio keeps the pipe and the FMA units evenly
  //    loaded); the window-folded cos/sin columns stream through the
  //    read-only cache, coalesced across the warp's bins.
  const int n_pairs = (n_bins + 1) / 2;
  for (int p0 = 0; p0 < n_pairs; p0 += nt / 2) {
    const int slot = tid % (nt / 2);
    const int p = p0 + slot;
    const int g = tid / (nt / 2);
    const int k1 = p + n_pairs;
    if (p < n_pairs && g < 2) {
      const int k1c = k1 < n_bins ? k1 : p;  // a valid column, not stored
      const float* x0 = fr + g * RG * row_stride;
      float re0[RG], im0[RG], re1[RG], im1[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        re0[r] = 0.f;
        im0[r] = 0.f;
        re1[r] = 0.f;
        im1[r] = 0.f;
      }
      for (int n = 0; n < win; n += 4) {
        float a[4], b[4], c[4], d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = __ldg(dft_re + (n + j) * n_bins + p);
          b[j] = __ldg(dft_im + (n + j) * n_bins + p);
          c[j] = __ldg(dft_re + (n + j) * n_bins + k1c);
          d[j] = __ldg(dft_im + (n + j) * n_bins + k1c);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(x0 + r * row_stride + n);
          re0[r] = fmaf(x.x, a[0], re0[r]);
          re0[r] = fmaf(x.y, a[1], re0[r]);
          re0[r] = fmaf(x.z, a[2], re0[r]);
          re0[r] = fmaf(x.w, a[3], re0[r]);
          im0[r] = fmaf(x.x, b[0], im0[r]);
          im0[r] = fmaf(x.y, b[1], im0[r]);
          im0[r] = fmaf(x.z, b[2], im0[r]);
          im0[r] = fmaf(x.w, b[3], im0[r]);
          re1[r] = fmaf(x.x, c[0], re1[r]);
          re1[r] = fmaf(x.y, c[1], re1[r]);
          re1[r] = fmaf(x.z, c[2], re1[r]);
          re1[r] = fmaf(x.w, c[3], re1[r]);
          im1[r] = fmaf(x.x, d[0], im1[r]);
          im1[r] = fmaf(x.y, d[1], im1[r]);
          im1[r] = fmaf(x.z, d[2], im1[r]);
          im1[r] = fmaf(x.w, d[3], im1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float* m = mags + (g * RG + r) * n_bins;
        m[p] = sqrtf(re0[r] * re0[r] + im0[r] * im0[r]);
        if (k1 < n_bins) m[k1] = sqrtf(re1[r] * re1[r] + im1[r] * im1[r]);
      }
    }
  }
  __syncthreads();
  // 2. mel filterbank + safe_log10
  for (int o = tid; o < RT * n_filters; o += nt) {
    const int r = o / n_filters;
    const int j = o - r * n_filters;
    const float* m = mags + r * n_bins;
    float s = 0.f;
    for (int k = 0; k < n_bins; ++k) {
      s = fmaf(m[k], __ldg(mel_t + k * n_filters + j), s);
    }
    logm[o] = safe_log10(s);
  }
  __syncthreads();
  // 3. DCT + 10*safe_log10(|.|), valid rows only. Filters j and
  //    n_filters-1-j are summed as a pair of separately rounded products
  //    (no FMA contraction): the DCT-II rows are exactly (anti)symmetric
  //    in float32, so a constant log-mel row (digital silence, every
  //    filter at the floor) gives exactly 0 and the exact floor value, as
  //    the JAX chain does, instead of rounding noise of ~1e-6.
  const int half = n_filters / 2;
  for (int o = tid; o < n_valid * n_coefs; o += nt) {
    const int r = o / n_coefs;
    const int c = o - r * n_coefs;
    const float* l = logm + r * n_filters;
    float s = 0.f;
    for (int j = 0; j < half; ++j) {
      const int jj = n_filters - 1 - j;
      const float pair =
          __fadd_rn(__fmul_rn(l[j], __ldg(dct_t + j * n_coefs + c)),
                    __fmul_rn(l[jj], __ldg(dct_t + jj * n_coefs + c)));
      s = __fadd_rn(s, pair);
    }
    if (n_filters % 2) {
      s = __fadd_rn(s, __fmul_rn(l[half], __ldg(dct_t + half * n_coefs + c)));
    }
    out[o] = 10.f * safe_log10(fabsf(s));
  }
}

}  // namespace tiresias
