// Fused MFCC fingerprint kernels for Hopper (sm_90a).
//
// K1 tiresias_mfcc_rows replaces tiresias_tpu/ops/mfcc_pallas.py::_mfcc_kernel
// (driven by _mfcc_rows): pre-framed rows [R, win] -> fingerprint
// [R, n_coefs]. It serves every search query (3 s -> 94 frames in a 128-frame
// bucket) and short ingest clips.
//
// K2 tiresias_mfcc_framed replaces mfcc_pallas.py::_framing_kernel (driven by
// _fingerprint_framed): float PCM [B, S] -> [B, S/hop, n_coefs] with the 2x
// overlapped frames assembled in shared memory. Frame f covers samples
// [(f-1)*hop, (f+1)*hop), zeros before t0; each block copies its window of
// (RT+1)*hop samples from device memory once and reads every frame as an
// overlapping view of it, so no frame tensor is ever written.
//
// What bounds them on the H100: FP32 FMA throughput. The window-folded DFT
// is a [RT, win] x [win, n_bins] product per block (~263k FMA per 512-sample
// frame; mel and DCT add ~4%), against ~2 KB (K1) or ~1 KB (K2) of input per
// frame, so both are compute-bound far above the memory roofline. The design
// splits a block's RT rows into two groups; each thread keeps the partial
// sums of two bins for its group's rows in registers and feeds them from
// broadcast shared-memory float4 loads (16 FMA per shared load) while the
// 1 MB of DFT constants stream through the read-only cache. Tensor cores are
// deliberately unused: TF32 or bf16 inputs move the log-log fingerprint by
// up to +-0.03 (PARITY.md section 2), so this is FP32 FMA by design.
#include "common.cuh"

namespace tiresias {

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSM)
    mfcc_rows_kernel(const float* __restrict__ frames, int rows, int win,
                     const float* __restrict__ dft_re,
                     const float* __restrict__ dft_im, int n_bins,
                     const float* __restrict__ mel_t, int n_filters,
                     const float* __restrict__ dct_t, int n_coefs,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* fr = smem;                  // RT * win
  float* mags = fr + RT * win;       // RT * n_bins
  float* logm = mags + RT * n_bins;  // RT * n_filters
  const int row0 = blockIdx.x * RT;
  const int n_valid = min(RT, rows - row0);
  const int w4 = win / 4;
  const float4* src =
      reinterpret_cast<const float4*>(frames + (size_t)row0 * win);
  float4* dst = reinterpret_cast<float4*>(fr);
  for (int i = threadIdx.x; i < RT * w4; i += blockDim.x) {
    dst[i] = (i / w4) < n_valid ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  mfcc_chain(fr, win, win, n_valid, dft_re, dft_im, n_bins, mel_t,
             n_filters, dct_t, n_coefs, mags, logm,
             out + (size_t)row0 * n_coefs);
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSM)
    mfcc_framed_kernel(const float* __restrict__ pcm, int n_samples, int hop,
                       int n_frames, const float* __restrict__ dft_re,
                       const float* __restrict__ dft_im, int n_bins,
                       const float* __restrict__ mel_t, int n_filters,
                       const float* __restrict__ dct_t, int n_coefs,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int span = (RT + 1) * hop;
  float* fr = smem;                  // the block's signal window
  float* mags = fr + span;           // RT * n_bins
  float* logm = mags + RT * n_bins;  // RT * n_filters
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * RT;
  const int n_valid = min(RT, n_frames - f0);
  const long start = (long)(f0 - 1) * hop;  // frame f0 starts one hop early
  const float* sig = pcm + (size_t)b * n_samples;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long s = start + i;
    fr[i] = (s >= 0 && s < n_samples) ? sig[s] : 0.f;
  }
  __syncthreads();
  mfcc_chain(fr, hop, 2 * hop, n_valid, dft_re, dft_im, n_bins, mel_t,
             n_filters, dct_t, n_coefs, mags, logm,
             out + ((size_t)b * n_frames + f0) * n_coefs);
}

// Two row groups x ceil(n_bins / 2) bin pairs, rounded up to whole warps.
inline int block_threads(int n_bins) {
  const int t = ((n_bins + 1) / 2 * 2 + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tiresias

extern "C" int tiresias_mfcc_rows(const void* frames, int rows, int win,
                                  const void* dft_re, const void* dft_im,
                                  int n_bins, const void* mel_t,
                                  int n_filters, const void* dct_t,
                                  int n_coefs, void* out, void* stream) {
  using namespace tiresias;
  const size_t smem = sizeof(float) * RT * (size_t)(win + n_bins + n_filters);
  cudaError_t err = set_smem(mfcc_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + RT - 1) / RT);
  mfcc_rows_kernel<<<grid, block_threads(n_bins), smem,
                     (cudaStream_t)stream>>>(
      (const float*)frames, rows, win, (const float*)dft_re,
      (const float*)dft_im, n_bins, (const float*)mel_t, n_filters,
      (const float*)dct_t, n_coefs, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int tiresias_mfcc_framed(const void* pcm, int batch, int n_samples,
                                    int hop, int n_frames, const void* dft_re,
                                    const void* dft_im, int n_bins,
                                    const void* mel_t, int n_filters,
                                    const void* dct_t, int n_coefs, void* out,
                                    void* stream) {
  using namespace tiresias;
  const size_t smem =
      sizeof(float) * ((size_t)(RT + 1) * hop + RT * (size_t)(n_bins + n_filters));
  cudaError_t err = set_smem(mfcc_framed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + RT - 1) / RT, batch);
  mfcc_framed_kernel<<<grid, block_threads(n_bins), smem,
                       (cudaStream_t)stream>>>(
      (const float*)pcm, n_samples, hop, n_frames, (const float*)dft_re,
      (const float*)dft_im, n_bins, (const float*)mel_t, n_filters,
      (const float*)dct_t, n_coefs, (float*)out);
  return (int)cudaGetLastError();
}
