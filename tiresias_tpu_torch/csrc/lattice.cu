// Lattice vote kernel K3' for Hopper (sm_90a).
//
// Replaces the fused XLA contraction of
// tiresias_tpu/ops/match_lattice.py::_hit_matmul (reached from lattice_votes):
//
//   votes[b, a] = sum_k counts[b, k] * (value_map[a, k] <= tol)
//
// with the query histogram counts [B, K] int32 and the per-audio lattice
// distance map value_map [A, K] float32. On the TPU, XLA fused the compare
// into the matmul's operand read; a plain framework matmul would write and
// read back an [A, K] hit matrix per search (26 MB at 10k tracks). Here the
// hits exist only as 0/1 ints in shared memory.
//
// What bounds it on the H100: reading value_map once per batch tile (A*K*4
// bytes; the B*A*K int multiply-adds are far below the card's rate), so it
// is memory-bound. Each block stages a 16-row x 64-bucket tile of the map
// through shared memory (one float4 per thread, 256 contiguous bytes per
// row), converts it to hits there, and reuses it for a 64-query tile of
// counts; each thread owns one row and four queries. Small row tiles give
// ~630 blocks at 10k tracks, enough loads in flight to cover the latency.
// Sums are int32, so counts are exact. +inf rows (padding and tombstones)
// never satisfy <= tol, and NaN never does either.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int AT = 16;  // audio rows per block
constexpr int BT = 64;  // queries per block
constexpr int KT = 64;  // lattice buckets per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lattice_votes_kernel(const int* __restrict__ counts,
                         const float* __restrict__ value_map, int batch,
                         int rows, int k_size, float tol,
                         int* __restrict__ votes) {
  __shared__ int hs[AT][KT + 1];  // +1: conflict-free column reads
  __shared__ int cs[BT][KT + 1];
  const int a0 = blockIdx.x * AT;
  const int b0 = blockIdx.y * BT;
  const int ta = threadIdx.x % AT;  // this thread's row a0 + ta
  const int tb = threadIdx.x / AT;  // and queries b0 + tb*4 + i
  const int nb = min(BT, batch - b0);  // queries in this block's tile
  // threads whose four query rows all lie past the batch skip the products
  // (whole warps do at small batch); rows past nb in a busy thread read
  // stale tile entries and are never stored
  const bool busy = tb * 4 < nb;
  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < k_size; k0 += KT) {
    // the map tile: one float4 of one row per thread (16 threads cover a
    // row's 64 buckets: 256 contiguous bytes)
    {
      const int r = threadIdx.x / (KT / 4), k4 = threadIdx.x % (KT / 4);
      const int a = a0 + r, k = k0 + 4 * k4;
      float v[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
      if (a < rows) {
        const float* src = value_map + (size_t)a * k_size + k;
        if (k + 3 < k_size && (k_size % 4) == 0) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
          for (int j = 0; j < 4; ++j)
            if (k + j < k_size) v[j] = src[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) hs[r][4 * k4 + j] = v[j] <= tol ? 1 : 0;
    }
    // the counts tile: only the queries this block has (a batch-1 search
    // must not pay for 63 empty query rows)
    for (int i = threadIdx.x; i < nb * KT; i += kThreads) {
      const int r = i / KT, kk = i % KT;
      const int k = k0 + kk;
      cs[r][kk] = k < k_size ? counts[(size_t)(b0 + r) * k_size + k] : 0;
    }
    __syncthreads();
    if (busy) {
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const int h = hs[ta][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += cs[tb * 4 + i][kk] * h;
      }
    }
    __syncthreads();
  }
  const int a = a0 + ta;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + tb * 4 + i;
    if (b < batch && a < rows) votes[(size_t)b * rows + a] = acc[i];
  }
}

}  // namespace

extern "C" int tiresias_lattice_votes(const void* counts,
                                      const void* value_map, int batch,
                                      int rows, int k_size, float tol,
                                      void* votes, void* stream) {
  const dim3 grid((rows + AT - 1) / AT, (batch + BT - 1) / BT);
  lattice_votes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)value_map, batch, rows, k_size, tol,
      (int*)votes);
  return (int)cudaGetLastError();
}
