// K-b candidate selection and the dialplan rescore for Hopper (sm_90a).
//
// 1. select_candidates replaces jax.lax.approx_max_k(bound, k) and the exact
//    unselected maximum after it, in every certified prefilter
//    (tiresias_tpu/ops/match_lattice.py::_prefilter_core, :592-596, and
//    ops/match_pallas.py::aligned_prefiltered_votes, :559-564):
//
//      idx[b, :]         the k rows of highest bound[b, :], ascending;
//      unselected_max[b] the highest bound among the other rows, -1 if none.
//
//    The selection is exact, where approx_max_k may miss rows on the TPU
//    (recall 0.99); an exact selection only certifies more often. Ties are
//    fixed: with v the k-th highest value, every row above v is taken, then
//    the rows equal to v in ascending row order until k. So unselected_max
//    is v when a row equal to v is left out, else the highest value below v.
//
//    A bound is -1 outside the context, else a count of query frames: small
//    and non-negative. What bounds it on the H100: reading bound, B*A*4
//    bytes (4 MB at one query and 1,000,000 rows), in three launches:
//     - kb_select_hist_kernel: each CTA bins one chunk of a row into a
//       shared histogram of kBins bins (one per value in [-1, kTop], one
//       below, one above), warp-aggregated with __match_any_sync since most
//       rows share a few small values, and writes it as uint16 counts up to
//       its highest non-empty bin (its chunk's maximum beside it);
//     - kb_select_finish_kernel: one CTA per row sums the chunks' bins in
//       use, finds the bin of the k-th value by a suffix scan, and each
//       chunk's counts above it and equal to it, then their exclusive
//       prefixes over the chunks. Where the k-th value falls in the bin
//       below -1 or above kTop (long queries), a radix select over the row
//       (four 8-bit passes, one CTA) finds it exactly and the counts come
//       from a pass over the row;
//     - kb_select_compact_kernel: each CTA re-reads its chunk (from L2 at
//       these sizes), one block scan per 4,096-row tile places each chosen
//       row in ascending order, and the highest unchosen value goes to
//       unselected_max by one atomicMax per CTA (the finish kernel set it
//       to INT_MIN, or -1 when k = A).
//
// 2. rescore_rows replaces the dialplan rescore vm[idx] and the einsum of
//    _prefilter_core (match_lattice.py:603-607), with its context mask
//    (:608-609) folded in:
//
//      votes_k[b, j] = sum_c counts[b, c] * (vm[idx[b, j], c] <= tol),
//
//    0 where ctx_ids[idx[b, j]] != ctx_id. NaN is never <= tol. Bounded by
//    the gathered float32 rows, B*k*K*4 bytes (42 MB at [64, 256, 640]):
//    the histogram stays in shared memory, one warp reads a candidate row
//    with 16-byte loads (contiguous row gathers) and reduces by shuffles.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBins = 2048;          // bin 0: below -1; 1 + (x + 1); above
constexpr int kTop = kBins - 4;      // the highest value with a bin of its own
constexpr int kThreads = 512;        // hist and compact CTAs
constexpr int kIpt = 8;              // rows a thread holds in the compaction
constexpr int kTile = kThreads * kIpt;
constexpr int kMaxTiles = 15;        // a chunk's counts fit in uint16
constexpr int kMaxChunks = 1024;     // chunks a row, one per finish thread
constexpr int kFinishThreads = 1024;
constexpr int kTargetCtas = 264;     // two CTAs per SM over the batch
constexpr int kRescoreThreads = 256;

__device__ __forceinline__ int bin_of(int x) {
  return x < -1 ? 0 : (x > kTop ? kBins - 1 : x + 2);
}

// One histogram increment per distinct bin in the warp: every lane calls
// it (bin -1: nothing to add).
__device__ __forceinline__ void add_bin(unsigned* h, int bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], __popc(peers));
}

// Exclusive scan of x over the block (blockDim.x a multiple of 32); `ws`
// holds 32 words of shared scratch. Synchronises before returning, so ws
// may be reused at once.
template <typename T>
__device__ __forceinline__ T block_excl_scan(T x, T* ws, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? ws[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  const T out = incl - x + (warp > 0 ? ws[warp - 1] : T(0));
  *total = ws[n_warps - 1];
  __syncthreads();
  return out;
}

// Launch 1: one CTA per (chunk, row). hist [B][n_chunks][kBins] uint16, of
// which bins 0 .. cmax (rounded up to a pair) are written; cmax
// [B][n_chunks] the chunk's highest non-empty bin.
__global__ void __launch_bounds__(kThreads)
    kb_select_hist_kernel(const int* __restrict__ bound, int rows, int chunk,
                          int n_chunks, uint32_t* __restrict__ hist,
                          int* __restrict__ cmax) {
  __shared__ unsigned h[kBins];
  __shared__ int s_max;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < kBins; i += kThreads) h[i] = 0;
  if (tid == 0) s_max = 0;
  __syncthreads();
  const int b = blockIdx.y, c = blockIdx.x;
  const int* row = bound + (size_t)b * rows;
  const int start = c * chunk;
  const int end = min(start + chunk, rows);
  int my_max = 0;
  // warp-uniform trip counts: every lane reaches each __match_any_sync
  for (int w0 = start + (tid & ~31); w0 < end; w0 += 4 * kThreads) {
    int bins[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = w0 + u * kThreads + lane;
      bins[u] = i < end ? bin_of(__ldg(row + i)) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      my_max = max(my_max, bins[u]);
      add_bin(h, bins[u]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    my_max = max(my_max, __shfl_xor_sync(0xffffffffu, my_max, d));
  if (lane == 0) atomicMax(&s_max, my_max);
  __syncthreads();
  const int m = s_max;
  uint32_t* out = hist + ((size_t)b * n_chunks + c) * (kBins / 2);
  for (int p = tid; 2 * p <= m; p += kThreads)
    out[p] = h[2 * p] | (h[2 * p + 1] << 16);
  if (tid == 0) cmax[(size_t)b * n_chunks + c] = m;
}

// Exact k-th highest value of row[0, n) by four 8-bit radix passes over
// order-preserving keys, one CTA. Returns it in *v and, in *need, how many
// rows equal to it the selection takes (k minus the rows above it).
__device__ void radix_select(const int* __restrict__ row, int n, int k,
                             unsigned* h256, int* s_pick, int* v,
                             int* need) {
  const int tid = threadIdx.x;
  unsigned prefix = 0, mask = 0;
  int rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) h256[i] = 0;
    __syncthreads();
    for (int w0 = tid & ~31; w0 < n; w0 += blockDim.x) {
      const int i = w0 + (tid & 31);
      int bin = -1;
      if (i < n) {
        const unsigned u = (unsigned)row[i] ^ 0x80000000u;
        if ((u & mask) == prefix) bin = (u >> shift) & 255;
      }
      add_bin(h256, bin);
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0, d = 255;
      for (; d > 0; --d) {
        if (acc + (int)h256[d] >= rem) break;
        acc += h256[d];
      }
      s_pick[0] = d;
      s_pick[1] = rem - acc;
    }
    __syncthreads();
    prefix |= (unsigned)s_pick[0] << shift;
    mask |= 255u << shift;
    rem = s_pick[1];
    __syncthreads();
  }
  *v = (int)(prefix ^ 0x80000000u);
  *need = rem;
}

// Launch 2: one CTA per row. info [B][2] = (v, rows equal to v taken);
// base [B][n_chunks][2] = rows above v and rows equal to v in the chunks
// before; unsel [B] = INT_MIN, or -1 when k = rows (nothing is left).
__global__ void __launch_bounds__(kFinishThreads)
    kb_select_finish_kernel(const int* __restrict__ bound, int rows, int k,
                            int chunk, int n_chunks,
                            const uint32_t* __restrict__ hist,
                            const int* __restrict__ cmax,
                            int* __restrict__ info, int* __restrict__ base,
                            int* __restrict__ unsel) {
  __shared__ unsigned tot[kBins];
  __shared__ int s_cmax[kMaxChunks];
  __shared__ unsigned s_gt[kMaxChunks], s_eq[kMaxChunks];
  __shared__ unsigned h256[256];
  __shared__ unsigned long long ws64[32];
  __shared__ int s_pick[2];
  __shared__ int s_nb, s_t, s_above, s_v, s_need;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = kFinishThreads / 32;
  const int b = blockIdx.x;
  const int* row = bound + (size_t)b * rows;
  const uint32_t* hb = hist + (size_t)b * n_chunks * (kBins / 2);
  const uint16_t* hb16 = reinterpret_cast<const uint16_t*>(hb);
  // the bins in use: up to the highest chunk maximum
  if (tid == 0) s_nb = 0;
  for (int i = tid; i < kBins; i += kFinishThreads) tot[i] = 0;
  __syncthreads();
  int m = 0;
  for (int c = tid; c < n_chunks; c += kFinishThreads) {
    s_cmax[c] = cmax[(size_t)b * n_chunks + c];
    m = max(m, s_cmax[c]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (lane == 0) atomicMax(&s_nb, m + 1);
  __syncthreads();
  const int nb = s_nb;
  // sum the chunks: thread (pair p, group g) adds pair p of every G-th chunk
  {
    const int n_pairs = (nb + 1) / 2;
    const int groups = kFinishThreads / n_pairs;
    const int p = tid % n_pairs, g = tid / n_pairs;
    if (g < groups) {
      unsigned lo = 0, hi = 0;
      for (int c = g; c < n_chunks; c += groups) {
        if (2 * p <= s_cmax[c]) {
          const uint32_t w = hb[(size_t)c * (kBins / 2) + p];
          lo += w & 0xffffu;
          hi += w >> 16;
        }
      }
      if (lo) atomicAdd(&tot[2 * p], lo);
      if (hi) atomicAdd(&tot[2 * p + 1], hi);
    }
  }
  __syncthreads();
  // the bin t of the k-th value: suffix sums from the top, two bins a thread
  {
    const int b0 = nb - 1 - 2 * tid, b1 = b0 - 1;
    const unsigned c0 = b0 >= 0 ? tot[b0] : 0u;
    const unsigned c1 = b1 >= 0 ? tot[b1] : 0u;
    unsigned long long total;
    const unsigned long long before =
        block_excl_scan<unsigned long long>(c0 + c1, ws64, &total);
    if (b0 >= 0 && before < (unsigned)k && before + c0 >= (unsigned)k) {
      s_t = b0;
      s_above = (int)before;
    } else if (b1 >= 0 && before + c0 < (unsigned)k &&
               before + c0 + c1 >= (unsigned)k) {
      s_t = b1;
      s_above = (int)(before + c0);
    }
  }
  __syncthreads();
  const int t = s_t;
  if (t > 0 && t < kBins - 1) {
    // an exact bin: v = t - 2; each chunk's counts above and at t, a warp
    // per chunk
    for (int c = warp; c < n_chunks; c += n_warps) {
      const int top = min(s_cmax[c], kBins - 1);
      unsigned gt = 0, eq = 0;
      for (int i = t + lane; i <= top; i += 32) {
        const unsigned n = hb16[(size_t)c * kBins + i];
        if (i == t) eq = n;
        else gt += n;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        gt += __shfl_xor_sync(0xffffffffu, gt, d);
        eq += __shfl_xor_sync(0xffffffffu, eq, d);
      }
      if (lane == 0) {
        s_gt[c] = gt;
        s_eq[c] = eq;
      }
    }
    if (tid == 0) {
      s_v = t - 2;
      s_need = k - s_above;
    }
  } else {
    // below -1 or above kTop: a radix select over the row, then each
    // chunk's counts by a warp per chunk
    int v, need;
    radix_select(row, rows, k, h256, s_pick, &v, &need);
    for (int c = warp; c < n_chunks; c += n_warps) {
      const int start = c * chunk, end = min(start + chunk, rows);
      unsigned gt = 0, eq = 0;
      for (int w0 = start; w0 < end; w0 += 32) {
        const int i = w0 + lane;
        const int x = i < end ? row[i] : INT_MIN;
        gt += __popc(__ballot_sync(0xffffffffu, i < end && x > v));
        eq += __popc(__ballot_sync(0xffffffffu, i < end && x == v));
      }
      if (lane == 0) {
        s_gt[c] = gt;
        s_eq[c] = eq;
      }
    }
    if (tid == 0) {
      s_v = v;
      s_need = need;
    }
  }
  __syncthreads();
  // each chunk's prefix over the chunks before it (n_chunks <= threads)
  {
    const unsigned long long x =
        tid < n_chunks ? ((unsigned long long)s_gt[tid] << 32) | s_eq[tid]
                       : 0ull;
    unsigned long long total;
    const unsigned long long pre =
        block_excl_scan<unsigned long long>(x, ws64, &total);
    if (tid < n_chunks) {
      int* out = base + ((size_t)b * n_chunks + tid) * 2;
      out[0] = (int)(pre >> 32);
      out[1] = (int)(pre & 0xffffffffu);
    }
  }
  if (tid == 0) {
    info[2 * b] = s_v;
    info[2 * b + 1] = s_need;
    unsel[b] = k == rows ? -1 : INT_MIN;
  }
}

// Launch 3: one CTA per (chunk, row); idx [B][k] int32.
__global__ void __launch_bounds__(kThreads)
    kb_select_compact_kernel(const int* __restrict__ bound, int rows, int k,
                             int chunk, int n_chunks,
                             const int* __restrict__ info,
                             const int* __restrict__ base,
                             int* __restrict__ idx, int* __restrict__ unsel) {
  __shared__ unsigned ws[32];
  __shared__ int s_umax;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, c = blockIdx.x;
  const int* row = bound + (size_t)b * rows;
  int* out = idx + (size_t)b * k;
  const int v = info[2 * b], need = info[2 * b + 1];
  const int* cb = base + ((size_t)b * n_chunks + c) * 2;
  int gt_run = cb[0], eq_run = cb[1];
  const int start = c * chunk, end = min(start + chunk, rows);
  if (tid == 0) s_umax = INT_MIN;
  __syncthreads();
  int umax = INT_MIN;
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int i0 = t0 + tid * kIpt;
    int x[kIpt];
    unsigned lgt = 0, leq = 0;
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      x[j] = i0 + j < end ? __ldg(row + i0 + j) : INT_MIN;
      lgt += i0 + j < end && x[j] > v;
      leq += i0 + j < end && x[j] == v;
    }
    unsigned total;
    const unsigned pre = block_excl_scan<unsigned>((lgt << 16) | leq, ws,
                                                   &total);
    int gt_b = gt_run + (int)(pre >> 16), eq_b = eq_run + (int)(pre & 0xffffu);
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      if (i0 + j >= end) break;
      if (x[j] > v) {
        out[gt_b + min(eq_b, need)] = i0 + j;
        ++gt_b;
      } else if (x[j] == v) {
        if (eq_b < need) out[gt_b + eq_b] = i0 + j;
        else umax = max(umax, x[j]);
        ++eq_b;
      } else {
        umax = max(umax, x[j]);
      }
    }
    gt_run += (int)(total >> 16);
    eq_run += (int)(total & 0xffffu);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    umax = max(umax, __shfl_xor_sync(0xffffffffu, umax, d));
  if (lane == 0 && umax != INT_MIN) atomicMax(&s_umax, umax);
  __syncthreads();
  if (tid == 0 && s_umax != INT_MIN) atomicMax(unsel + b, s_umax);
}

// The chunking of a row: enough CTAs to cover the card, whole tiles, at
// most kMaxTiles tiles (uint16 counts) and kMaxChunks chunks a row.
int select_plan(int batch, int rows, int* chunk, int* n_chunks) {
  if (batch < 1 || rows < 1) return -1;
  const long long total = (long long)batch * rows;
  const long long want = (total + kTargetCtas - 1) / kTargetCtas;
  long long tiles = (want + kTile - 1) / kTile;
  const long long min_tiles =
      ((long long)rows + (long long)kMaxChunks * kTile - 1) /
      ((long long)kMaxChunks * kTile);
  tiles = tiles < min_tiles ? min_tiles : tiles;
  if (tiles > kMaxTiles) {
    if (min_tiles > kMaxTiles) return -1;
    tiles = kMaxTiles;
  }
  *chunk = (int)(tiles * kTile);
  *n_chunks = (rows + *chunk - 1) / *chunk;
  return 0;
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct SelectScratch {
  size_t hist, cmax, info, base, total;
};

SelectScratch select_scratch(int batch, int n_chunks) {
  SelectScratch s;
  s.hist = 0;
  s.cmax = align256((size_t)batch * n_chunks * kBins * 2);
  s.info = s.cmax + align256((size_t)batch * n_chunks * 4);
  s.base = s.info + align256((size_t)batch * 2 * 4);
  s.total = s.base + align256((size_t)batch * n_chunks * 2 * 4);
  return s;
}

__global__ void __launch_bounds__(kRescoreThreads)
    rescore_rows_kernel(const float* __restrict__ vm, int k_size,
                        const int* __restrict__ counts,
                        const int* __restrict__ idx, int k, float tol,
                        const int* __restrict__ ctx_ids, int ctx_id,
                        int rows_per_block, int vec,
                        int* __restrict__ votes) {
  extern __shared__ __align__(16) int cs[];  // the histogram [k_size]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int* cb = counts + (size_t)b * k_size;
  for (int i = tid; i < k_size; i += kRescoreThreads) cs[i] = cb[i];
  __syncthreads();
  const int j0 = blockIdx.x * rows_per_block;
  const int j1 = min(j0 + rows_per_block, k);
  for (int j = j0 + warp; j < j1; j += kRescoreThreads / 32) {
    const int r = idx[(size_t)b * k + j];
    if (ctx_ids != nullptr && ctx_ids[r] != ctx_id) {
      if (lane == 0) votes[(size_t)b * k + j] = 0;
      continue;
    }
    const float* m = vm + (size_t)r * k_size;
    int s = 0;
    if (vec) {
      const float4* m4 = reinterpret_cast<const float4*>(m);
      const int4* c4 = reinterpret_cast<const int4*>(cs);
      for (int q = lane; q < k_size / 4; q += 32) {
        const float4 d = __ldg(m4 + q);
        const int4 n = c4[q];
        s += (d.x <= tol ? n.x : 0) + (d.y <= tol ? n.y : 0) +
             (d.z <= tol ? n.z : 0) + (d.w <= tol ? n.w : 0);
      }
    } else {
      for (int q = lane; q < k_size; q += 32)
        s += __ldg(m + q) <= tol ? cs[q] : 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) votes[(size_t)b * k + j] = s;
  }
}

}  // namespace

// Scratch bytes of one select_candidates call ([batch, rows] bounds), or
// -1 when the row is too long for the chunking (more than 62,914,560 rows).
extern "C" long long tiresias_select_scratch(int batch, int rows) {
  int chunk, n_chunks;
  if (select_plan(batch, rows, &chunk, &n_chunks) != 0) return -1;
  return (long long)select_scratch(batch, n_chunks).total;
}

// bound [batch][rows] int32; idx [batch][k] int32; unsel [batch] int32;
// scratch of tiresias_select_scratch bytes. Three launches.
extern "C" int tiresias_select_candidates(const void* bound, int batch,
                                          int rows, int k, void* scratch,
                                          void* idx, void* unsel,
                                          void* stream) {
  int chunk, n_chunks;
  if (k < 1 || k > rows || select_plan(batch, rows, &chunk, &n_chunks) != 0)
    return (int)cudaErrorInvalidValue;
  const SelectScratch s = select_scratch(batch, n_chunks);
  char* sc = (char*)scratch;
  uint32_t* hist = (uint32_t*)(sc + s.hist);
  int* cmax = (int*)(sc + s.cmax);
  int* info = (int*)(sc + s.info);
  int* base = (int*)(sc + s.base);
  const cudaStream_t st = (cudaStream_t)stream;
  const int* bd = (const int*)bound;
  kb_select_hist_kernel<<<dim3(n_chunks, batch), kThreads, 0, st>>>(
      bd, rows, chunk, n_chunks, hist, cmax);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  kb_select_finish_kernel<<<batch, kFinishThreads, 0, st>>>(
      bd, rows, k, chunk, n_chunks, hist, cmax, info, base, (int*)unsel);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  kb_select_compact_kernel<<<dim3(n_chunks, batch), kThreads, 0, st>>>(
      bd, rows, k, chunk, n_chunks, info, base, (int*)idx, (int*)unsel);
  return (int)cudaGetLastError();
}

// value_map [rows][k_size] float32; counts [batch][k_size] int32; idx
// [batch][k] int32 rows of value_map; ctx_ids: null, or [rows] int32 (0
// votes where ctx_ids != ctx_id); votes [batch][k] int32.
extern "C" int tiresias_rescore_rows(const void* value_map, int k_size,
                                     const void* counts, const void* idx,
                                     int batch, int k, float tol,
                                     const void* ctx_ids, int ctx_id,
                                     void* votes, void* stream) {
  if (batch < 1 || k < 1 || k_size < 1 || k_size > 12 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)batch * k;
  int rpb = (int)((items + kTargetCtas - 1) / kTargetCtas);
  rpb = ((rpb + 7) / 8) * 8;
  rpb = rpb < 8 ? 8 : (rpb > 64 ? 64 : rpb);
  const int vec = k_size % 4 == 0 && ((uintptr_t)value_map & 15) == 0;
  const size_t smem = (size_t)k_size * 4;
  rescore_rows_kernel<<<dim3((k + rpb - 1) / rpb, batch), kRescoreThreads,
                        smem, (cudaStream_t)stream>>>(
      (const float*)value_map, k_size, (const int*)counts, (const int*)idx,
      k, tol, (const int*)ctx_ids, ctx_id, rpb, vec, (int*)votes);
  return (int)cudaGetLastError();
}
