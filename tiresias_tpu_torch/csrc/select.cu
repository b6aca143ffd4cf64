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
//    and non-negative, with many ties. What bounds it on the H100: reading
//    bound, B*A*4 bytes (4 MB at one query and 1,000,000 rows). One launch
//    of one of two kernels (the plan, ops/match_lattice.py::select_plan);
//    no CTA serialises a row, and no state survives the launch.
//    kb_select_kernel: a thread-block cluster of 2-16 CTAs per row, each
//    CTA one slice, merged through distributed shared memory with no
//    global scratch. kb_select_grid_kernel (below): a long row at a small
//    batch, past what one cluster holds in shared memory, over the whole
//    card in a cooperative launch, one CTA an SM, merged through scratch
//    in L2 between grid barriers; the same levels and compaction.
//     - Pass 1 brings the slice into shared memory by 1-D bulk copies (TMA)
//       on up to 8 mbarriers and keeps the maximum of every 32 rows (a
//       group). A slice past shared memory (rows past ~860,000 at 16 CTAs)
//       streams through a ring of chunks, and later passes read its groups
//       from global memory (L2).
//     - tau, the slice's k-th highest group maximum, bounds v from below (k
//       rows reach it), so from here on only groups whose maximum reaches
//       tau are read: a long row's histogram and compaction touch a few
//       percent of it. A slice of fewer than k groups has no tau; pass 1
//       bins its rows itself.
//     - Level 0 bins each value of -1..2,044 on its own (everything below in
//       bin 0, above in bin 2,047), by shared atomics, or by sums in
//       registers where a warp's bins span fewer than 8. After one cluster
//       barrier, every CTA reads the bins any CTA used from every CTA's
//       histogram (distributed shared memory) and scans them for the bin of
//       the k-th value; the lower ranks' share of the same bins places its
//       rows.
//     - A bin with more than one value (below -1, above 2,044) is refined
//       11 bits at a time over its span: at most three more passes for any
//       int32, INT_MIN and INT_MAX included. A pass also counts the rows at
//       the bucket's top value, and stops there when they reach the k-th.
//     - An ordered compaction: each warp counts its groups' rows above and
//       at v, then writes them after the lower ranks' and warps'. The
//       unselected maximum is v, or comes from the row's histogram, or
//       else each CTA's highest row below v goes to rank 0.
//    Measured on the H100 (PERF.md): what bounds one 16-CTA cluster on a
//    long row is its 16 SMs' share of the memory rate, not the bytes: so a
//    row past one cluster's shared memory takes the cooperative route.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tiresias::mbar_init;
using tiresias::mbar_wait;
using tiresias::smem_u32;

constexpr int kBins = 2048;          // level 0: below -1; 1 + (x + 1); above
constexpr int kTop = kBins - 4;      // the highest value with a bin of its own
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;              // rows a lane holds in a tile
constexpr int kTile = kThreads * kPer;
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = 8;         // chunks (mbarriers) of a slice
constexpr int kGroups = 2048;        // group maxima a CTA keeps
constexpr int kNarrow = 8;           // a warp spanning fewer bins sums them
constexpr int kTargetCtas = 264;     // rescore: two CTAs per SM over the batch
constexpr int kRescoreThreads = 256;

static_assert(kThreads * 4 == kBins, "find_bin takes 4 bins a thread");

__device__ __forceinline__ unsigned key_of(int x) {
  return (unsigned)x ^ 0x80000000u;
}

__device__ __forceinline__ int bin0(int x) {
  return x < -1 ? 0 : (x > kTop ? kBins - 1 : x + 2);
}

// The two halves of a cluster barrier: arrive once done reading the other
// CTAs' shared memory, wait before leaving (a CTA's shared memory must
// outlive every read of it). The reads' values are used before the arrive,
// so they are complete: it needs no release.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One 1-D bulk copy global -> shared (16-byte aligned, a multiple of 16
// bytes), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Adds a lane's kPer bins (-1: none) to the histogram; every lane of the
// warp calls it, and [wlo, whi] grows to the bins it added. Where the warp's
// bins span fewer than kNarrow (-1 rows, ties at a few small counts), it
// sums them by bin in 16-bit fields of four registers and one redux each,
// and adds each bin once; else each lane adds its own, by shared atomics.
__device__ __forceinline__ void add_bins(unsigned* h, const int* bin,
                                         unsigned& wlo, unsigned& whi) {
  const unsigned lane = threadIdx.x & 31;
  unsigned lo = 0xffffffffu, hi = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (bin[j] >= 0) {
      lo = min(lo, (unsigned)bin[j]);
      hi = max(hi, (unsigned)bin[j]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  if (lo == 0xffffffffu) return;
  hi = __reduce_max_sync(0xffffffffu, hi);
  wlo = min(wlo, lo);
  whi = max(whi, hi);
  if (hi - lo < kNarrow) {
    unsigned c[kNarrow / 2] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned d = (unsigned)bin[j] - lo;  // >= kNarrow for -1
      const unsigned inc = 1u << ((d & 1u) * 16);
#pragma unroll
      for (int f = 0; f < kNarrow / 2; ++f)
        c[f] += d >> 1 == (unsigned)f ? inc : 0u;
    }
#pragma unroll
    for (int f = 0; f < kNarrow / 2; ++f)
      c[f] = __reduce_add_sync(0xffffffffu, c[f]);
    if (lane <= hi - lo) {
      unsigned w = c[0];
#pragma unroll
      for (int f = 1; f < kNarrow / 2; ++f)
        w = lane >> 1 == (unsigned)f ? c[f] : w;
      const unsigned n = (w >> ((lane & 1u) * 16)) & 0xffffu;
      if (n) atomicAdd(&h[lo + lane], n);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (bin[j] >= 0) atomicAdd(&h[bin[j]], 1u);
  }
}

// Exclusive scan of x over the block (blockDim.x a multiple of 32); `ws`
// holds 32 words of shared scratch. Synchronises before returning, so ws
// may be reused at once.
template <typename T>
__device__ __forceinline__ T block_excl_scan(T x, T* ws) {
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
  __syncthreads();
  return out;
}

// A CTA's slice and where its chunks land: position p of the slice's buffer
// is global row g0 + p (g0 the slice's first row rounded down to 16 bytes),
// rows [off, off + n) of it are the slice's own; chunk c holds positions
// [c * chunk, (c + 1) * chunk) in slot c % slots. A group is 32 positions
// (a warp's load); gm[u >> ms] is the highest row of groups u of the slice.
template <bool kStreamed>
struct Slice {
  int* data;
  uint64_t* bars;
  int* gm;
  const int* g0;
  int off, n, np, chunk, slots, n_chunks, units, ms;  // m = 1 << ms
};

template <bool kStreamed>
__device__ __forceinline__ void issue_chunk(const Slice<kStreamed>& s, int c) {
  const int p0 = c * s.chunk, p1 = min(p0 + s.chunk, s.np);
  const int slot = c % s.slots;
  bulk_load(s.data + slot * s.chunk, s.g0 + p0, (unsigned)(p1 - p0) * 4u,
            &s.bars[slot]);
}

// The first pass over the slice, a tile (kTile positions) at a time:
// body(x, valid, p) with a lane's kPer consecutive rows, x[j] at position
// p + j (lane l of warp w of the tile holds t0 + 256 w + 8 l ..), so four
// lanes hold a group. The chunks come in as it goes; a streamed slice
// reuses each slot once the block is done with it.
template <bool kStreamed, typename Body>
__device__ __forceinline__ void first_pass(const Slice<kStreamed>& s,
                                           Body body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the mbarriers are initialised
  if (threadIdx.x == 0)
    for (int c = 0; c < min(s.n_chunks, s.slots); ++c) issue_chunk(s, c);
  unsigned phases = 0;
  for (int c = 0; c < s.n_chunks; ++c) {
    const int slot = c % s.slots;
    mbar_wait(&s.bars[slot], (phases >> slot) & 1u);
    phases ^= 1u << slot;
    const int* buf = s.data + slot * s.chunk;
    const int p0 = c * s.chunk, p1 = min(p0 + s.chunk, s.np);
    for (int t0 = p0; t0 < p1; t0 += kTile) {
      const int p = t0 + warp * (kPer * 32) + lane * kPer;
      int x[kPer] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (p < p1) {
        const int4 a = *reinterpret_cast<const int4*>(buf + (p - p0));
        const int4 b = *reinterpret_cast<const int4*>(buf + (p - p0) + 4);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
      }
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        valid |= (unsigned)(p + j >= s.off && p + j < s.off + s.n) << j;
      body(x, valid, p);
    }
    if (kStreamed) {
      __syncthreads();
      if (threadIdx.x == 0 && c + s.slots < s.n_chunks) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_chunk(s, c + s.slots);
      }
    }
  }
}

// The groups of [u0, u1) whose maximum reaches `thr`, kPer at a time in
// ascending order: body(x, valid, us) with row `lane` of group us[j] in x[j]
// (us[j] = -1 past the last; the warp's lanes agree on us).
template <bool kStreamed, typename Body>
__device__ __forceinline__ void for_groups(const Slice<kStreamed>& s, int u0,
                                           int u1, int thr, Body body) {
  const int lane = threadIdx.x & 31;
  for (int b0 = u0; b0 < u1; b0 += 32) {
    const int u = b0 + lane;
    unsigned mask =
        __ballot_sync(0xffffffffu, u < u1 && s.gm[u >> s.ms] >= thr);
    while (mask) {
      int us[kPer], x[kPer];
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        us[j] = mask ? b0 + __ffs(mask) - 1 : -1;
        mask &= mask - 1u;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = us[j] * 32 + lane;
        const bool ok = us[j] >= 0 && q >= s.off && q < s.off + s.n;
        x[j] = ok ? (kStreamed ? __ldg(s.g0 + q) : s.data[q]) : 0;
        valid |= (unsigned)ok << j;
      }
      body(x, valid, us);
    }
  }
}

// The bin where the count from the top reaches krem, over the block's kBins
// bins, 4 a thread (thread t: bins 4 (511 - t) .. 4 (511 - t) + 3): `tot`
// those bins' counts, `low` a second count to sum alongside (the lower
// ranks'). pick = {bin, count above it, low above it, count at it, low at
// it}, written by the one thread that finds it; synchronises before
// returning (not after the write).
__device__ __forceinline__ void find_bin(uint4 tot, uint4 low, unsigned krem,
                                         unsigned long long* ws,
                                         unsigned* pick) {
  const int q = kBins / 4 - 1 - (int)threadIdx.x;
  const unsigned long long mine =
      ((unsigned long long)(tot.x + tot.y + tot.z + tot.w) << 32) |
      (low.x + low.y + low.z + low.w);
  const unsigned long long pre = block_excl_scan<unsigned long long>(mine, ws);
  unsigned above = (unsigned)(pre >> 32), labove = (unsigned)pre;
  const unsigned tv[4] = {tot.w, tot.z, tot.y, tot.x};
  const unsigned lv[4] = {low.w, low.z, low.y, low.x};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (above < krem && krem <= above + tv[j]) {
      pick[0] = 4 * q + 3 - j;
      pick[1] = above;
      pick[2] = labove;
      pick[3] = tv[j];
      pick[4] = lv[j];
    }
    above += tv[j];
    labove += lv[j];
  }
}

// One launch: a cluster of C CTAs per row (grid C * batch); dynamic shared
// memory: the slice's buffer (data_elems int32), the CTA's histogram
// [kBins], the group maxima [kGroups], slots mbarriers.
template <bool kStreamed>
__global__ void __launch_bounds__(kThreads, 2)
    kb_select_kernel(const int* __restrict__ bound, int rows, int k, int slice,
                     int chunk, int slots, int data_elems,
                     int* __restrict__ idx, int* __restrict__ unsel) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint4 s_rec;        // lowest, highest bin added; highest row; tau
  __shared__ uint2 s_range;      // the cluster's lowest, highest bin added
  __shared__ int s_kmax;         // the row's highest value
  __shared__ int s_taumax;       // the cluster's highest tau
  __shared__ int s_lowbin;       // the highest non-empty bin below v's
  __shared__ unsigned s_eqhi;    // this CTA's rows at the bucket's top value
  __shared__ uint2 s_eqhi_row;   // the row's, the lower ranks'
  __shared__ int s_below;        // this CTA's highest row below v
  __shared__ int s_umax[kMaxCluster];   // rank 0: every CTA's s_below
  __shared__ unsigned s_wc[2][kWarps];  // the warps' rows above v, at v
  __shared__ unsigned long long s_ws[32];
  __shared__ unsigned s_pick[5];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / n_cl;

  Slice<kStreamed> s;
  s.data = reinterpret_cast<int*>(smem);
  unsigned* lhist = reinterpret_cast<unsigned*>(smem + (size_t)data_elems * 4);
  s.gm = reinterpret_cast<int*>(lhist + kBins);
  s.bars = reinterpret_cast<uint64_t*>(s.gm + kGroups);
  const int* row = bound + (size_t)b * rows;
  const int start = rank * slice;
  s.n = max(0, min(slice, rows - start));
  const int* gs = row + start;
  s.g0 = reinterpret_cast<const int*>((uintptr_t)gs & ~(uintptr_t)15);
  s.off = (int)(gs - s.g0);
  s.np = s.n ? (s.off + s.n + 3) & ~3 : 0;
  s.chunk = chunk;
  s.slots = slots;
  s.n_chunks = (s.np + chunk - 1) / chunk;
  s.units = (s.np + 31) / 32;
  s.ms = 0;
  while ((kGroups << s.ms) < s.units) ++s.ms;
  const int n_gm = (s.units + (1 << s.ms) - 1) >> s.ms;

  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&s.bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_rec = make_uint4(0xffffffffu, 0u, (unsigned)INT_MIN, (unsigned)INT_MIN);
    s_below = INT_MIN;
    s_eqhi = 0u;
  }
  for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;
  for (int i = tid; i < n_gm; i += kThreads) s.gm[i] = INT_MIN;

  // pass 1: every group's maximum, and the slice's. A slice of fewer than
  // k groups has no tau to find: it bins its rows for level 0 here.
  const bool bin_now = n_gm < k;
  unsigned wlo = 0xffffffffu, whi = 0u;  // the bins this warp added
  {
    int top = INT_MIN;
    first_pass(s, [&](const int* x, unsigned valid, int p) {
      int mx = INT_MIN;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        mx = max(mx, (valid >> j) & 1u ? x[j] : INT_MIN);
      if (bin_now) {
        int bins[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          bins[j] = (valid >> j) & 1u ? bin0(x[j]) : -1;
        add_bins(lhist, bins, wlo, whi);
      }
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      top = max(top, mx);
      if ((lane & 3) == 0 && mx != INT_MIN)
        atomicMax(&s.gm[(p >> 5) >> s.ms], mx);
    });
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) atomicMax(reinterpret_cast<int*>(&s_rec.z), top);
  }
  __syncthreads();

  // tau: the k-th highest group maximum of this slice. At least k rows of
  // the row reach it, so v >= tau: rows below it never matter but for the
  // unselected maximum, and groups below it are skipped from here on.
  int tau = INT_MIN;
  if (!bin_now) {
    for (int i = tid; i < n_gm; i += kThreads)
      atomicAdd(&lhist[bin0(s.gm[i])], 1u);
    __syncthreads();
    const int q = kBins / 4 - 1 - tid;
    find_bin(reinterpret_cast<const uint4*>(lhist)[q], make_uint4(0, 0, 0, 0),
             (unsigned)k, s_ws, s_pick);
    __syncthreads();
    const int t = (int)s_pick[0];
    tau = t == 0 ? INT_MIN : (t == kBins - 1 ? kTop + 1 : t - 2);
    for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;
    if (tid == 0) s_rec.w = (unsigned)tau;
    __syncthreads();
  }

  // the levels: find the bin of the k-th value until it holds one value
  const int n_w = (s.units + kWarps - 1) / kWarps;  // a warp's groups
  const int w0 = min(warp * n_w, s.units), w1 = min(w0 + n_w, s.units);
  unsigned krem = (unsigned)k;  // its rank within the current bucket
  unsigned gt_base = 0;         // the lower ranks' rows above the bucket
  unsigned lo = 0, hi = 0;      // the bucket (keys), levels >= 1
  int shift = 0;
  unsigned v_key, need, eq_total, eq_base;
  for (int level = 0;; ++level) {
    if (level == 0) {
      const int th = tau;
      if (!bin_now)  // else binned in pass 1
        for_groups(s, w0, w1, th, [&](const int* x, unsigned valid,
                                      const int*) {
          int bins[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            bins[j] = (valid >> j) & 1u && x[j] >= th ? bin0(x[j]) : -1;
          add_bins(lhist, bins, wlo, whi);
        });
    } else {
      // the bucket's bins, and its rows at the top value: when those
      // reach the k-th rank, that value is v and no pass follows
      const unsigned blo = lo, bhi = hi;
      const int sh = shift;
      int at_top = 0;
      for_groups(s, w0, w1, (int)(blo ^ 0x80000000u),
                 [&](const int* x, unsigned valid, const int*) {
                   int bins[kPer];
#pragma unroll
                   for (int j = 0; j < kPer; ++j) {
                     const unsigned u = key_of(x[j]);
                     const bool in =
                         (valid >> j) & 1u && u >= blo && u <= bhi;
                     bins[j] = in ? (int)((u - blo) >> sh) : -1;
                     at_top += in && u == bhi;
                   }
                   add_bins(lhist, bins, wlo, whi);
                 });
      at_top = __reduce_add_sync(0xffffffffu, at_top);
      if (lane == 0 && at_top) atomicAdd(&s_eqhi, (unsigned)at_top);
    }
    if (lane == 0 && wlo <= whi) {
      atomicMin(&s_rec.x, wlo);
      atomicMax(&s_rec.y, whi);
    }
    wlo = 0xffffffffu;
    whi = 0u;
    __syncthreads();
    cluster.sync();  // every CTA's histogram is complete
    if (warp == 0) {
      const uint4 r =
          lane < n_cl ? *cluster.map_shared_rank(&s_rec, lane)
                      : make_uint4(0xffffffffu, 0u, (unsigned)INT_MIN,
                                   (unsigned)INT_MIN);
      const unsigned blo = __reduce_min_sync(0xffffffffu, r.x);
      const unsigned bhi = __reduce_max_sync(0xffffffffu, r.y);
      const int top = __reduce_max_sync(0xffffffffu, (int)r.z);
      const int tmax = __reduce_max_sync(0xffffffffu, (int)r.w);
      const unsigned e = lane < n_cl ? *cluster.map_shared_rank(&s_eqhi, lane)
                                     : 0u;
      const unsigned e_row = __reduce_add_sync(0xffffffffu, e);
      const unsigned e_low =
          __reduce_add_sync(0xffffffffu, lane < rank ? e : 0u);
      if (lane == 0) {
        s_range = make_uint2(blo, bhi);
        s_kmax = top;
        s_taumax = tmax;
        s_lowbin = -1;
        s_eqhi_row = make_uint2(e_row, e_low);
      }
    }
    // the row's histogram and the lower ranks' share of it: in clusters of
    // up to 4, every bin at once; else the bins any CTA added to, once the
    // records are in (each CTA starts at its own rank: no SM serves all)
    if (n_cl > 4) __syncthreads();
    const int q = kBins / 4 - 1 - tid;
    uint4 tot = make_uint4(0u, 0u, 0u, 0u), low = tot;
    if (n_cl <= 4 ||
        (4 * q + 3 >= (int)s_range.x && 4 * q <= (int)s_range.y)) {
#pragma unroll 4
      for (int i = 0; i < n_cl; ++i) {
        const int r = (rank + i) & (n_cl - 1);
        const uint4 h = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(lhist + 4 * q, r));
        tot.x += h.x;
        tot.y += h.y;
        tot.z += h.z;
        tot.w += h.w;
        if (r < rank) {
          low.x += h.x;
          low.y += h.y;
          low.z += h.z;
          low.w += h.w;
        }
      }
    }
    find_bin(tot, low, krem, s_ws, s_pick);
    __syncthreads();
    if (level > 0 && s_eqhi_row.x >= krem) {  // v is the bucket's top value
      v_key = hi;
      need = krem;
      eq_total = s_eqhi_row.x;
      eq_base = s_eqhi_row.y;
      break;
    }
    const unsigned t = s_pick[0];
    krem -= s_pick[1];
    gt_base += s_pick[2];
    unsigned blo, bhi;
    if (level == 0) {
      if (t == 0) {
        blo = 0u;
        bhi = key_of(-2);
      } else if (t == kBins - 1) {
        blo = key_of(kTop + 1);
        bhi = key_of(s_kmax);
      } else {
        blo = bhi = key_of((int)t - 2);
      }
    } else {
      blo = lo + (t << shift);
      const unsigned long long top =
          (unsigned long long)blo + (1ull << shift) - 1ull;
      bhi = top < hi ? (unsigned)top : hi;
    }
    if (blo == bhi) {
      v_key = blo;
      need = krem;
      eq_total = s_pick[3];
      eq_base = s_pick[4];
      if (level == 0) {  // the highest non-empty bin below v's
        const unsigned tv[4] = {tot.x, tot.y, tot.z, tot.w};
        int lb = -1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tv[j] && 4 * q + j < (int)t) lb = 4 * q + j;
        if (lb >= 0) atomicMax(&s_lowbin, lb);
      }
      break;
    }
    lo = blo;
    hi = bhi;
    shift = max(0, 32 - __clz((int)(hi - lo)) - 11);
    cluster.sync();  // no CTA reads this histogram any more
    for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;
    if (tid == 0) {
      s_rec.x = 0xffffffffu;
      s_rec.y = 0u;
      s_eqhi = 0u;
    }
    __syncthreads();
  }
  const int v = (int)(v_key ^ 0x80000000u);
  cluster_arrive();  // done with the other CTAs' histograms
  __syncthreads();
  // the unselected maximum from the row's histogram where it tells: v when
  // a row at v is left out; -1 when no row is; else the highest non-empty
  // bin below v's at level 0, if every CTA counted that bin whole (it is at
  // or above every tau). Otherwise the CTAs reduce it (`exact` false).
  const long long n_below = (long long)rows - ((long long)k - need) - eq_total;
  int unsel_v = -1;
  bool exact = true;
  if (eq_total > need) {
    unsel_v = v;
  } else if (n_below > 0) {
    const int lb = s_lowbin;
    exact = lb >= 1 && lb < kBins - 1 && lb >= bin0(s_taumax);
    unsel_v = lb - 2;
  }

  // the ordered compaction: a warp's groups are contiguous; count its rows
  // above and at v, then place them after the lower ranks' and warps'
  int below = INT_MIN;
  unsigned cgt = 0, ceq = 0;
  for (int u = w0 + lane; u < w1; u += 32) {
    const int g = s.gm[u >> s.ms];
    if (g < v) below = max(below, g);
  }
  // once the rows at v are all taken below this CTA (or warp), a group whose
  // maximum is v holds nothing to place: only groups above v are read
  const int above_v = v == INT_MAX ? v : v + 1;
  for_groups(s, w0, w1, eq_base >= need ? above_v : v,
             [&](const int* x, unsigned valid, const int*) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = (valid >> j) & 1u;
      cgt += __popc(__ballot_sync(0xffffffffu, ok && x[j] > v));
      ceq += __popc(__ballot_sync(0xffffffffu, ok && x[j] == v));
      if (ok && x[j] < v) below = max(below, x[j]);
    }
  });
  if (lane == 0) {
    s_wc[0][warp] = cgt;
    s_wc[1][warp] = ceq;
  }
  __syncthreads();
  int gt_run = (int)gt_base, eq_run = (int)eq_base;
  for (int w = 0; w < warp; ++w) {
    gt_run += (int)s_wc[0][w];
    eq_run += (int)s_wc[1][w];
  }
  int* out = idx + (size_t)b * k;
  const int first = start - s.off;  // the row of position 0
  const int nd = (int)need;
  const unsigned lt = (1u << lane) - 1u;
  for_groups(s, w0, w1, eq_run >= nd ? above_v : v,
             [&](const int* x, unsigned valid, const int* us) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = (valid >> j) & 1u;
      const unsigned mg = __ballot_sync(0xffffffffu, ok && x[j] > v);
      const unsigned me = __ballot_sync(0xffffffffu, ok && x[j] == v);
      if (mg | me) {
        const int gi = gt_run + __popc(mg & lt), ei = eq_run + __popc(me & lt);
        const int r = first + us[j] * 32 + lane;
        if ((mg >> lane) & 1u) {
          out[gi + min(ei, nd)] = r;
        } else if (((me >> lane) & 1u) && ei < nd) {
          out[gi + ei] = r;
        }
        gt_run += __popc(mg);
        eq_run += __popc(me);
      }
    }
  });
  if (exact) {
    if (rank == 0 && tid == 0) unsel[b] = unsel_v;
    cluster_wait();
    return;
  }
  below = __reduce_max_sync(0xffffffffu, below);
  if (lane == 0) atomicMax(&s_below, below);
  __syncthreads();
  cluster_wait();
  if (tid == 0) *cluster.map_shared_rank(&s_umax[rank], 0) = s_below;
  cluster.sync();  // every CTA's maximum is in rank 0
  if (rank == 0 && tid == 0) {
    int m = INT_MIN;
    for (int r = 0; r < n_cl; ++r) m = max(m, s_umax[r]);
    unsel[b] = n_below > 0 ? m : -1;
  }
}

// The cooperative route: a long row at a small batch (past what one
// cluster's shared memory holds) spread over the whole card, `per_row` CTAs
// a row, one an SM, each one slice resident in shared memory. The phases
// meet at grid barriers (a cooperative launch: every CTA is resident), and
// the CTAs meet in global scratch that every phase writes whole before it
// is read (no zeroing, nothing carried between launches):
//   hist [grid][kBins]  each CTA's histogram of the current level;
//   tot [batch][kBins]  the row's histogram, CTA r summing bins
//                       [r * nb, (r + 1) * nb) of the row's CTAs;
//   rec [2][grid]       per CTA: {highest row, rows at the bucket's top
//                       value} of the level, then {rows above v, rows at
//                       v, highest row below v}.
// A level costs two barriers (the CTAs' histograms, the row's); the
// compaction one more. Reads of what other CTAs wrote bypass L1 (__ldcg).
__global__ void __launch_bounds__(kThreads, 1)
    kb_select_grid_kernel(const int* __restrict__ bound, int rows, int k,
                          int per_row, int slice, int chunk, int slots,
                          int data_elems, unsigned* __restrict__ hist,
                          unsigned* __restrict__ tot, int4* __restrict__ rec,
                          int* __restrict__ idx, int* __restrict__ unsel) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_top;          // this CTA's highest row
  __shared__ unsigned s_eqhi;    // this CTA's rows at the bucket's top value
  __shared__ int s_below;        // this CTA's highest row below v
  __shared__ int4 s_row;         // the row's {highest, at top, -, -}
  __shared__ uint4 s_base;       // lower ranks' above v, at v; row's
  __shared__ unsigned s_wc[2][kWarps];
  __shared__ unsigned long long s_ws[32];
  __shared__ unsigned s_pick[5];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / per_row, rank = blockIdx.x % per_row;
  const int n_grid = (int)gridDim.x;
  const int first_cta = b * per_row;

  Slice<false> s;
  s.data = reinterpret_cast<int*>(smem);
  unsigned* lhist = reinterpret_cast<unsigned*>(smem + (size_t)data_elems * 4);
  s.bars = reinterpret_cast<uint64_t*>(lhist + kBins);
  s.gm = nullptr;
  const int* row = bound + (size_t)b * rows;
  const int start = rank * slice;
  s.n = max(0, min(slice, rows - start));
  const int* gs = row + start;
  s.g0 = reinterpret_cast<const int*>((uintptr_t)gs & ~(uintptr_t)15);
  s.off = (int)(gs - s.g0);
  s.np = s.n ? (s.off + s.n + 3) & ~3 : 0;
  s.chunk = chunk;
  s.slots = slots;
  s.n_chunks = (s.np + chunk - 1) / chunk;
  s.units = (s.np + 31) / 32;
  s.ms = 0;

  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&s.bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_top = INT_MIN;
    s_eqhi = 0u;
    s_below = INT_MIN;
  }
  for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;

  // pass 1: the slice into shared memory, binned for level 0 as it comes
  unsigned wlo = 0xffffffffu, whi = 0u;
  {
    int top = INT_MIN;
    first_pass(s, [&](const int* x, unsigned valid, int) {
      int bins[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = (valid >> j) & 1u;
        bins[j] = ok ? bin0(x[j]) : -1;
        top = max(top, ok ? x[j] : INT_MIN);
      }
      add_bins(lhist, bins, wlo, whi);
    });
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) atomicMax(&s_top, top);
  }

  const int nb = (kBins + per_row - 1) / per_row;  // bins a CTA sums
  const int lanes_per_bin = kThreads / nb;         // >= 1: per_row >= 4
  // The levels, every row in step (the barriers are the grid's): a row
  // refines while the bin of its k-th value holds several values; a row
  // with v found counts its rows above, at and below v once and goes on
  // meeting the barriers until no row refines.
  unsigned krem = (unsigned)k;
  unsigned lo = 0, hi = 0;
  int shift = 0;
  unsigned v_key = 0;
  bool active = true, counted = false;  // block-uniform
  int per_w = 0, p0 = 0, p1 = 0;
  for (int level = 0;; ++level) {
    __syncthreads();  // the histogram and s_eqhi are cleared
    if (active && level > 0) {  // the bucket's bins, its rows at its top
      const unsigned blo = lo, bhi = hi;
      const int sh = shift;
      int at_top = 0;
      for (int t0 = 0; t0 < s.n; t0 += kThreads * kPer) {
        const int p = s.off + t0 + tid * kPer;
        int bins[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool ok = p + j < s.off + s.n;
          const unsigned u = key_of(ok ? s.data[p + j] : 0);
          const bool in = ok && u >= blo && u <= bhi;
          bins[j] = in ? (int)((u - blo) >> sh) : -1;
          at_top += in && u == bhi;
        }
        add_bins(lhist, bins, wlo, whi);
      }
      at_top = __reduce_add_sync(0xffffffffu, at_top);
      if (lane == 0 && at_top) atomicAdd(&s_eqhi, (unsigned)at_top);
    }
    if (!active && !counted) {
      // warp w takes positions [w * per_w, ..) of the slice: its rows
      // above and at v, and the highest below
      const int v = (int)(v_key ^ 0x80000000u);
      per_w = ((s.n + kWarps - 1) / kWarps + 31) & ~31;
      p0 = s.off + min(warp * per_w, s.n);
      p1 = s.off + min(warp * per_w + per_w, s.n);
      unsigned cgt = 0, ceq = 0;
      int below = INT_MIN;
      for (int p = p0 + lane; p < p1; p += 32) {
        const int x = s.data[p];
        cgt += x > v;
        ceq += x == v;
        if (x < v) below = max(below, x);
      }
      cgt = __reduce_add_sync(0xffffffffu, cgt);
      ceq = __reduce_add_sync(0xffffffffu, ceq);
      below = __reduce_max_sync(0xffffffffu, below);
      if (lane == 0) {
        s_wc[0][warp] = cgt;
        s_wc[1][warp] = ceq;
        atomicMax(&s_below, below);
      }
    }
    __syncthreads();
    // publish this CTA's histogram and records
    if (active)
      reinterpret_cast<uint4*>(hist + (size_t)blockIdx.x * kBins)[tid] =
          reinterpret_cast<const uint4*>(lhist)[tid];
    if (tid == 0) {
      rec[blockIdx.x] = make_int4(s_top, (int)s_eqhi, active, 0);
      if (!active && !counted) {
        unsigned g = 0u, e = 0u;
        for (int w = 0; w < kWarps; ++w) {
          g += s_wc[0][w];
          e += s_wc[1][w];
        }
        rec[n_grid + blockIdx.x] = make_int4((int)g, (int)e, s_below, 0);
      }
    }
    counted = !active;
    grid.sync();
    // whether any row refines; the row's record
    if (warp == 0) {
      int top = INT_MIN, any = 0;
      unsigned eq = 0u;
      for (int r = lane; r < n_grid; r += 32) {
        const int4 e = __ldcg(&rec[r]);
        any |= e.z;
        if (r >= first_cta && r < first_cta + per_row) {
          top = max(top, e.x);
          eq += (unsigned)e.y;
        }
      }
      any = __reduce_or_sync(0xffffffffu, any);
      top = __reduce_max_sync(0xffffffffu, top);
      eq = __reduce_add_sync(0xffffffffu, eq);
      if (lane == 0) s_row = make_int4(top, (int)eq, any, 0);
    }
    for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;
    __syncthreads();
    if (!s_row.z) break;
    if (active) {  // the row's bins [rank * nb, (rank + 1) * nb)
      const int j = tid % nb, c0 = tid / nb, bin = rank * nb + j;
      if (c0 < lanes_per_bin && bin < kBins) {
        unsigned sum = 0u;
        for (int c = c0; c < per_row; c += lanes_per_bin)
          sum += __ldcg(hist + (size_t)(first_cta + c) * kBins + bin);
        if (sum) atomicAdd(&lhist[j], sum);
      }
      __syncthreads();
      if (tid < nb && rank * nb + tid < kBins)
        tot[(size_t)b * kBins + rank * nb + tid] = lhist[tid];
    }
    grid.sync();
    if (!active) continue;
    // the bin of the k-th value in the row's histogram
    const uint4 tv = __ldcg(reinterpret_cast<const uint4*>(
                                tot + (size_t)b * kBins) +
                            (kBins / 4 - 1 - tid));
    find_bin(tv, make_uint4(0u, 0u, 0u, 0u), krem, s_ws, s_pick);
    __syncthreads();
    for (int i = tid; i < kBins; i += kThreads) lhist[i] = 0;
    if (tid == 0) s_eqhi = 0u;
    if (level > 0 && (unsigned)s_row.y >= krem) {  // the bucket's top value
      v_key = hi;
      active = false;
      continue;
    }
    const unsigned t = s_pick[0];
    krem -= s_pick[1];
    unsigned blo, bhi;
    if (level == 0) {
      if (t == 0) {
        blo = 0u;
        bhi = key_of(-2);
      } else if (t == kBins - 1) {
        blo = key_of(kTop + 1);
        bhi = key_of(s_row.x);
      } else {
        blo = bhi = key_of((int)t - 2);
      }
    } else {
      blo = lo + (t << shift);
      const unsigned long long top =
          (unsigned long long)blo + (1ull << shift) - 1ull;
      bhi = top < hi ? (unsigned)top : hi;
    }
    if (blo == bhi) {
      v_key = blo;
      active = false;
      continue;
    }
    lo = blo;
    hi = bhi;
    shift = max(0, 32 - __clz((int)(hi - lo)) - 11);
  }
  const int v = (int)(v_key ^ 0x80000000u);

  // the ordered compaction: the row's counts, then each warp's rows placed
  // after the lower ranks' and warps'
  if (warp == 0) {
    unsigned gl = 0u, el = 0u, ga = 0u, ea = 0u;
    int bl = INT_MIN;
    for (int r = lane; r < per_row; r += 32) {
      const int4 e = __ldcg(&rec[n_grid + first_cta + r]);
      ga += (unsigned)e.x;
      ea += (unsigned)e.y;
      bl = max(bl, e.z);
      if (r < rank) {
        gl += (unsigned)e.x;
        el += (unsigned)e.y;
      }
    }
    gl = __reduce_add_sync(0xffffffffu, gl);
    el = __reduce_add_sync(0xffffffffu, el);
    ga = __reduce_add_sync(0xffffffffu, ga);
    ea = __reduce_add_sync(0xffffffffu, ea);
    bl = __reduce_max_sync(0xffffffffu, bl);
    if (lane == 0) {
      s_base = make_uint4(gl, el, ga, ea);
      s_below = bl;
    }
  }
  __syncthreads();
  const int need = k - (int)s_base.z;  // rows at v taken
  if (rank == 0 && tid == 0)
    unsel[b] = (int)s_base.w > need ? v : (k < rows ? s_below : -1);
  int gt_run = (int)s_base.x, eq_run = (int)s_base.y;
  for (int w = 0; w < warp; ++w) {
    gt_run += (int)s_wc[0][w];
    eq_run += (int)s_wc[1][w];
  }
  int* out = idx + (size_t)b * k;
  const int first = start - s.off;  // the row of position 0
  const unsigned lt = (1u << lane) - 1u;
  for (int p = p0; p < p1; p += 32) {
    const bool ok = p + lane < p1;
    const int x = ok ? s.data[p + lane] : INT_MIN;
    const unsigned mg = __ballot_sync(0xffffffffu, ok && x > v);
    const unsigned me = __ballot_sync(0xffffffffu, ok && x == v);
    if (mg | me) {
      const int gi = gt_run + __popc(mg & lt), ei = eq_run + __popc(me & lt);
      if ((mg >> lane) & 1u) {
        out[gi + min(ei, need)] = first + p + lane;
      } else if (((me >> lane) & 1u) && ei < need) {
        out[gi + ei] = first + p + lane;
      }
      gt_run += __popc(mg);
      eq_run += __popc(me);
    }
  }
}

// Dynamic shared memory of one kb_select CTA: the slice's buffer, the
// histogram, the cluster route's group maxima, the mbarriers
// (tiresias_select_smem; ops/match_lattice.py's plan checks its own
// against it).
long long select_smem(int cooperative, int data_elems, int slots) {
  return (long long)data_elems * 4 + kBins * 4 +
         (cooperative ? 0 : kGroups * 4) + (long long)slots * 8;
}

using SelectKernel = void (*)(const int*, int, int, int, int, int, int, int*,
                              int*);

constexpr int kMaxDevices = 64;
// Per device and kernel (resident, streamed, cooperative): the most dynamic
// shared memory it may take once opted in, 0 before that.
std::atomic<int> g_smem_max[kMaxDevices][3];

// Checks a plan (see select_plan) and opts its kernel in once per device:
// the card's largest dynamic shared memory a block, and for the cluster
// kernels a cluster of 16 (non-portable). A CUDA API call costs
// microseconds, and a batch-1 search would pay each one.
cudaError_t select_prepare(int rows, int k, int ctas, int cooperative,
                           int slice, int chunk, int slots, int resident,
                           int data_elems, const void* kernel, int* smem) {
  const bool cluster_ok = ctas == 2 || ctas == 4 || ctas == 8 || ctas == 16;
  if (rows < 1 || k < 1 || k > rows ||
      (cooperative ? (ctas < 4 || !resident) : !cluster_ok) || slice < 4 ||
      slice % 4 || (long long)slice * ctas < rows ||
      (long long)slice + 4 > INT_MAX / 4 || chunk < kTile || chunk % kTile ||
      slots < 1 || slots > kMaxSlots ||
      data_elems != (resident ? slice + 4 : slots * chunk) ||
      (long long)slots * chunk < data_elems) {
    return cudaErrorInvalidValue;
  }
  const long long need = select_smem(cooperative, data_elems, slots);
  if (need > INT_MAX) return cudaErrorInvalidValue;
  *smem = (int)need;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& smem_max =
      g_smem_max[dev][cooperative ? 2 : (resident ? 0 : 1)];
  if (smem_max.load() == 0) {
    int optin = 0;
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc != cudaSuccess) return rc;
    cudaFuncAttributes fa;
    rc = cudaFuncGetAttributes(&fa, kernel);
    if (rc != cudaSuccess) return rc;
    const int most = optin - (int)fa.sharedSizeBytes;
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
    if (rc != cudaSuccess) return rc;
    if (!cooperative) {
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (rc != cudaSuccess) return rc;
    }
    smem_max.store(most);
  }
  return *smem > smem_max.load() ? cudaErrorInvalidValue : cudaSuccess;
}

const void* select_kernel(int cooperative, int resident) {
  if (cooperative) return (const void*)kb_select_grid_kernel;
  return resident ? (const void*)kb_select_kernel<false>
                  : (const void*)kb_select_kernel<true>;
}

// A cluster launch of `ctas` CTAs a row, or a cooperative one.
void select_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int batch, int ctas, int cooperative, int smem,
                   cudaStream_t st) {
  if (cooperative) {
    attr->id = cudaLaunchAttributeCooperative;
    attr->val.cooperative = 1;
  } else {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = ctas;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
  }
  cfg->gridDim = dim3((unsigned)(ctas * batch));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
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

// Scratch of a cooperative launch, in 4-byte words: hist, tot, rec.
long long select_scratch_words(int batch, int ctas) {
  const long long grid = (long long)batch * ctas;
  return grid * kBins + (long long)batch * kBins + 2 * grid * 4;
}

// bound [batch][rows] int32; idx [batch][k] int32; unsel [batch] int32; the
// plan of ops/match_lattice.py::select_plan (ctas, cooperative, slice,
// chunk, slots, resident, data_elems); scratch: the cooperative route's,
// tiresias_select_scratch words, else null. One launch; a refused one
// (cluster size, shared memory, co-residency) returns its error.
extern "C" int tiresias_select_candidates(const void* bound, int batch,
                                          int rows, int k, int ctas,
                                          int cooperative, int slice,
                                          int chunk, int slots, int resident,
                                          int data_elems, void* scratch,
                                          void* idx, void* unsel,
                                          void* stream) {
  if (batch < 1 || (long long)batch * ctas > INT_MAX ||
      (cooperative && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* kernel = select_kernel(cooperative, resident);
  int smem = 0;
  cudaError_t rc = select_prepare(rows, k, ctas, cooperative, slice, chunk,
                                  slots, resident, data_elems, kernel, &smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  select_config(&cfg, &attr, batch, ctas, cooperative, smem,
                (cudaStream_t)stream);
  if (cooperative) {
    unsigned* hist = (unsigned*)scratch;
    unsigned* tot = hist + (size_t)batch * ctas * kBins;
    int4* rec = (int4*)(tot + (size_t)batch * kBins);
    rc = cudaLaunchKernelEx(&cfg, kb_select_grid_kernel, (const int*)bound,
                            rows, k, ctas, slice, chunk, slots, data_elems,
                            hist, tot, rec, (int*)idx, (int*)unsel);
  } else {
    const SelectKernel cluster_kernel =
        resident ? kb_select_kernel<false> : kb_select_kernel<true>;
    rc = cudaLaunchKernelEx(&cfg, cluster_kernel, (const int*)bound,
                            rows, k, slice, chunk, slots, data_elems,
                            (int*)idx, (int*)unsel);
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// 4-byte words of scratch a cooperative launch of [batch] rows at `ctas`
// CTAs a row takes (0 for a cluster launch; -1 past an int).
extern "C" int tiresias_select_scratch(int batch, int ctas, int cooperative) {
  const long long n = cooperative ? select_scratch_words(batch, ctas) : 0;
  return n > INT_MAX ? -1 : (int)n;
}

// Dynamic shared memory of one CTA of a plan (the layout above; -1 past an
// int).
extern "C" int tiresias_select_smem(int cooperative, int data_elems,
                                    int slots) {
  const long long n = select_smem(cooperative, data_elems, slots);
  return n > INT_MAX ? -1 : (int)n;
}

// Clusters of a cluster plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int tiresias_select_max_clusters(int rows, int ctas, int slice,
                                            int chunk, int slots,
                                            int resident, int data_elems) {
  const void* kernel = select_kernel(0, resident);
  int smem = 0;
  cudaError_t rc = select_prepare(rows, 1, ctas, 0, slice, chunk, slots,
                                  resident, data_elems, kernel, &smem);
  if (rc != cudaSuccess) return -(int)rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  select_config(&cfg, &attr, 1, ctas, 0, smem, nullptr);
  int n = 0;
  rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return rc != cudaSuccess ? -(int)rc : n;
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
