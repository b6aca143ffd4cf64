// Vote kernels K4 (bag) and K5 (aligned) for Hopper (sm_90a).
//
// K4 replaces tiresias_tpu/ops/match_pallas.py::_make_kernel (driven by
// match_votes_pallas) and K5 replaces ::_make_aligned_kernel (driven by
// match_votes_pallas_aligned): the votes of every search configuration but
// the dialplan one (coefs >= 2, no truncation, aligned, margin).
//
// Operands:
//   db    [rows, t_len, n_coefs] float32; PAD_VALUE (-1e6) in every frame
//         that does not exist (past an audio's end, padding rows, and
//         tombstoned rows — the store writes PAD_VALUE there).
//   q     [batch, coefs + 2, f_len] float32: rows 0..coefs-1 the query's
//         coefficient values, row coefs the use2 flag (> 0: coefficient 1
//         is tested), row coefs+1 the active flag (> 0: the frame votes).
//   index (ops/match_index.py) each row's frames sorted by d0 within time
//         chunks of `chunk` frames: entries [rows, n_chunks, chunk] float2
//         (d0, d1), pos [rows, n_chunks, chunk] int16 (time in the chunk),
//         n_live [rows, n_chunks] int32 (frames with d0 neither PAD nor
//         NaN, sorted first; the entries after them are NaN).
//   votes [batch, rows] int32.
// Stored frame t matches query frame f when
//   d0 != PAD && |d0-q0| <= tol && (|d1-q1| <= tol || use2 <= 0)
//   && |dc-qc| <= tol for 2 <= c < coefs,
// compared as float32 fabsf(d - q) <= tol, exactly as the TPU kernels do;
// every tolerance is exact (no value-encoded masks).
//
//   bag (K4):     votes[b, a] = #{active f : some t matches}
//   aligned (K5): votes[b, a] = max over o of #{active f : t = o - (F-1) + f
//                 matches}, o = t - f + F - 1 the time offset (PARITY D9)
//
// What bounds them. Testing every frame pair is bound by the instruction
// rate: 64 x 94 x 10,000 x 938 = 5.6e10 pairs at ~5 instructions each at
// batch 64. So the kernels test fewer pairs. fl(d0-q0) never decreases as
// d0 grows, so the stored frames whose d0 passes form one run of the
// sorted chunk; each lane finds its query frame's run by
// binary search on that same float32 expression (exact: the band [lo, hi)
// holds exactly the frames the dense test passes on d0) and tests
// coefficient 1 and the rest only inside it. One block per stored row
// stages each chunk of the index in shared memory once for all the batch's
// queries, so the index is read once per launch (10 bytes per frame); what
// is left is ~2 log2(n) dependent shared-memory probes per query frame and
// row, plus the in-band pairs. Where the bands are wide (a large tolerance,
// or a catalog whose coefficient 0 varies little) testing every pair is
// cheaper again, so a work item whose bands hold more than a share of its
// pairs takes the wide route, decided per item on the device: K4 sweeps
// the sorted chunk with the whole warp, as a dense K4 sweeps a row; K5 puts
// the item on a work list that its bit-sliced kernel serves right after, on
// the same stream (the every-pair kernel stays as a forced route). The
// kernels add the items of each route into a device counter.
//
// Candidate form (the certified strict/aligned prefilter's rescore, the
// Pallas kernels run over each query's candidate rows at
// tiresias_tpu/ops/match_pallas.py:566-577): given cand [batch, n_cand]
// int32 row ids, the kernels compute votes[b, j] of query b against row
// cand[b, j] only, equal to the full kernels' votes at that row. A row id
// outside [0, rows) scores 0. Two designs:
//  - grouped (the engine's): a counting sort over rows (three small kernels
//    on the device, no host sync) turns cand into a row-major work list;
//    each work item is one row and up to kGroup4 (K4) / kGroup5 (K5) of the
//    queries that chose it. The candidates of a batch share rows (65,536
//    slots at batch 64 x 1,024 fall on at most 10,112 rows of the catalog),
//    so one block stages a row's index chunks once for every query of its
//    item, as the full kernels do for the whole batch. Each slot is
//    written by its item's block alone. What bounds it is what bounds the
//    full kernels: K4's band walks (dependent shared-memory probes), K5's
//    band walks and, on wide bands, the bit-sliced kernel's work per
//    (query, frame); grouping removes the per-item staging, syncs and
//    reductions, not those.
//  - per item (the first design, kept as a forced route to measure
//    against, and what batch 1 takes): the <true> instantiation of the
//    full kernels, one block per (query, candidate) item staging that row
//    for it alone.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using tiresias::mbar_arrive;
using tiresias::mbar_init;
using tiresias::mbar_wait;

constexpr float kPad = -1e6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunk = 2048;  // K4's static stage (ops/match_index.py)
constexpr int kMaxSmem = 232448 - 1024;  // dynamic shared memory per block

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Coefficients 2..coefs-1 of stored frame `frame` against query frame f.
__device__ __forceinline__ bool rest_close_inline(const float* frame,
                                                  const float* qb, int f,
                                                  int f_len, int coefs,
                                                  float tol) {
  for (int c = 2; c < coefs; ++c) {
    if (!(fabsf(frame[c] - qb[(size_t)c * f_len + f]) <= tol)) return false;
  }
  return true;
}

// The same out of line (the kernels with one register budget for every
// phase keep the rare test out of their loops).
__device__ __noinline__ bool rest_close(const float* frame, const float* qb,
                                        int f, int f_len, int coefs,
                                        float tol) {
  return rest_close_inline(frame, qb, f, f_len, coefs, tol);
}

// Entry d lies before query value q's band: fl(d - q) < -tol, or NaN from
// d = q = -inf (those entries sort first; with a NaN q every negative d
// counts as before, and the band is empty).
__device__ __forceinline__ bool before_band(float d, float q, float tol) {
  const float x = d - q;
  return x < -tol || (x != x && d < 0.f);
}

// The band's first entry: the number of sorted live entries e[0, n) that
// lie before it (a prefix).
__device__ __forceinline__ int band_lo(const float2* e, int n, float q,
                                       float tol) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (before_band(e[lo + half].x, q, tol)) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// The band's end: the first entry from lo on with !(fl(d0 - q) <= tol).
// [lo, hi) holds exactly the entries whose d0 passes |fl(d0 - q)| <= tol.
__device__ __forceinline__ int band_hi(const float2* e, int lo, int n,
                                       float q, float tol) {
  int len = n - lo;
  while (len > 0) {
    const int half = len >> 1;
    if (e[lo + half].x - q <= tol) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// Copies chunk c of row a's index into shared memory: n_stage (even)
// entries as float4 pairs, their times as u32 pairs.
__device__ __forceinline__ void stage_chunk(float2* s_ent,
                                            unsigned short* s_pos,
                                            const float2* ent,
                                            const short* pos, size_t off,
                                            int n_stage) {
  const float4* ge = reinterpret_cast<const float4*>(ent + off);
  const unsigned* gp = reinterpret_cast<const unsigned*>(pos + off);
  float4* se = reinterpret_cast<float4*>(s_ent);
  unsigned* sp = reinterpret_cast<unsigned*>(s_pos);
  for (int i = threadIdx.x; i < n_stage / 2; i += blockDim.x) {
    se[i] = ge[i];
    sp[i] = gp[i];
  }
}

// The same with cp.async (no registers in between) by threads tid of nt,
// waited for here; the caller syncs those threads.
__device__ __forceinline__ void stage_chunk_async(float2* s_ent,
                                                  unsigned short* s_pos,
                                                  const float2* ent,
                                                  const short* pos,
                                                  size_t off, int n_stage,
                                                  int tid, int nt) {
  const float4* ge = reinterpret_cast<const float4*>(ent + off);
  const unsigned* gp = reinterpret_cast<const unsigned*>(pos + off);
  for (int i = tid; i < n_stage / 2; i += nt) {
    const unsigned se = (unsigned)__cvta_generic_to_shared(
        reinterpret_cast<float4*>(s_ent) + i);
    const unsigned sp = (unsigned)__cvta_generic_to_shared(
        reinterpret_cast<unsigned*>(s_pos) + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(se),
                 "l"(ge + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sp),
                 "l"(gp + i));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Entry u against query frame f on coefficients 1..coefs-1 (coefficient 0
// is tested by the caller).
__device__ __forceinline__ bool rest_ok(const float2* s_ent,
                                        const unsigned short* s_pos, int u,
                                        float q1, bool nouse2,
                                        const float* row, int t0,
                                        int n_coefs, const float* qb, int f,
                                        int f_len, int coefs, float tol) {
  bool ok = coefs < 2 || nouse2 || fabsf(s_ent[u].y - q1) <= tol;
  if (ok && coefs > 2) {
    ok = rest_close(row + (size_t)(t0 + s_pos[u]) * n_coefs, qb, f, f_len,
                    coefs, tol);
  }
  return ok;
}

// ---------------------------------------------------------------- K4 --- //
// One block per stored row (grid.x) and range of work items (grid.y); an
// item is one query's group of 32 consecutive frames, one frame per lane.
// Each chunk of the row's index is staged once; warps take items in turn.
// Index route: each lane finds its band's first entry and walks the band,
// stopping at the first entry whose other coefficients pass (or where d0
// leaves the band). After kProbe entries the lanes still walking find
// their band's end; if what is left of the item's bands exceeds share x
// live x lanes entries, the item takes the dense route: every lane reads
// the same entry (a broadcast, two per 16-byte load) and the warp leaves
// once all its live frames have hit. Hit bits collect per item across
// chunks; a query's votes are the popcounts of its items, added with one
// atomicAdd per block and query (integer sums: deterministic in any order).
constexpr int kWarps = 8;
constexpr int kMaxItems = 512;  // items per block (hit words in shared)
constexpr int kProbe = 8;

// Dense sweep of staged entries [0, n) (n even) for one lane's query frame.
// kMode 1: coefficient 0 only; 2: coefficients 0 and 1; 3: more, tested
// only where 0 and 1 matched. `hit` carries the lane's earlier hit.
template <int kMode>
__device__ __forceinline__ bool sweep(const float2* s_ent,
                                      const unsigned short* s_pos, int n,
                                      float q0, float q1, bool nouse2,
                                      bool live, bool hit, float tol,
                                      const float* row, int t0, int n_coefs,
                                      const float* qf, int f_len, int coefs) {
  for (int u0 = 0; u0 < n; u0 += 64) {
    if (__all_sync(kFull, hit || !live)) break;
    const int u1 = min(n, u0 + 64);
    for (int u = u0; u < u1; u += 2) {
      const float4 d = *reinterpret_cast<const float4*>(s_ent + u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = h ? d.z : d.x;
        const float d1 = h ? d.w : d.y;
        // bitwise & and |: both compares run, no branch
        bool ok = fabsf(d0 - q0) <= tol;
        if (kMode >= 2) ok &= nouse2 | (fabsf(d1 - q1) <= tol);
        if (kMode == 3 && ok) {
          ok = rest_close(row + (size_t)(t0 + s_pos[u + h]) * n_coefs, qf, 0,
                          f_len, coefs, tol);
        }
        hit |= ok;
      }
    }
  }
  return hit;
}

template <bool kCand>
__global__ void __launch_bounds__(kWarps * 32)
    match_votes_kernel(const float* __restrict__ db,
                       const float* __restrict__ q,
                       const float2* __restrict__ ent,
                       const short* __restrict__ pos,
                       const int* __restrict__ n_live, int batch, int rows,
                       int t_len, int n_coefs, int coefs, int f_len,
                       int chunk, int n_chunks, float tol, float share,
                       const int* __restrict__ cand, int n_cand,
                       int* __restrict__ votes,
                       unsigned long long* __restrict__ routes) {
  __shared__ __align__(16) float2 s_ent[kMaxChunk];
  __shared__ __align__(16) unsigned short s_pos[kMaxChunk];
  __shared__ unsigned hits[kMaxItems];
  __shared__ unsigned long long s_routes[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a stored row for every query, or (kCand) one (query, candidate) item
  const long long item = blockIdx.x;
  const int a = kCand ? cand[item] : (int)item;
  if (kCand && (a < 0 || a >= rows)) return;  // uniform; the votes stay 0
  const int groups = (f_len + 31) / 32;
  const int q_lo = kCand ? (int)(item / n_cand) : 0;
  const int q_end = kCand ? q_lo + 1 : batch;
  const int i0 = q_lo * groups + blockIdx.y * kMaxItems;
  const int n_items = min(kMaxItems, q_end * groups - i0);
  const float* row = db + (size_t)a * t_len * n_coefs;
  for (int i = threadIdx.x; i < n_items; i += blockDim.x) hits[i] = 0u;
  if (threadIdx.x < 2) s_routes[threadIdx.x] = 0ull;
  for (int c = 0; c < n_chunks; ++c) {
    const int n = n_live[(size_t)a * n_chunks + c];
    if (n == 0) continue;  // uniform: nothing can match here
    const int n_even = (n + 1) & ~1;  // entries past n are NaN
    __syncthreads();  // the previous chunk is consumed
    stage_chunk(s_ent, s_pos, ent, pos, ((size_t)a * n_chunks + c) * chunk,
                n_even);
    __syncthreads();
    const int t0 = c * chunk;
    for (int it = warp; it < n_items; it += kWarps) {
      const int b = (i0 + it) / groups;
      const int f = ((i0 + it) % groups) * 32 + lane;
      const float* qb = q + (size_t)b * (coefs + 2) * f_len;
      const unsigned done = hits[it];
      // a frame still to test: active, and no hit in an earlier chunk
      const bool live = f < f_len && qb[(size_t)(coefs + 1) * f_len + f] > 0.f
                        && !((done >> lane) & 1u);
      if (!__any_sync(kFull, live)) continue;
      const float q0 = live ? qb[f] : nan_f();
      const float q1 = live && coefs > 1 ? qb[(size_t)f_len + f] : 0.f;
      const bool nouse2 = !(live && qb[(size_t)coefs * f_len + f] > 0.f);
      bool hit = false;
      bool dense = share < 0.f;
      if (!dense) {
        // walk: u from the band's first entry while d0 stays in the band
        int u = live ? band_lo(s_ent, n, q0, tol) : n;
        const int probe_end = u + kProbe;
        for (; u < min(n, probe_end); ++u) {
          if (!(s_ent[u].x - q0 <= tol)) {
            u = n;  // past the band
            break;
          }
          if (rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs, qb, f,
                      f_len, coefs, tol)) {
            hit = true;
            break;
          }
        }
        const bool more = !hit && u < n;
        if (__any_sync(kFull, more)) {
          const int hi = more ? band_hi(s_ent, u, n, q0, tol) : u;
          const int total = __reduce_add_sync(kFull, hi - u);
          const int n_lanes = __popc(__ballot_sync(kFull, live));
          dense = (float)total > share * (float)n * (float)n_lanes;
          if (!dense) {
            for (; u < hi && !hit; ++u) {
              hit = rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs,
                            qb, f, f_len, coefs, tol);
            }
          }
        }
      }
      if (dense) {
        if (coefs == 1) {
          hit = sweep<1>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        } else if (coefs == 2) {
          hit = sweep<2>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        } else {
          hit = sweep<3>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        }
      }
      const unsigned m = __ballot_sync(kFull, hit && live);
      if (lane == 0) {
        hits[it] = done | m;
        atomicAdd(&s_routes[dense ? 1 : 0], 1ull);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_routes[threadIdx.x]) {
    atomicAdd(routes + threadIdx.x, s_routes[threadIdx.x]);
  }
  if (n_items <= 0) return;
  const int b_first = i0 / groups;
  const int b_last = (i0 + n_items - 1) / groups;
  for (int b = b_first + threadIdx.x; b <= b_last; b += blockDim.x) {
    const int lo = max(b * groups, i0) - i0;
    const int hi = min((b + 1) * groups, i0 + n_items) - i0;
    int cnt = 0;
    for (int it = lo; it < hi; ++it) cnt += __popc(hits[it]);
    if (cnt) atomicAdd(votes + (kCand ? (size_t)item : (size_t)b * rows + a),
                       cnt);
  }
}

// ---------------------------------------------------------------- K5 --- //
// Two kernels on one stream, no host sync between them.
// The index kernel: one block per stored row, `warps` warps; a warp takes
// one query at a time (items in rounds of `warps`) and keeps its offset
// histogram in shared memory. Chunk c of the row reaches offsets
// [c*chunk, (c+1)*chunk + F - 1): the histogram is that window, and between
// chunks its last F - 1 offsets (the ones the next chunk also reaches) slide
// to the front, as the Pallas kernel's accumulator slides. A chunk is staged
// once per round (once per launch for a one-chunk tier). Lanes take query
// frames and find their bands; each hit at time t adds one to offset
// t - f + F - 1 with a shared atomicAdd, and the running max is taken from
// the returned values, so no pass over the offsets is needed. An item whose
// bands hold more than share x live x active pairs goes on a work list
// instead (an atomicAdd on a device count), for the dense kernel: the bands
// of its first 32 query frames with an active one, in the first chunk with
// stored frames, decide.
// The dense kernel tests every frame pair of each item on the work list (or
// of every (query, row) pair when the histogram does not fit, for queries of
// more than ~50,000 frames), over the store layout: a grid of the resident
// blocks takes items from a device counter, one block per item; offsets in
// chunks of kOffChunk, each thread kK consecutive offsets in a ring of
// registers over a shared-memory window of stored frames, query frames
// staged kStage5 at a time; a running max per thread, one block max.
constexpr int kK = 9;
constexpr int kThreads5 = 128;
constexpr int kOffChunk = kThreads5 * kK;
constexpr int kStage5 = 128;
constexpr int kWin = kOffChunk + kStage5;

// Dynamic shared memory of the index kernel: entries and times (10 bytes a
// chunk entry), per warp a histogram (chunk + F - 1 ints) and bands (F).
long long aligned_smem(int chunk, int f_len, int warps) {
  return 10LL * chunk + 4LL * warps * (chunk + 2LL * f_len - 1);
}

template <bool kCand>
__global__ void __launch_bounds__(kWarps * 32)
    match_votes_aligned_kernel(const float* __restrict__ db,
                               const float* __restrict__ q,
                               const float2* __restrict__ ent,
                               const short* __restrict__ pos,
                               const int* __restrict__ n_live, int batch,
                               int rows, int t_len, int n_coefs, int coefs,
                               int f_len, int chunk, int n_chunks, float tol,
                               float share, const int* __restrict__ cand,
                               int n_cand, int* __restrict__ votes,
                               int* __restrict__ work,
                               unsigned long long* __restrict__ n_work,
                               unsigned* __restrict__ qmask, int mw,
                               int* __restrict__ row_flag,
                               unsigned long long* __restrict__ routes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_routes[2];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int win = chunk + f_len - 1;
  float2* s_ent = reinterpret_cast<float2*>(smem);
  unsigned short* s_pos = reinterpret_cast<unsigned short*>(s_ent + chunk);
  int* hist = reinterpret_cast<int*>(s_pos + chunk) + (size_t)warp * win;
  unsigned* bnd = reinterpret_cast<unsigned*>(
                      reinterpret_cast<int*>(s_pos + chunk) +
                      (size_t)warps * win) +
                  (size_t)warp * f_len;
  // a stored row for every query (a warp per query), or (kCand) one
  // (query, candidate) item for warp 0
  const long long item = blockIdx.x;
  const int a = kCand ? cand[item] : (int)item;
  if (kCand && (a < 0 || a >= rows)) return;  // uniform; the votes stay 0
  const float* row = db + (size_t)a * t_len * n_coefs;
  if (threadIdx.x < 2) s_routes[threadIdx.x] = 0ull;
  if (!kCand && share < INFINITY) {
    // the row first: the bands of the first round's queries (each query's
    // first 32 frames with an active one, in the row's first chunk with
    // stored frames) hand every query of a wide row to the bit-sliced kernel
    __shared__ int s_band[2];  // in-band entries, active frames
    int c0 = 0;
    while (c0 < n_chunks && n_live[(size_t)a * n_chunks + c0] == 0) ++c0;
    if (c0 < n_chunks) {  // uniform
      const int n = n_live[(size_t)a * n_chunks + c0];
      if (threadIdx.x < 2) s_band[threadIdx.x] = 0;
      stage_chunk(s_ent, s_pos, ent, pos, ((size_t)a * n_chunks + c0) * chunk,
                  (n + 1) & ~1);
      __syncthreads();
      if (warp < batch) {
        const float* qb = q + (size_t)warp * (coefs + 2) * f_len;
        for (int f0 = 0; f0 < f_len; f0 += 32) {
          const int f = f0 + lane;
          int width = 0, act = 0;
          if (f < f_len && qb[(size_t)(coefs + 1) * f_len + f] > 0.f) {
            const float q0 = qb[f];
            const int lo = band_lo(s_ent, n, q0, tol);
            width = band_hi(s_ent, lo, n, q0, tol) - lo;
            act = 1;
          }
          const int a_all = __reduce_add_sync(kFull, act);
          if (a_all > 0) {  // uniform
            const int w_all = __reduce_add_sync(kFull, width);
            if (lane == 0) {
              atomicAdd(s_band, w_all);
              atomicAdd(s_band + 1, a_all);
            }
            break;
          }
        }
      }
      __syncthreads();
      if ((float)s_band[0] > share * (float)n * (float)s_band[1]) {  // uniform
        for (int i = threadIdx.x; i < mw; i += blockDim.x) {
          const int tail = batch - 32 * i;
          qmask[(size_t)a * mw + i] = tail >= 32 ? kFull : (1u << tail) - 1u;
        }
        if (threadIdx.x == 0) {
          work[atomicAdd(n_work, 1ull)] = a;
          atomicAdd(routes + 1, (unsigned long long)batch);
        }
        return;
      }
    }
  }
  for (int r0 = 0; r0 < (kCand ? 1 : batch); r0 += warps) {
    const int b = kCand ? (int)(item / n_cand) : r0 + warp;
    bool mine = kCand ? warp == 0 : b < batch;
    const long long out = kCand ? item : (long long)b * rows + a;
    const float* qb = q + (size_t)(mine ? b : 0) * (coefs + 2) * f_len;
    int best = 0;
    bool decided = share < 0.f;  // forced dense: straight to the list
    bool dense = decided;
    if (mine) {
      for (int i = lane; i < win; i += 32) hist[i] = 0;
      __syncwarp();
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (c > 0 && mine && !dense) {  // slide [chunk, win) to the front
        for (int s = 0; s < f_len - 1; s += 32) {
          const int i = s + lane;
          const int v = i < f_len - 1 ? hist[chunk + i] : 0;
          __syncwarp();
          if (i < f_len - 1) hist[i] = v;
          __syncwarp();
        }
        for (int i = f_len - 1 + lane; i < win; i += 32) hist[i] = 0;
        __syncwarp();
      }
      const int n = n_live[(size_t)a * n_chunks + c];
      if (n == 0) continue;  // uniform
      if (n_chunks > 1 || r0 == 0) {
        __syncthreads();  // the previous chunk is consumed
        stage_chunk(s_ent, s_pos, ent, pos,
                    ((size_t)a * n_chunks + c) * chunk, (n + 1) & ~1);
        __syncthreads();
      }
      if (!mine || dense) continue;
      const int t0 = c * chunk;
      int total = 0, n_act = 0;
      for (int f0 = 0; f0 < f_len; f0 += 32) {
        const int f = f0 + lane;
        if (f < f_len) {
          unsigned bd = 0u;
          if (qb[(size_t)(coefs + 1) * f_len + f] > 0.f) {
            const float q0 = qb[f];
            const int lo = band_lo(s_ent, n, q0, tol);
            const int hi = band_hi(s_ent, lo, n, q0, tol);
            bd = (unsigned)lo | ((unsigned)hi << 16);
            total += hi - lo;
            ++n_act;
          }
          bnd[f] = bd;
        }
        if (!decided) {  // the first 32 frames with an active one decide
          const int t_all = __reduce_add_sync(kFull, total);
          const int a_all = __reduce_add_sync(kFull, n_act);
          if (a_all > 0) {
            dense = (float)t_all > share * (float)n * (float)a_all;
            decided = true;
            if (dense) break;  // uniform
          }
        }
      }
      if (dense) continue;
      __syncwarp();
      for (int f = lane; f < f_len; f += 32) {
        const unsigned bd = bnd[f];
        const int lo = bd & 0xffffu, hi = bd >> 16;
        if (lo == hi) continue;
        const bool nouse2 = !(qb[(size_t)coefs * f_len + f] > 0.f);
        const float q1 = coefs > 1 ? qb[(size_t)f_len + f] : 0.f;
        for (int u = lo; u < hi; ++u) {
          if (rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs, qb, f,
                      f_len, coefs, tol)) {
            best = max(best, atomicAdd(hist + s_pos[u] - f + f_len - 1, 1) + 1);
          }
        }
      }
      __syncwarp();
    }
    if (mine && lane == 0) {
      atomicAdd(&s_routes[dense ? 1 : 0], 1ull);
      if (dense && !kCand) {
        // the query in its row's mask, the row listed once
        atomicOr(qmask + (size_t)a * mw + (b >> 5), 1u << (b & 31));
        if (atomicAdd(row_flag + a, 1) == 0) {
          work[atomicAdd(n_work, 1ull)] = a;
        }
      }
    }
    if (mine && !dense) {
      best = __reduce_max_sync(kFull, best);
      if (lane == 0) votes[out] = best;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_routes[threadIdx.x]) {
    atomicAdd(routes + threadIdx.x, s_routes[threadIdx.x]);
  }
}

// Stages query frames [f0, f0 + fs) of one query as {q0, q1, use2, active}
// float4s (frames past fs are inactive).
__device__ __forceinline__ void stage_query(float4* qs, int n, const float* qb,
                                            int coefs, int f_len, int f0,
                                            int fs) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < fs) {
      const int f = f0 + j;
      v.x = qb[f];
      v.y = coefs > 1 ? qb[(size_t)f_len + f] : 0.f;
      v.z = qb[(size_t)coefs * f_len + f];
      v.w = qb[(size_t)(coefs + 1) * f_len + f];
    }
    qs[j] = v;
  }
}

// The every-pair kernel (K5's forced route "dense", to measure
// against): votes of every (query b, row a) item w = b * rows + a. Blocks
// take items in turn from the counter n_work[1] (zero on entry), so a grid
// of the resident blocks stays busy to the end.
__global__ void __launch_bounds__(kThreads5)
    match_votes_aligned_dense_kernel(const float* __restrict__ db,
                                     const float* __restrict__ q, int batch,
                                     int rows, int t_len, int n_coefs,
                                     int coefs, int f_len, float tol,
                                     unsigned long long* n_work,
                                     int* __restrict__ votes) {
  __shared__ float4 qs[kStage5];
  __shared__ float w0[kWin];
  __shared__ float w1[kWin];
  __shared__ int red[kThreads5 / 32];
  __shared__ unsigned long long s_next;
  const unsigned long long total = (unsigned long long)batch * rows;
  const bool two = coefs > 1;
  const int n_off = t_len + f_len - 1;
  const bool one_stage = f_len <= kStage5;
  const int base = threadIdx.x * kK;
  for (;;) {
    __syncthreads();  // the previous item's stage and reduction are read
    if (threadIdx.x == 0) s_next = atomicAdd(n_work + 1, 1ull);
    __syncthreads();
    const unsigned long long w = s_next;
    if (w >= total) break;
    const int b = (int)(w / rows);
    const int a = (int)(w % rows);
    const float* qb = q + (size_t)b * (coefs + 2) * f_len;
    const float* row = db + (size_t)a * t_len * n_coefs;
    if (one_stage) stage_query(qs, kStage5, qb, coefs, f_len, 0, f_len);
    int best = 0;
    for (int o0 = 0; o0 < n_off; o0 += kOffChunk) {
      int cnt[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) cnt[k] = 0;
      for (int f0 = 0; f0 < f_len; f0 += kStage5) {
        const int fs = min(kStage5, f_len - f0);
        const int tw0 = o0 - (f_len - 1) + f0;  // stored frame of window[0]
        __syncthreads();  // the previous window and stage are consumed
        if (!one_stage) stage_query(qs, kStage5, qb, coefs, f_len, f0, fs);
        bool any_frame = false;
        for (int i = threadIdx.x; i < kWin; i += kThreads5) {
          const int t = tw0 + i;
          float x0 = nan_f(), x1 = nan_f();
          if (t >= 0 && t < t_len) {
            const float* fr = row + (size_t)t * n_coefs;
            const float x = fr[0];
            if (x != kPad) {
              x0 = x;
              x1 = two ? fr[1] : 0.f;
              any_frame = true;
            }
          }
          w0[i] = x0;
          w1[i] = x1;
        }
        if (!__syncthreads_or(any_frame)) continue;  // no stored frame here
        // ring: at frame j, offset k's stored value is r[(k + j) % kK]
        float r0[kK], r1[kK];
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          r0[k] = w0[base + k];
          r1[k] = w1[base + k];
        }
        for (int j0 = 0; j0 < fs; j0 += kK) {
#pragma unroll
          for (int jj = 0; jj < kK; ++jj) {
            const int j = j0 + jj;
            if (j < fs) {
              const float4 qf = qs[j];  // uniform across the block
              if (qf.w > 0.f) {
                const bool use1 = two && qf.z > 0.f;
#pragma unroll
                for (int k = 0; k < kK; ++k) {
                  const int s = (k + jj) % kK;
                  bool ok = fabsf(r0[s] - qf.x) <= tol;
                  if (use1) ok = ok && fabsf(r1[s] - qf.y) <= tol;
                  if (coefs > 2 && ok) {
                    ok = rest_close(
                        row + (size_t)(tw0 + base + k + j) * n_coefs, qb,
                        f0 + j, f_len, coefs, tol);
                  }
                  cnt[k] += ok ? 1 : 0;
                }
              }
              // slot jj (offset 0's value at frame j) takes the value
              // offset kK-1 needs at frame j + 1
              r0[jj] = w0[base + kK + j];
              r1[jj] = w1[base + kK + j];
            }
          }
        }
      }
      // offsets past n_off read only frames past t_len: their counts are 0
#pragma unroll
      for (int k = 0; k < kK; ++k) best = max(best, cnt[k]);
    }
    best = __reduce_max_sync(kFull, best);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      int m = red[0];
      for (int i = 1; i < kThreads5 / 32; ++i) m = max(m, red[i]);
      votes[(size_t)b * rows + a] = m;
    }
  }
}

// ------------------------------------------- grouped candidate form --- //
// The work list: slots [n_valid] (slot s = b * n_cand + j, grouped by row,
// rows ascending; the order inside a row is the atomics' and varies from
// run to run, which no vote depends on) and items [n_items] int4 (row,
// first slot in the list, queries <= g, 0). Three kernels: counts per row,
// one block's scan of (slots, items) per row that writes the items and
// turns the counts into each row's cursor, and the scatter.
constexpr int kGroup4 = 16;  // queries per K4 work item, at most
constexpr int kGroup5 = 8;   // queries per K5 work item (its query stage)
constexpr int kScan = 1024;  // threads of the scan block

// Work item i of K5's grouped form: items[i] (row, first slot in slots,
// queries, 0); or, with no list (items null), for the full scan of `every`
// (<= kGroup5) queries row i with all of them, query b's slot b * n_cand + i
// (n_cand: the rows); or, with every 0, batch 1's candidate slot i, slots
// then holding the row ids (an id outside [0, rows) makes an item of no
// query: its vote stays 0).
__device__ __forceinline__ int4 group_item(const int4* items,
                                           const int* slots, int i,
                                           int every, int rows) {
  if (items) return items[i];
  if (every) return make_int4(i, i, every, 0);
  const int a = slots[i];
  const bool ok = a >= 0 && a < rows;
  return make_int4(ok ? a : 0, i, ok ? 1 : 0, 0);
}

// The slot of query k of item wi.
__device__ __forceinline__ int item_slot(const int4* items, const int* slots,
                                         int4 wi, int k, int n_cand) {
  return items ? slots[wi.y + k] : k * n_cand + wi.y;
}

__global__ void group_count_kernel(const int* __restrict__ cand, long long n,
                                   int rows, int* __restrict__ counts) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    const int r = cand[s];
    if (r >= 0 && r < rows) atomicAdd(counts + r, 1);
  }
}

// Inclusive block-wide sums of (x, y); `tot` gets the block's totals.
__device__ __forceinline__ int2 block_scan2(int x, int y, int2* s_warp,
                                            int2& tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int xo = __shfl_up_sync(kFull, x, d);
    const int yo = __shfl_up_sync(kFull, y, d);
    if (lane >= d) {
      x += xo;
      y += yo;
    }
  }
  if (lane == 31) s_warp[warp] = make_int2(x, y);
  __syncthreads();
  if (warp == 0) {
    int2 v = lane < n_warps ? s_warp[lane] : make_int2(0, 0);
    for (int d = 1; d < 32; d <<= 1) {
      const int xo = __shfl_up_sync(kFull, v.x, d);
      const int yo = __shfl_up_sync(kFull, v.y, d);
      if (lane >= d) {
        v.x += xo;
        v.y += yo;
      }
    }
    if (lane < n_warps) s_warp[lane] = v;
  }
  __syncthreads();
  const int2 pre = warp ? s_warp[warp - 1] : make_int2(0, 0);
  tot = s_warp[n_warps - 1];
  __syncthreads();  // s_warp is free for the next call
  return make_int2(x + pre.x, y + pre.y);
}

// Tiles of 4 rows a thread: each row's first slot in the list (written over
// its count, the scatter's cursor) and its items of up to g slots.
__global__ void __launch_bounds__(kScan)
    group_scan_kernel(int* __restrict__ counts, int rows, int g,
                      int4* __restrict__ items, int* __restrict__ n_items) {
  __shared__ int2 s_warp[kScan / 32];
  int slot0 = 0, item0 = 0;  // the tiles before this one
  for (int lo = 0; lo < rows; lo += kScan * 4) {
    const int r0 = lo + threadIdx.x * 4;
    int c[4], sx = 0, sy = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = r0 + k < rows ? counts[r0 + k] : 0;
      sx += c[k];
      sy += (c[k] + g - 1) / g;
    }
    int2 tot;
    const int2 inc = block_scan2(sx, sy, s_warp, tot);
    int off = slot0 + inc.x - sx, it = item0 + inc.y - sy;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (r0 + k >= rows) break;
      counts[r0 + k] = off;
      for (int p = 0; p < c[k]; p += g) {
        items[it++] = make_int4(r0 + k, off + p, min(g, c[k] - p), 0);
      }
      off += c[k];
    }
    slot0 += tot.x;
    item0 += tot.y;
  }
  if (threadIdx.x == 0) *n_items = item0;
}

__global__ void group_scatter_kernel(const int* __restrict__ cand,
                                     long long n, int rows,
                                     int* __restrict__ cursor,
                                     int* __restrict__ slots) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    const int r = cand[s];
    if (r >= 0 && r < rows) slots[atomicAdd(cursor + r, 1)] = (int)s;
  }
}

// K4 over the work list: one block per work item (grid.x, the list's upper
// bound; blocks past n_items leave) and range of its (query, 32-frame
// group) items (grid.y, more than one only past kMaxItems). The row's index
// chunks are staged once (cp.async) for every query of the item, and the
// warps take its items in turn, as match_votes_kernel does for a batch.
// The dense share is `share` where the item holds >= shared_min queries,
// `share_small` below.
__global__ void __launch_bounds__(kWarps * 32)
    match_votes_group_kernel(const float* __restrict__ db,
                             const float* __restrict__ q,
                             const float2* __restrict__ ent,
                             const short* __restrict__ pos,
                             const int* __restrict__ n_live, int t_len,
                             int n_coefs, int coefs, int f_len, int chunk,
                             int n_chunks, float tol, float share,
                             float share_small, int shared_min, int n_cand,
                             const int* __restrict__ slots,
                             const int4* __restrict__ items,
                             const int* __restrict__ n_items,
                             int* __restrict__ votes,
                             unsigned long long* __restrict__ routes) {
  __shared__ __align__(16) float2 s_ent[kMaxChunk];
  __shared__ __align__(16) unsigned short s_pos[kMaxChunk];
  __shared__ unsigned hits[kMaxItems];
  __shared__ int s_slot[kGroup4];
  __shared__ unsigned long long s_routes[2];
  if ((int)blockIdx.x >= *n_items) return;  // uniform
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int4 wi = items[blockIdx.x];
  const int a = wi.x, nq = wi.z;
  const int groups = (f_len + 31) / 32;
  const int i0 = blockIdx.y * kMaxItems;
  const int n_items_b = min(kMaxItems, nq * groups - i0);
  if (n_items_b <= 0) return;  // uniform
  const float sh = nq >= shared_min ? share : share_small;
  const float* row = db + (size_t)a * t_len * n_coefs;
  if (threadIdx.x < nq) s_slot[threadIdx.x] = slots[wi.y + threadIdx.x];
  for (int i = threadIdx.x; i < n_items_b; i += blockDim.x) hits[i] = 0u;
  if (threadIdx.x < 2) s_routes[threadIdx.x] = 0ull;
  for (int c = 0; c < n_chunks; ++c) {
    const int n = n_live[(size_t)a * n_chunks + c];
    if (n == 0) continue;  // uniform: nothing can match here
    const int n_even = (n + 1) & ~1;  // entries past n are NaN
    __syncthreads();  // the previous chunk is consumed
    stage_chunk_async(s_ent, s_pos, ent, pos,
                      ((size_t)a * n_chunks + c) * chunk, n_even,
                      threadIdx.x, blockDim.x);
    __syncthreads();
    const int t0 = c * chunk;
    for (int it = warp; it < n_items_b; it += kWarps) {
      const int b = s_slot[(i0 + it) / groups] / n_cand;
      const int f = ((i0 + it) % groups) * 32 + lane;
      const float* qb = q + (size_t)b * (coefs + 2) * f_len;
      const unsigned done = hits[it];
      // a frame still to test: active, and no hit in an earlier chunk
      const bool live = f < f_len && qb[(size_t)(coefs + 1) * f_len + f] > 0.f
                        && !((done >> lane) & 1u);
      if (!__any_sync(kFull, live)) continue;
      const float q0 = live ? qb[f] : nan_f();
      const float q1 = live && coefs > 1 ? qb[(size_t)f_len + f] : 0.f;
      const bool nouse2 = !(live && qb[(size_t)coefs * f_len + f] > 0.f);
      bool hit = false;
      bool dense = sh < 0.f;
      if (!dense) {
        // walk: u from the band's first entry while d0 stays in the band
        int u = live ? band_lo(s_ent, n, q0, tol) : n;
        const int probe_end = u + kProbe;
        for (; u < min(n, probe_end); ++u) {
          if (!(s_ent[u].x - q0 <= tol)) {
            u = n;  // past the band
            break;
          }
          if (rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs, qb, f,
                      f_len, coefs, tol)) {
            hit = true;
            break;
          }
        }
        const bool more = !hit && u < n;
        if (__any_sync(kFull, more)) {
          const int hi = more ? band_hi(s_ent, u, n, q0, tol) : u;
          const int total = __reduce_add_sync(kFull, hi - u);
          const int n_lanes = __popc(__ballot_sync(kFull, live));
          dense = (float)total > sh * (float)n * (float)n_lanes;
          if (!dense) {
            for (; u < hi && !hit; ++u) {
              hit = rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs,
                            qb, f, f_len, coefs, tol);
            }
          }
        }
      }
      if (dense) {
        if (coefs == 1) {
          hit = sweep<1>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        } else if (coefs == 2) {
          hit = sweep<2>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        } else {
          hit = sweep<3>(s_ent, s_pos, n_even, q0, q1, nouse2, live, hit,
                         tol, row, t0, n_coefs, qb + f, f_len, coefs);
        }
      }
      const unsigned m = __ballot_sync(kFull, hit && live);
      if (lane == 0) {
        hits[it] = done | m;
        atomicAdd(&s_routes[dense ? 1 : 0], 1ull);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_routes[threadIdx.x]) {
    atomicAdd(routes + threadIdx.x, s_routes[threadIdx.x]);
  }
  const int q_first = i0 / groups;
  const int q_last = (i0 + n_items_b - 1) / groups;
  for (int qi = q_first + threadIdx.x; qi <= q_last; qi += blockDim.x) {
    const int lo = max(qi * groups, i0) - i0;
    const int hi = min((qi + 1) * groups, i0 + n_items_b) - i0;
    int cnt = 0;
    for (int it = lo; it < hi; ++it) cnt += __popc(hits[it]);
    if (gridDim.y == 1) {
      votes[s_slot[qi]] = cnt;  // the slot's one writer
    } else if (cnt) {
      atomicAdd(votes + s_slot[qi], cnt);  // integer sums: any order
    }
  }
}

// K5's index kernel over the work list: one block per work item, a warp
// (or, for an item of fewer queries than warps, several) per query of it,
// each chunk of the row staged once for all of them. The route is the
// item's: the bands of each query's first 32 frames with an active one, in
// the row's first chunk with stored frames, summed over the item's queries,
// against the share of its number of queries (share_bits from bits_min on,
// share from shared_min, else share_small). A wide item goes, whole, on a
// list for a wide kernel: of at least bits_min queries on work[0,
// n_work[0]) for the bit-sliced kernel, of fewer on work[max_items +
// (0, n_work[2])) for the grouped every-pair kernel.
__global__ void __launch_bounds__(kWarps * 32)
    match_votes_aligned_group_kernel(
        const float* __restrict__ db, const float* __restrict__ q,
        const float2* __restrict__ ent, const short* __restrict__ pos,
        const int* __restrict__ n_live, int t_len, int n_coefs, int coefs,
        int f_len, int chunk, int n_chunks, float tol, float share,
        float share_small, int shared_min, float share_bits, int bits_min,
        int n_cand, int every, int rows, const int* __restrict__ slots,
        const int4* __restrict__ items, const int* __restrict__ n_items,
        int max_items, int* __restrict__ votes, int* __restrict__ work,
        unsigned long long* __restrict__ n_work,
        unsigned long long* __restrict__ routes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_slot[kGroup5];
  __shared__ int s_band[2];  // in-band entries, active frames
  __shared__ int s_best[kWarps];
  if (items && (int)blockIdx.x >= *n_items) return;  // uniform
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int win = chunk + f_len - 1;
  float2* s_ent = reinterpret_cast<float2*>(smem);
  unsigned short* s_pos = reinterpret_cast<unsigned short*>(s_ent + chunk);
  int* hists = reinterpret_cast<int*>(s_pos + chunk);  // one per query
  unsigned* bnd = reinterpret_cast<unsigned*>(hists + (size_t)warps * win) +
                  (size_t)warp * f_len;
  const int4 wi = group_item(items, slots, blockIdx.x, every, rows);
  const int a = wi.x, nq = wi.z;
  const float* row = db + (size_t)a * t_len * n_coefs;
  const int* nl = n_live + (size_t)a * n_chunks;
  if (threadIdx.x < nq) {
    s_slot[threadIdx.x] = item_slot(items, slots, wi, threadIdx.x, n_cand);
  }
  if (threadIdx.x < 2) s_band[threadIdx.x] = 0;
  int c0 = 0;
  while (c0 < n_chunks && nl[c0] == 0) ++c0;
  if (c0 == n_chunks) {  // no stored frame: the votes stay 0
    if (threadIdx.x == 0) atomicAdd(routes, (unsigned long long)nq);
    return;
  }
  __syncthreads();  // s_slot, s_band
  stage_chunk_async(s_ent, s_pos, ent, pos,
                    ((size_t)a * n_chunks + c0) * chunk, (nl[c0] + 1) & ~1,
                    threadIdx.x, blockDim.x);
  __syncthreads();
  const bool to_bits = nq >= bits_min;
  const float sh = to_bits ? share_bits
                   : nq >= shared_min ? share : share_small;
  bool dense = sh < 0.f;  // forced dense: straight to the list
  if (!dense) {
    const int n = nl[c0];
    for (int qi = warp; qi < nq; qi += warps) {
      const float* qb =
          q + (size_t)(s_slot[qi] / n_cand) * (coefs + 2) * f_len;
      for (int f0 = 0; f0 < f_len; f0 += 32) {
        const int f = f0 + lane;
        int width = 0, act = 0;
        if (f < f_len && qb[(size_t)(coefs + 1) * f_len + f] > 0.f) {
          const float q0 = qb[f];
          const int lo = band_lo(s_ent, n, q0, tol);
          width = band_hi(s_ent, lo, n, q0, tol) - lo;
          act = 1;
        }
        const int a_all = __reduce_add_sync(kFull, act);
        if (a_all > 0) {  // uniform
          const int w_all = __reduce_add_sync(kFull, width);
          if (lane == 0) {
            atomicAdd(s_band, w_all);
            atomicAdd(s_band + 1, a_all);
          }
          break;
        }
      }
    }
    __syncthreads();
    dense = (float)s_band[0] > sh * (float)n * (float)s_band[1];
  }
  if (threadIdx.x == 0) {
    atomicAdd(routes + (dense ? 1 : 0), (unsigned long long)nq);
    if (dense && to_bits) work[atomicAdd(n_work, 1ull)] = (int)blockIdx.x;
    if (dense && !to_bits) {
      work[max_items + atomicAdd(n_work + 2, 1ull)] = (int)blockIdx.x;
    }
  }
  if (dense) return;  // uniform
  // Rounds of up to `warps` queries; each query of a round gets
  // warps / (its queries) warps, which share its offset histogram (shared
  // atomics) and take its 32-frame groups in turn, so an item of fewer
  // queries than warps leaves no warp idle for want of a query.
  int staged = c0;  // the chunk in shared memory
  for (int r0 = 0; r0 < nq; r0 += warps) {
    const int nr = min(warps, nq - r0);
    const int wpq = warps / nr;
    const int qr = warp / wpq, sub = warp % wpq;
    const bool mine = qr < nr;
    int* hq = hists + (size_t)(mine ? qr : 0) * win;
    const float* qb =
        q + (size_t)(mine ? s_slot[r0 + qr] / n_cand : 0) * (coefs + 2) *
                f_len;
    int best = 0;
    for (int i = threadIdx.x; i < nr * win; i += blockDim.x) hists[i] = 0;
    if (threadIdx.x < nr) s_best[threadIdx.x] = 0;
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      if (c > 0) {  // slide each [chunk, win) to the front (block-wide)
        __syncthreads();  // every hit of the previous chunk is in
        for (int h = 0; h < nr; ++h) {
          int* hh = hists + (size_t)h * win;
          for (int s = 0; s < f_len - 1; s += blockDim.x) {
            const int i = s + threadIdx.x;
            __syncthreads();  // reads before writes
            const int v = i < f_len - 1 ? hh[chunk + i] : 0;
            __syncthreads();
            if (i < f_len - 1) hh[i] = v;
          }
          for (int i = f_len - 1 + threadIdx.x; i < win; i += blockDim.x) {
            hh[i] = 0;
          }
        }
        __syncthreads();
      }
      const int n = nl[c];
      if (n == 0) continue;  // uniform
      if (c != staged) {  // uniform
        __syncthreads();  // the previous chunk is consumed
        stage_chunk_async(s_ent, s_pos, ent, pos,
                          ((size_t)a * n_chunks + c) * chunk, (n + 1) & ~1,
                          threadIdx.x, blockDim.x);
        __syncthreads();
        staged = c;
      }
      if (!mine) continue;
      const int t0 = c * chunk;
      for (int f = sub * 32 + lane; f - lane < f_len; f += wpq * 32) {
        if (f >= f_len) continue;
        unsigned bd = 0u;
        if (qb[(size_t)(coefs + 1) * f_len + f] > 0.f) {
          const float q0 = qb[f];
          const int lo = band_lo(s_ent, n, q0, tol);
          bd = (unsigned)lo | ((unsigned)band_hi(s_ent, lo, n, q0, tol) << 16);
        }
        bnd[f] = bd;
      }
      __syncwarp();
      for (int f = sub * 32 + lane; f - lane < f_len; f += wpq * 32) {
        if (f >= f_len) continue;
        const unsigned bd = bnd[f];
        const int lo = bd & 0xffffu, hi = bd >> 16;
        if (lo == hi) continue;
        const bool nouse2 = !(qb[(size_t)coefs * f_len + f] > 0.f);
        const float q1 = coefs > 1 ? qb[(size_t)f_len + f] : 0.f;
        for (int u = lo; u < hi; ++u) {
          if (rest_ok(s_ent, s_pos, u, q1, nouse2, row, t0, n_coefs, qb, f,
                      f_len, coefs, tol)) {
            best = max(best, atomicAdd(hq + s_pos[u] - f + f_len - 1, 1) + 1);
          }
        }
      }
      __syncwarp();
    }
    if (mine) {
      best = __reduce_max_sync(kFull, best);
      if (lane == 0 && best > 0) atomicMax(s_best + qr, best);
    }
    __syncthreads();
    if (threadIdx.x < nr) votes[s_slot[r0 + threadIdx.x]] = s_best[threadIdx.x];
    __syncthreads();  // s_best and the histograms are free for the next round
  }
}

// One pass of the dense kernel's register ring over a staged window for
// query a (and, kTwo, query c in the same pass: one ring, two tests per
// stored value), adding each offset's hits to ca (cc). Per query frame the
// branch on its active and use2 flags is taken once (they are uniform
// across the block), so each test is two compares and an add, with
// coefficient 1 four; kRest (coefs > 2) tests the rest where 0 and 1 pass.
template <bool kTwo, bool kRest>
__device__ __forceinline__ void ring_pass(
    const float* w0, const float* w1, const float4* qa, const float4* qc,
    int fs, int base, float tol, bool two, int coefs, const float* row,
    int n_coefs, int tw0, const float* ga, const float* gc, int f0,
    int f_len, int (&ca)[kK], int (&cc)[kK]) {
  // ring: at frame j, offset k's stored value is r[(k + j) % kK]
  float r0[kK], r1[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    r0[k] = w0[base + k];
    r1[k] = w1[base + k];
  }
  for (int j0 = 0; j0 < fs; j0 += kK) {
#pragma unroll
    for (int jj = 0; jj < kK; ++jj) {
      const int j = j0 + jj;
      if (j < fs) {
#pragma unroll
        for (int h = 0; h < (kTwo ? 2 : 1); ++h) {
          const float4 qf = h ? qc[j] : qa[j];  // uniform across the block
          int (&cnt)[kK] = h ? cc : ca;
          if (qf.w > 0.f) {
            if (two && qf.z > 0.f) {
#pragma unroll
              for (int k = 0; k < kK; ++k) {
                const int s = (k + jj) % kK;
                // bitwise &: both compares run, no branch
                bool ok = (fabsf(r0[s] - qf.x) <= tol) &
                          (fabsf(r1[s] - qf.y) <= tol);
                if (kRest && ok) {
                  ok = rest_close(
                      row + (size_t)(tw0 + base + k + j) * n_coefs,
                      h ? gc : ga, f0 + j, f_len, coefs, tol);
                }
                cnt[k] += ok ? 1 : 0;
              }
            } else {
#pragma unroll
              for (int k = 0; k < kK; ++k) {
                const int s = (k + jj) % kK;
                bool ok = fabsf(r0[s] - qf.x) <= tol;
                if (kRest && ok) {
                  ok = rest_close(
                      row + (size_t)(tw0 + base + k + j) * n_coefs,
                      h ? gc : ga, f0 + j, f_len, coefs, tol);
                }
                cnt[k] += ok ? 1 : 0;
              }
            }
          }
        }
        // slot jj (offset 0's value at frame j) takes the value offset
        // kK-1 needs at frame j + 1
        r0[jj] = w0[base + kK + j];
        r1[jj] = w1[base + kK + j];
      }
    }
  }
}

// The block's best count of one query over its offsets so far, into s_best.
__device__ __forceinline__ void flush_best(const int (&cnt)[kK], int* s_best) {
  int m = 0;
#pragma unroll
  for (int k = 0; k < kK; ++k) m = max(m, cnt[k]);
  m = __reduce_max_sync(kFull, m);
  if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(s_best, m);
}

// K5's grouped every-pair kernel over the work list (the grouped form's
// wide kernel where a row is shared by few queries, and its forced route
// "dense"): blocks take work items from the counter n_work[1] (zero on
// entry): those on the list (work[0, n_work[0])) or, with work null, every
// item. A window of the row's frames is staged once per offset chunk (and
// query stage) for all of the item's queries; with one query stage (f_len
// <= kStage5) every query of the item is staged once and the queries go
// through the ring two at a time. The next item is taken when this one
// starts, and its row is prefetched into L2.
template <bool kRest>
__global__ void __launch_bounds__(kThreads5)
    match_votes_aligned_group_dense_kernel(
        const float* __restrict__ db, const float* __restrict__ q,
        int t_len, int n_coefs, int coefs, int f_len, float tol, int n_cand,
        int every, int rows, const int* __restrict__ slots,
        const int4* __restrict__ items, const int* __restrict__ n_items,
        const int* __restrict__ work, unsigned long long* n_work,
        int* __restrict__ votes) {
  __shared__ float4 qs[kGroup5 * kStage5];
  __shared__ float w0[kWin];
  __shared__ float w1[kWin];
  __shared__ int s_slot[kGroup5];
  __shared__ int s_best[kGroup5];
  __shared__ unsigned long long s_next;
  const unsigned long long total =
      work ? n_work[0] : (unsigned long long)(items ? *n_items : n_cand);
  const bool two = coefs > 1;
  const int n_off = t_len + f_len - 1;
  const bool one_stage = f_len <= kStage5;
  const int base = threadIdx.x * kK;
  const size_t row_len = (size_t)t_len * n_coefs;
  const size_t q_len = (size_t)(coefs + 2) * f_len;
  if (threadIdx.x == 0) s_next = atomicAdd(n_work + 1, 1ull);
  __syncthreads();
  unsigned long long w = s_next;
  while (w < total) {  // uniform
    const int4 wi =
        group_item(items, slots, work ? work[w] : (int)w, every, rows);
    const int nq = wi.z;
    const float* row = db + (size_t)wi.x * row_len;
    __syncthreads();  // s_next is read; the previous item's votes written
    if (threadIdx.x == 0) s_next = atomicAdd(n_work + 1, 1ull);
    if (threadIdx.x < nq) {
      s_slot[threadIdx.x] = item_slot(items, slots, wi, threadIdx.x, n_cand);
      s_best[threadIdx.x] = 0;
    }
    __syncthreads();
    const unsigned long long next = s_next;
    if (next < total) {  // the next item's row toward L2 meanwhile
      const float* nrow =
          db + (size_t)group_item(items, slots, work ? work[next] : (int)next,
                                  every, rows)
                        .x * row_len;
      for (size_t i = threadIdx.x * 32; i < row_len; i += kThreads5 * 32) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nrow + i));
      }
    }
    if (one_stage) {
      for (int p = 0; p < nq; ++p) {
        stage_query(qs + p * kStage5, kStage5,
                    q + (size_t)(s_slot[p] / n_cand) * q_len, coefs, f_len, 0,
                    f_len);
      }
    }
    // one stage: every query in one round; else two a round, each window
    // staged again per round and query stage
    const int step = one_stage ? nq : 2;
    for (int o0 = 0; o0 < n_off; o0 += kOffChunk) {
      for (int pb = 0; pb < nq; pb += step) {
        const int pe = min(nq, pb + step);
        int ca[kK], cc[kK];
#pragma unroll
        for (int k = 0; k < kK; ++k) ca[k] = cc[k] = 0;
        for (int f0 = 0; f0 < f_len; f0 += kStage5) {
          const int fs = min(kStage5, f_len - f0);
          const int tw0 = o0 - (f_len - 1) + f0;  // stored frame of window[0]
          __syncthreads();  // the previous window and stage are consumed
          if (!one_stage) {
            for (int p = pb; p < pe; ++p) {
              stage_query(qs + (p - pb) * kStage5, kStage5,
                          q + (size_t)(s_slot[p] / n_cand) * q_len, coefs,
                          f_len, f0, fs);
            }
          }
          bool any_frame = false;
          for (int i = threadIdx.x; i < kWin; i += kThreads5) {
            const int t = tw0 + i;
            float x0 = nan_f(), x1 = nan_f();
            if (t >= 0 && t < t_len) {
              const float* fr = row + (size_t)t * n_coefs;
              const float x = fr[0];
              if (x != kPad) {
                x0 = x;
                x1 = two ? fr[1] : 0.f;
                any_frame = true;
              }
            }
            w0[i] = x0;
            w1[i] = x1;
          }
          if (!__syncthreads_or(any_frame)) continue;  // no stored frame
          for (int p = pb; p < pe; p += 2) {
            if (one_stage) {
#pragma unroll
              for (int k = 0; k < kK; ++k) ca[k] = cc[k] = 0;
            }
            const float* ga = q + (size_t)(s_slot[p] / n_cand) * q_len;
            const float4* qa = qs + (p - pb) * kStage5;
            if (p + 1 < pe) {
              ring_pass<true, kRest>(
                  w0, w1, qa, qa + kStage5, fs, base, tol, two, coefs, row,
                  n_coefs, tw0, ga,
                  q + (size_t)(s_slot[p + 1] / n_cand) * q_len, f0, f_len,
                  ca, cc);
            } else {
              ring_pass<false, kRest>(w0, w1, qa, qa, fs, base, tol, two,
                                      coefs, row, n_coefs, tw0, ga, ga, f0,
                                      f_len, ca, cc);
            }
            if (one_stage) {
              flush_best(ca, s_best + p);
              if (p + 1 < pe) flush_best(cc, s_best + p + 1);
            }
          }
        }
        if (!one_stage) {
          flush_best(ca, s_best + pb);
          if (pb + 1 < pe) flush_best(cc, s_best + pb + 1);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < nq) votes[s_slot[threadIdx.x]] = s_best[threadIdx.x];
    w = next;
  }
}

// ------------------------------------------------- K5, bit-sliced --- //
// Replaces the every-pair tests (match_votes_aligned_dense_kernel,
// match_votes_aligned_group_dense_kernel) as K5's route for wide bands:
// match_votes_aligned_bits_kernel_ws below. In the full scan at batch >=
// SMALL_BATCH the index kernel lists each wide row once, with the mask of
// its queries, and the kernel serves the list in the same call; it also
// serves work items (group_item): the grouped candidate form's items the
// grouped index kernel lists, each row of the full scan below SMALL_BATCH
// with all its queries, batch 1's candidate slots, or every item (the
// forced route "bits", and queries whose offset histogram the index kernel
// cannot hold). The votes of
// tiresias_tpu/ops/match_pallas.py::_make_aligned_kernel, exact.
//
// What bounds it. Testing every frame pair is issue-bound (~5 instructions
// a pair, 2.8e11 at B=64 on a 10,000-track catalog; 3.2e10 in the grouped
// form at 64 x 1,024 candidates, ~1 ms at the card's issue rate), and the
// index route's serial band walks and shared atomics grow with the bands.
// Here a query frame's hits in a chunk are a bitset over its stored times,
// built from rank bands, and the offset histogram is bit-sliced: a thread
// adds 32 offsets at once (~500 instructions a (query, frame, row) against
// 1,024 pair tests).
//  - Row-stationary: one CTA per row (or work item) stages each index chunk
//    once for every query it serves (rounds of kCountWarps queries, below
//    kCountWarps a query's 32-frame groups split over several count warps,
//    see the kernel).
//  - Rank bands: four bisections at once (bands4) on fl(d - q): coefficient
//    0's band [lo, hi) of the d0-sorted chunk and coefficient 1's over the
//    d1 order the index keeps (MatchIndex.d1/pos1/n1, built once per view;
//    NaN d1 left out), staged with cp.async beside the d0 order. A
//    two-coefficient search needs the kept order (a launch without it is
//    refused).
//  - Block-prefix bitsets: P[k] holds the times ranked below k*g (g = 8, or
//    32 for chunks over 1,024 frames), built by a prefix-OR (each entry's
//    time into its block's row, a shuffle scan down the rows: ~2k
//    operations a coefficient at 1,024 frames). A band's bitset is B = F |
//    E: F = P[hb] & ~P[lb] on the whole blocks inside it, E its <= 2(g-1)
//    edge entries. Hits = B0 & B1 = F0 & F1 | E0 & B1 | B0 & E1: a word's
//    F0 & F1 in a few instructions whatever the bands' widths, then each
//    edge entry tested on the other coefficient's value (d1 beside d0 in
//    the d0 order, d0 by time for the d1 order) and OR'ed in by the frame's
//    two lanes with shared atomics (B0 alone without use2). Coefficients
//    2..coefs-1 are tested exactly on the surviving bits only.
//  - A band of at most kDirect entries is tested entry by entry instead
//    (the frame's two lanes, or the whole warp for a band over kPairWalk).
//    The prefix bitsets are built for every staged chunk. Either way the
//    votes are exact.
//  - Offsets without atomics: offsets run in tiles of 1,024 x kNW + kOvf,
//    so a query of any length is served; a lane owns kNW words of 32
//    consecutive offsets, funnel-shifts each frame's hit words into place
//    and adds eight frames at a time into kPlanes bit-sliced counters
//    (Harley-Seal: seven carry-save adders, two LOP3s each). The tile's
//    last kOvf offsets, which only hits near a chunk's end reach, take the
//    bits of the frames that reach them one by one into int counts (shared
//    atomics), so a 1,024-frame row with a query of up to 129 frames needs
//    one counter word a lane, not two. Queries of more than 255 frames fold
//    the planes into int32 counts in shared memory. The max is taken at
//    the end of each tile.
// Measured (PERF.md): in the full scan it wins at batch >= SMALL_BATCH on
// wide bands and loses to the index route on narrow ones, so the index
// kernel hands it the former; the routes of the grouped form and of the
// full scan below SMALL_BATCH are ops/match_kernels.py's DENSE_SHARE.
constexpr int kBatch = 16;                   // frames a warp takes at once
constexpr int kPlanes = 8;                   // counts < 256 between folds
constexpr int kFoldAt = (1 << kPlanes) - 1;  // inputs between folds
constexpr int kDirect = 32;                  // widest band tested entry-wise
constexpr int kPairWalk = 16;  // longest band a frame's two lanes walk
constexpr int kIntMax = 0x7fffffff;
constexpr int kOvf = 128;  // a tile's offsets past its counters' words

// Entry d lies after query value q's band: fl(d - q) > tol, or NaN other
// than from d = q = -inf (those entries sort first, before the band).
__device__ __forceinline__ bool after_band(float d, float q, float tol) {
  const float x = d - q;
  return !(x <= tol || (x != x && d < 0.f));
}

// The rank bands [lo0, hi0) of q0 in e0[0, n0) (the d0 order) and [lo1,
// hi1) of q1 in e1[0, n1) (the d1 order; n1 0 skips it), lo the entries
// before the band, hi those not after it (both prefixes): four searches at
// once by steps of powers of two down from `top` (bands_top), each bound the
// length of the prefix its predicate holds on, in a fixed number of steps
// with no branch, so each step's four probes are independent and their
// latencies overlap. The bands equal band_lo/band_hi's.
__device__ __forceinline__ void bands4(const float2* e0, int n0, float q0,
                                       const float* e1, int n1, float q1,
                                       float tol, int top, int& lo0, int& hi0,
                                       int& lo1, int& hi1) {
  lo0 = hi0 = lo1 = hi1 = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int a = lo0 + step, b = hi0 + step, c = lo1 + step, d = hi1 + step;
    if (a <= n0 && before_band(e0[a - 1].x, q0, tol)) lo0 = a;
    if (b <= n0 && !after_band(e0[b - 1].x, q0, tol)) hi0 = b;
    if (c <= n1 && before_band(e1[c - 1], q1, tol)) lo1 = c;
    if (d <= n1 && !after_band(e1[d - 1], q1, tol)) hi1 = d;
  }
}

// bands4's `top` for orders of n0 and n1 entries: the largest power of two
// at most max(n0, n1), or 1.
__device__ __forceinline__ int bands_top(int n0, int n1) {
  return 1 << (31 - __clz(max(n0, n1) | 1));
}

// Carry-save adder: l + a + b = 2 * (returned carry) + l (bitwise).
__device__ __forceinline__ unsigned csa(unsigned& l, unsigned a, unsigned b) {
  const unsigned u = l ^ a;
  const unsigned h = (l & a) | (u & b);
  l = u ^ b;
  return h;
}

// kNW words of 32 bit-sliced counters: planes[j][k] holds bit k of word
// j's counts. Inputs come eight at a time (Harley-Seal, unrolled: seven
// carry-save adders and a ripple from the fours up); n[j] counts the
// inputs since the last fold. Each word takes its own inputs, so a word
// that eight frames cannot reach skips them.
template <int kNW>
struct Counters {
  unsigned planes[kNW][kPlanes];
  int n[kNW];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) planes[j][k] = 0u;
      n[j] = 0;
    }
  }

  __device__ __forceinline__ void ripple(int j, unsigned x, int k0) {
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      if (k >= k0) {
        const unsigned t = planes[j][k] & x;
        planes[j][k] ^= x;
        x = t;
      }
    }
  }

  __device__ __forceinline__ void add8(int j, const unsigned (&x)[8]) {
    unsigned* p = planes[j];
    const unsigned a = csa(p[0], x[0], x[1]);
    const unsigned b = csa(p[0], x[2], x[3]);
    const unsigned c = csa(p[1], a, b);
    const unsigned d = csa(p[0], x[4], x[5]);
    const unsigned e = csa(p[0], x[6], x[7]);
    const unsigned f = csa(p[1], d, e);
    ripple(j, csa(p[2], c, f), 3);
    n[j] += 8;
  }

  // Four inputs: two carry-save adders into planes 0 and 1, then a ripple
  // from the twos.
  __device__ __forceinline__ void add4(int j, const unsigned (&x)[4]) {
    unsigned* p = planes[j];
    const unsigned a = csa(p[0], x[0], x[1]);
    const unsigned b = csa(p[0], x[2], x[3]);
    ripple(j, csa(p[1], a, b), 2);
    n[j] += 4;
  }

  __device__ __forceinline__ void add(int j, const unsigned (&x)[8]) {
    add8(j, x);
  }
  __device__ __forceinline__ void add(int j, const unsigned (&x)[4]) {
    add4(j, x);
  }

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int j = 0; j < kNW; ++j) n[j] = 0;
  }

  // The planes' counts added into fold[i * 32 kNW + word] (shared int32);
  // the planes restart at zero. Call after flush().
  __device__ __forceinline__ void fold_into(int* fold) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      unsigned any = 0u;
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) any |= planes[j][k];
      for (int i = 0; any && i < 32; ++i) {
        int c = 0;
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) c |= ((planes[j][k] >> i) & 1) << k;
        if (c) atomicAdd(fold + i * 32 * kNW + lane + 32 * j, c);
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) planes[j][k] = 0u;
    }
  }

  // The largest count in the lane's words. Call after flush().
  __device__ __forceinline__ int max_count() const {
    int m = 0;
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      unsigned cand = ~0u;
      int v = 0;
#pragma unroll
      for (int k = kPlanes - 1; k >= 0; --k) {
        const unsigned t = cand & planes[j][k];
        if (t) {
          cand = t;
          v |= 1 << k;
        }
      }
      m = max(m, v);
    }
    return m;
  }
};

// The kept coefficient-1 order of chunk `off` (ops/match_index.py): n
// (even) values as float2 pairs and their times as u32 pairs, cp.async
// issued here by threads tid of nt and waited for by the next
// stage_chunk_async.
__device__ __forceinline__ void stage_kept_async(float* s_d1,
                                                 unsigned short* s_pos1,
                                                 const float* d1k,
                                                 const short* pos1k,
                                                 size_t off, int n, int tid,
                                                 int nt) {
  const float2* gd = reinterpret_cast<const float2*>(d1k + off);
  const unsigned* gp = reinterpret_cast<const unsigned*>(pos1k + off);
  for (int i = tid; i < n / 2; i += nt) {
    const unsigned sd = (unsigned)__cvta_generic_to_shared(
        reinterpret_cast<float2*>(s_d1) + i);
    const unsigned sp = (unsigned)__cvta_generic_to_shared(
        reinterpret_cast<unsigned*>(s_pos1) + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sd),
                 "l"(gd + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sp),
                 "l"(gp + i));
  }
}

// Inclusive OR-scan down each of `cols` columns of p (words [k * rs + w],
// rows 1..nb <= 128; columns nwc.. lie (nb + 1) * rs words on, in the
// second order's bitsets): a warp takes two columns at a time, each lane
// ORs down its run of <= 4 rows, a shuffle scan ORs in the runs before it.
// By the warps of threads tid of nt; the caller syncs them after.
__device__ __forceinline__ void prefix_or(unsigned* p, int cols, int nwc,
                                          int nb, int rs, int tid, int nt) {
  const int lane = threadIdx.x & 31;
  const int warps = nt >> 5;
  const int per = (nb + 31) >> 5;  // rows a lane
  const int k0 = 1 + lane * per;
  for (int c0 = 2 * (tid >> 5); c0 < cols; c0 += 2 * warps) {
    unsigned v[2][4], acc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = min(c0 + h, cols - 1);
      const unsigned* pc =
          p + (col >= nwc ? (nb + 1) * rs + col - nwc : col);
      acc[h] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        acc[h] |= i < per && k <= nb ? pc[k * rs] : 0u;
        v[h][i] = acc[h];
      }
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned y = __shfl_up_sync(kFull, acc[h], d);
        if (lane >= d) acc[h] |= y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned carry = __shfl_up_sync(kFull, acc[h], 1);
      const int col = c0 + h;
      if (col < cols) {
        unsigned* pc = p + (col >= nwc ? (nb + 1) * rs + col - nwc : col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + i;
          if (i < per && k <= nb) pc[k * rs] = v[h][i] | (lane ? carry : 0u);
        }
      }
    }
  }
}

// The prefix bitsets of a staged chunk, by threads tid of nt (`sync` syncs
// them; synced on return): each entry's time into its block's row of s_p0
// (the d0 order) or, with two, s_p1 (the kept d1 order, which follows s_p0),
// then an OR down the rows, so bit b of P[k][w] is rank(32 w + b) < k g;
// with two, each live time's d0 into s_d0t (coefficient 1's band edges test
// it).
template <class Sync>
__device__ __forceinline__ void build_bitsets(
    unsigned* s_p0, float* s_d0t, const float2* s_ent,
    const unsigned short* s_pos0, const unsigned short* s_pos1, int n0,
    int n1, bool two, int nwc, int lg, int nb, int rs, int tid, int nt,
    Sync sync) {
  unsigned* s_p1 = s_p0 + (nb + 1) * rs;
  const int ncf = two ? 2 : 1;
  const int m1 = two ? n1 : 0;
  uint4* pz = reinterpret_cast<uint4*>(s_p0);
  for (int i = tid; i < ncf * (nb + 1) * rs / 4; i += nt) {
    pz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = (ncf * (nb + 1) * rs & ~3) + tid; i < ncf * (nb + 1) * rs;
       i += nt) {
    s_p0[i] = 0u;
  }
  sync();
  for (int r = tid; r < n0 + m1; r += nt) {
    const bool one = r >= n0;
    const int rr = one ? r - n0 : r;
    const int t = one ? s_pos1[rr] : s_pos0[rr];
    atomicOr((one ? s_p1 : s_p0) + ((rr >> lg) + 1) * rs + (t >> 5),
             1u << (t & 31));
    if (two && !one) s_d0t[t] = s_ent[rr].x;
  }
  sync();
  prefix_or(s_p0, ncf * nwc, nwc, nb, rs, tid, nt);
  sync();
}

// ------------------------------ K5, bit-sliced, warp-specialised --- //
// The bit-sliced algorithm above, one CTA a row: a row the full scan's
// index kernel lists from SMALL_BATCH on (work[0, n_work[0]), with the
// mask of its queries qmask[a * mw ..]), or (qmask null) a work item of
// group_item's. It replaces tiresias_tpu/ops/match_pallas.py::
// _make_aligned_kernel's pair tests on wide bands, with its votes exact.
//
// What bounds it on the H100. Not bytes (a row's index is read once for all
// its queries) and not the issue rate alone: per 16-frame batch a warp runs
// a few hundred dependent instructions on shared memory (bisections, block
// words, edge entries with shared atomics, bit-sliced adds). A kernel with
// one such chain a warp (before this one) issued about 1.6 instructions a
// cycle an SM and spent 9% of its warps' time at a block barrier between
// rounds; its 80 registers held the bands' state and the counters
// together, and spilled (PERF.md section 5).
//
// What the role split does. Each CTA stages a row once (the chunk, the kept
// coefficient-1 order, both prefix bitsets) and runs two roles on it:
//  - kCountWarps count warps (a warpgroup) hold a query each: a round's
//    queries, or, with fewer queries than count warps, a query's 32-frame
//    groups in turn over several, their planes merged by bit-sliced adds
//    at a tile's end. Each waits for its ring's slots in order, adds its
//    frames' hit words (eight frames at a time, one word a lane, no shift)
//    into bit-sliced counters (the tile's last kOvf offsets into int
//    counts), frees each slot by its empty mbarrier, takes the max at a
//    tile's end and writes the vote.
//  - Two band warps a count warp (two warpgroups) find its groups' rank
//    bands (bisections by powers of two), build each 16-frame batch's hit
//    rows (block words F0 & F1, the edge entries, coefficients 2..) into
//    the ring's next slot, each row already shifted to the frame's offsets
//    so that a count warp reads whole words, and signal its full mbarrier.
//    The two take the groups in turn, each always the same pairs of slots,
//    so each slot's uses are filled in order and a wait on a slot's parity
//    cannot pass a use early.
// So the band warps run ahead by the ring's depth (two groups), each count
// warp and its band warps run as a pipeline of their own with no block
// barrier between rounds, the shifts move to the band warps, and neither
// role holds the other's state: setmaxnreg gives the band role 88 registers
// and the count role 64, and neither spills.
constexpr int kBandWarps = 8;   // two warpgroups
constexpr int kCountWarps = 4;  // one warpgroup
constexpr int kWsThreads = 32 * (kBandWarps + kCountWarps);
// Registers a thread with one counter word a lane (kNW 1): 80 at launch
// (65,536 over two CTAs of kWsThreads); then the band warps take 88 and the
// count warps give up 16 for them (measured, PERF.md: the band role spills
// below 88, the count role's planes and eight frames fit in 64). With more
// words a lane (longer rows or queries) one CTA an SM gets 168 for both.
constexpr int kWsRegs = 65536 / (2 * kWsThreads) / 8 * 8;
constexpr int kBandRegs = 88;
constexpr int kCountRegs = 64;
static_assert(kBandWarps * (kWsRegs - kBandRegs) +
                      kCountWarps * (kWsRegs - kCountRegs) >=
                  0,
              "one role takes what the other gives up");

// Sets this warpgroup's registers a thread to kRegs (kLaunch at launch):
// setmaxnreg.dec gives registers back to the CTA's pool, setmaxnreg.inc
// waits for them.
template <int kRegs, int kLaunch>
__device__ __forceinline__ void set_regs() {
  if constexpr (kRegs < kLaunch) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  } else if constexpr (kRegs > kLaunch) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  }
}

// CTAs an SM and registers a thread (at launch, the band role's, the count
// role's) of the instantiation with kNW counter words a lane.
template <int kNW>
struct WsRegs {
  static constexpr int kCtas = kNW == 1 ? 2 : 1;
  static constexpr int kLaunch = 65536 / (kCtas * kWsThreads) / 8 * 8;
  static constexpr int kBand = kNW == 1 ? kBandRegs : kLaunch;
  static constexpr int kCount = kNW == 1 ? kCountRegs : kLaunch;
};
static_assert(kBandWarps == 2 * kCountWarps, "two band warps a count warp");
constexpr int kHdr = 1;   // a slot's header: the mask of its frames with rows
constexpr int kRing = 4;  // slots a count warp: two groups

// Dynamic shared memory of the warp-specialised kernel, in bytes, laid out
// for the largest chunk of its class (kBig: chunks of more than 1,024
// frames), so every offset and stride is a constant: the staged chunk and
// kept order and both prefix bitsets (the second's rows of kPs words after
// the first's rows of the chunk's own count of blocks); each ring slot's
// full and empty mbarriers; per count warp its tile's kOvf int counts, a
// ring of kRing slots (a header and kBatch rows of hit words) and its
// planes for the merge at a tile's end; each of the row's queries' first
// offset and vote slot, in order (32 mw of each); for queries of more than
// kFoldAt frames, per count warp its fold counts. The offsets that the
// roles' loops read are constants, so no register holds them.
__host__ __device__ constexpr long long up16(long long o) {
  return (o + 15) & ~15LL;
}
template <bool kBig>
struct WsLayout {
  static constexpr int kChunk = kBig ? kMaxChunk : 1024;
  static constexpr int kLg = kBig ? 5 : 3;
  static constexpr int kNb = kChunk >> kLg;
  // a hit row's words: a zero word each side of the chunk's, and one more
  // (an odd stride: the two lanes of each of 16 frames hit 32 banks)
  static constexpr int kRs = kChunk / 32 + 3;
  static constexpr int kSlot = kHdr + kBatch * kRs;  // a slot's words
  static constexpr int kPs = kChunk / 32 + 1;  // a prefix bitset row's words
  static constexpr long long kEnt = 0;
  static constexpr long long kPos0 = kEnt + 8LL * kChunk;
  static constexpr long long kD1 = up16(kPos0 + 2LL * kChunk);
  static constexpr long long kPos1 = kD1 + 4LL * kChunk;
  static constexpr long long kD0t = up16(kPos1 + 2LL * kChunk);
  static constexpr long long kP0 = up16(kD0t + 4LL * kChunk);
  static constexpr long long kBars = up16(kP0 + 8LL * (kNb + 1) * kPs);
  static constexpr long long kOvfs = kBars + 16LL * kCountWarps * kRing;
  static constexpr long long kRingAt = kOvfs + 4LL * kCountWarps * kOvf;
  static constexpr long long kMerge =
      kRingAt + 4LL * kCountWarps * kRing * kSlot;
  __host__ __device__ static constexpr long long first_at(int nw) {
    return kMerge + 4LL * kCountWarps * nw * kPlanes * 32;
  }
  // then the fold counts, after the row's queries' first offsets and vote
  // slots (32 mw each)
  __host__ __device__ static constexpr long long fold_at(int nw, int mw) {
    return first_at(nw) + 4LL * 64 * mw;
  }
  __host__ __device__ static constexpr long long total(int nw, bool fold,
                                                       int mw) {
    return fold_at(nw, mw) + (fold ? 4096LL * kCountWarps * nw : 0);
  }
};

// Syncs the band warps (named barrier 1).
struct BandSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kBandWarps * 32) : "memory");
  }
};

// Syncs the count warps (named barrier 2).
__device__ __forceinline__ void count_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kCountWarps * 32) : "memory");
}

// The first tile offset of the round of the row's queries [r0, r0 + nr):
// the first offset any of them reaches (s_first: each query's, from its
// last active frame) rounded down to a word, or n_off where none has an
// active frame.
__device__ __forceinline__ int round_first(const int* s_first, int r0,
                                           int nr, int n_off) {
  int first = kIntMax;
  for (int k = 0; k < nr; ++k) first = min(first, s_first[r0 + k]);
  return first == kIntMax ? n_off : first & ~31;
}

// Count warps a query of a round of nr queries: a power of two.
__device__ __forceinline__ int count_per_query(int nr) {
  return 1 << (31 - __clz(kCountWarps / nr));
}

template <int kNW, bool kBig>
__global__ void __launch_bounds__(kWsThreads, WsRegs<kNW>::kCtas)
    match_votes_aligned_bits_kernel_ws(
        const float* __restrict__ db, const float* __restrict__ q,
        const float2* __restrict__ ent, const short* __restrict__ pos,
        const int* __restrict__ n_live, const float* __restrict__ d1k,
        const short* __restrict__ pos1k, const int* __restrict__ n1k,
        int rows, int t_len, int n_coefs, int coefs, int f_len, int chunk,
        int n_chunks, float tol, int fold, const int* __restrict__ work,
        const unsigned long long* __restrict__ n_work,
        const unsigned* __restrict__ qmask, int mw, int every, int n_cand,
        const int* __restrict__ slots, const int4* __restrict__ items,
        const int* __restrict__ n_items, int* __restrict__ votes,
        unsigned long long* __restrict__ routes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_count[3];
  constexpr int kOT = 1024 * kNW + kOvf;  // offsets per tile
  // frames a count warp adds at once: eight with one counter word a lane,
  // four with more (registers for the planes)
  constexpr int kGrp = kNW == 1 ? 8 : 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the block's row a and its nq queries: a listed row's, its mask's set
  // bits; or a work item's (blocks past the list or the items leave)
  if (work && (unsigned long long)blockIdx.x >= *n_work) return;  // uniform
  const int i_item = work ? work[blockIdx.x] : (int)blockIdx.x;
  if (!qmask && !work && items && i_item >= *n_items) return;  // uniform
  const int4 wi = qmask ? make_int4(i_item, 0, 0, 0)
                        : group_item(items, slots, i_item, every, rows);
  const int a = wi.x;
  const unsigned* qm = qmask ? qmask + (size_t)a * mw : nullptr;
  int cnt = (qm || lane) ? 0 : wi.z;
  for (int i = lane; qm && i < mw; i += 32) cnt += __popc(qm[i]);
  // a reduction, so the count is known uniform (a uniform register holds it)
  const int nq = __reduce_add_sync(kFull, cnt);
  if (nq == 0) return;  // uniform: no query (votes stay 0)
  const int* nl = n_live + (size_t)a * n_chunks;
  {
    int live = 0;
    for (int c = lane; c < n_chunks; c += 32) live |= nl[c];
    if (!__syncthreads_or(live)) return;  // no stored frame: votes stay 0
  }
  using Lay = WsLayout<kBig>;
  constexpr int rs = Lay::kRs;
  const int nwc = (chunk + 31) / 32;
  unsigned* s_ring = reinterpret_cast<unsigned*>(smem + Lay::kRingAt);
  int* s_ovf = reinterpret_cast<int*>(smem + Lay::kOvfs);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + Lay::kBars);
  uint64_t* s_empty = s_full + kCountWarps * kRing;
  for (int i = threadIdx.x; i < kCountWarps * kOvf; i += kWsThreads) {
    s_ovf[i] = 0;
  }
  if (fold) {
    int* fb = reinterpret_cast<int*>(smem + Lay::fold_at(kNW, mw));
    for (int i = threadIdx.x; i < kCountWarps * kNW * 1024; i += kWsThreads) {
      fb[i] = 0;
    }
  }
  {  // the rows' zero words stay zero: no band warp writes them
    uint4* z = reinterpret_cast<uint4*>(s_ring);
    for (int i = threadIdx.x; i < kCountWarps * kRing * Lay::kSlot / 4;
         i += kWsThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the row's queries in order: each one's vote slot (query b's slot b *
  // n_cand + the row's column, n_cand the rows for a listed row), then its
  // first offset, F-1 less its last active frame (kIntMax with none), a
  // warp a query
  int* s_first = reinterpret_cast<int*>(smem + Lay::first_at(kNW));
  int* s_slot = s_first + 32 * mw;
  if (qm) {
    for (int b = threadIdx.x; b < 32 * mw; b += kWsThreads) {
      const unsigned m = qm[b >> 5];
      if (!((m >> (b & 31)) & 1u)) continue;
      int r = __popc(m & ((1u << (b & 31)) - 1u));
      for (int i = 0; i < (b >> 5); ++i) r += __popc(qm[i]);
      s_slot[r] = b * rows + a;
    }
  } else {
    for (int r = threadIdx.x; r < nq; r += kWsThreads) {
      s_slot[r] = item_slot(items, slots, wi, r, n_cand);
    }
  }
  __syncthreads();
  for (int r = warp; r < nq; r += kWsThreads / 32) {
    const float* act = q + (size_t)(s_slot[r] / n_cand) * (coefs + 2) *
                               f_len +
                       (size_t)(coefs + 1) * f_len;
    int last = -1;
    for (int f0 = (f_len - 1) & ~31; f0 >= 0 && last < 0; f0 -= 32) {
      const int f = f0 + lane;
      const unsigned m = __ballot_sync(kFull, f < f_len && act[f] > 0.f);
      if (m) last = f0 + 31 - __clz(m);
    }
    if (lane == 0) s_first[r] = last >= 0 ? f_len - 1 - last : kIntMax;
  }
  if (threadIdx.x < 3) s_count[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kCountWarps * kRing; ++i) {
      mbar_init(s_full + i, 1);   // the band warp's lane 0
      mbar_init(s_empty + i, 1);  // the count warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t q_len = (size_t)(coefs + 2) * f_len;
  const int n_off = t_len + f_len - 1;
  const bool two = coefs > 1;

  if (warp < kBandWarps) {
    // ---------------------------------------------------- band role --- //
    set_regs<WsRegs<kNW>::kBand, WsRegs<kNW>::kLaunch>();
    constexpr int kBandThreads = kBandWarps * 32;
    float2* s_ent = reinterpret_cast<float2*>(smem + Lay::kEnt);
    unsigned short* s_pos0 =
        reinterpret_cast<unsigned short*>(smem + Lay::kPos0);
    float* s_d1 = reinterpret_cast<float*>(smem + Lay::kD1);
    unsigned short* s_pos1 =
        reinterpret_cast<unsigned short*>(smem + Lay::kPos1);
    float* s_d0t = reinterpret_cast<float*>(smem + Lay::kD0t);  // by time
    unsigned* s_p0 = reinterpret_cast<unsigned*>(smem + Lay::kP0);
    constexpr int lg = Lay::kLg;
    const int nb = (chunk + (1 << lg) - 1) >> lg;
    constexpr int ps = Lay::kPs;
    unsigned* s_p1 = s_p0 + (nb + 1) * ps;  // as build_bitsets lays it
    const int cw = warp >> 1;  // this warp's count warp
    const int pair = warp & 1;  // its slot pairs: (j / 2) % 2 == pair
    int staged = -1, n0 = 0, n1 = 0;
    int top = 1;  // bands4's, for the staged chunk
    int jp = 0;  // the count warp's batches so far
    for (int r0 = 0; r0 < nq; r0 += kCountWarps) {
      const int nr = min(kCountWarps, nq - r0);
      const int cpq = count_per_query(nr);
      const int k = cw / cpq, sub = cw & (cpq - 1);
      const int o_first = round_first(s_first, r0, nr, n_off);
      const float* qb =
          q + (size_t)(k < nr ? s_slot[r0 + k] / n_cand : 0) * q_len;
      for (int o0 = o_first; o0 < n_off; o0 += kOT) {
        const int c_lo = max(0, o0 - (f_len - 1)) / chunk;
        const int c_hi = min(t_len - 1, o0 + kOT - 1) / chunk;
        for (int c = c_lo; c <= c_hi; ++c) {
          if (nl[c] == 0) continue;  // uniform
          const int t0 = c * chunk;
          if (c != staged) {  // uniform across the band warps
            BandSync()();     // the previous chunk is consumed
            n0 = nl[c];
            const size_t off = ((size_t)a * n_chunks + c) * chunk;
            if (two) {  // the kept order, waited for with the d0 order
              n1 = n1k[(size_t)a * n_chunks + c];
              stage_kept_async(s_d1, s_pos1, d1k, pos1k, off, (n1 + 1) & ~1,
                               threadIdx.x, kBandThreads);
            }
            stage_chunk_async(s_ent, s_pos0, ent, pos, off, (n0 + 1) & ~1,
                              threadIdx.x, kBandThreads);
            BandSync()();
            build_bitsets(s_p0, s_d0t, s_ent, s_pos0, s_pos1, n0, n1, two,
                          nwc, lg, nb, ps, threadIdx.x, kBandThreads,
                          BandSync());
            staged = c;
            top = bands_top(n0, two ? n1 : 0);
          }
          if (k >= nr) continue;  // no query for this count warp
          // the frames whose offsets [t0 + d, t0 + clen + d) (d = F-1-f)
          // meet this tile, in 32-frame groups: the count warp's groups g
          // = sub + i cpq, its batches j = jp + 2 i and jp + 2 i + 1
          const int clen = min(chunk, t_len - t0);
          const int f_a = max(0, f_len - o0 - kOT + t0);
          const int f_b = min(f_len, f_len - 1 - o0 + t0 + clen);
          const int n_g = f_b > f_a ? (f_b - f_a + 31) >> 5 : 0;
          const int n_i = n_g > sub ? (n_g - sub + cpq - 1) / cpq : 0;
          for (int i = (pair - (jp >> 1)) & 1; i < n_i; i += 2) {
            const int g0 = f_a + (sub + i * cpq) * 32;
            // a lane per frame: its bands
            const int f = g0 + lane;
            const bool act =
                f < f_b && qb[(size_t)(coefs + 1) * f_len + f] > 0.f;
            int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
            float q0 = 0.f, q1 = 0.f;
            bool use2 = false, wide = false;
            if (act) {
              use2 = two && qb[(size_t)coefs * f_len + f] > 0.f;
              q0 = qb[f];
              q1 = two ? qb[(size_t)f_len + f] : 0.f;
              bands4(s_ent, n0, q0, s_d1, use2 ? n1 : 0, q1, tol, top, lo0,
                     hi0, lo1, hi1);
              wide = hi0 - lo0 > kDirect;
            }
            const bool go = act && hi0 > lo0 && !(wide && use2 && hi1 == lo1);
            const unsigned todo = __ballot_sync(kFull, go);
            const unsigned wides = __ballot_sync(kFull, go && wide);
            // the whole blocks of each band, and its two edges [lo, e) and
            // [s, hi) (a band inside one block is all edge)
            const int lb0 = (lo0 + (1 << lg) - 1) >> lg, hb0 = hi0 >> lg;
            const int lb1 = (lo1 + (1 << lg) - 1) >> lg, hb1 = hi1 >> lg;
            const int e0 = min(hi0, lb0 << lg), s0e = max(hb0 << lg, e0);
            const int e1 = min(hi1, lb1 << lg), s1e = max(hb1 << lg, e1);
            const unsigned pk0 = (unsigned)lo0 | ((unsigned)e0 << 16);
            const unsigned pk1 = (unsigned)s0e | ((unsigned)hi0 << 16);
            const unsigned pk2 = (unsigned)lo1 | ((unsigned)e1 << 16);
            const unsigned pk3 = (unsigned)s1e | ((unsigned)hi1 << 16);
            const unsigned pkb = (unsigned)lb0 | ((unsigned)hb0 << 8) |
                                 ((unsigned)lb1 << 16) | ((unsigned)hb1 << 24);
            const int flags = (use2 ? 1 : 0) | (wide ? 2 : 0);
            // batches of kBatch frames, two lanes a frame: lane fi + 16 hf
            // builds frame h + fi's hit row in words [k_lo, k_hi): the hit at
            // time t at bit p = t - sh + 32 (sh = b % 32, b the time its
            // tile's first offset reads, so that a count warp reads whole
            // words: bit i of word q + 1 + u is time b + 32 u + i, q = b / 32)
            const int fi = lane & (kBatch - 1), hf = lane >> 4;
            const int nwh = (nwc + 1) >> 1;
            const int k_lo = hf * nwh, k_hi = hf ? nwc + 1 : nwh;
#pragma unroll 1
            for (int h = 0; h < 32; h += kBatch) {
              const int j = jp + 2 * i + h / kBatch;
              const int si = cw * kRing + (j & (kRing - 1));
              unsigned* slot = s_ring + si * Lay::kSlot;
              unsigned* ra0 = slot + kHdr + 1;  // word 0 of frame 0's row
              mbar_wait(s_empty + si, ((j / kRing) & 1) ^ 1);
              const unsigned bm = todo & (((1u << kBatch) - 1u) << h);
              if (bm) {  // uniform
                const int src = h + fi;
                const unsigned a0 = __shfl_sync(kFull, pk0, src);
                const unsigned a1 = __shfl_sync(kFull, pk1, src);
                const unsigned a2 = __shfl_sync(kFull, pk2, src);
                const unsigned a3 = __shfl_sync(kFull, pk3, src);
                const unsigned blk = __shfl_sync(kFull, pkb, src);
                const int fl = __shfl_sync(kFull, flags, src);
                const float q1j = __shfl_sync(kFull, q1, src);
                const float q0j = __shfl_sync(kFull, q0, src);
                const bool in = (bm >> src) & 1u;
                const bool wd = fl & 2, u2 = fl & 1;
                const int fj = g0 + src;
                const int sh = (o0 - (f_len - 1 - fj) - t0) & 31;
                unsigned* ra = ra0 + fi * rs;
                // hits = B0 & (B1 or no use2), B = F | E: the whole blocks'
                // F0 & F1 from the prefix bitsets (a narrow band: none), each
                // row word from two of theirs ...
                if (in) {
                  const int blb0 = blk & 0xff, bhb0 = (blk >> 8) & 0xff;
                  const int blb1 = (blk >> 16) & 0xff, bhb1 = blk >> 24;
                  const bool full = wd && bhb0 > blb0 && (!u2 || bhb1 > blb1);
                  auto whole = [&](int w) {  // 0 <= w < nwc
                    unsigned x = 0u;
                    if (full) {
                      x = s_p0[bhb0 * ps + w] & ~s_p0[blb0 * ps + w];
                      if (u2) x &= s_p1[bhb1 * ps + w] & ~s_p1[blb1 * ps + w];
                    }
                    return x;
                  };
                  unsigned prev = k_lo > 0 ? whole(k_lo - 1) : 0u;
                  const int k_end = min(k_hi, nwc);
#pragma unroll 2
                  for (int k = k_lo; k < k_end; ++k) {
                    const unsigned cur = whole(k);
                    ra[k] = __funnelshift_r(prev, cur, sh);
                    prev = cur;
                  }
                  if (k_hi > nwc) ra[nwc] = __funnelshift_r(prev, 0u, sh);
                }
                __syncwarp();
                // ... then each band's edge entries E0, E1 (every other one
                // each of the frame's two lanes) tested on the other
                // coefficient's value: E0 & B1 | B0 & E1. Or a narrow band's
                // entries that pass coefficient 1 and the rest
                if (in) {
                  const int l0 = a0 & 0xffffu, ee0 = a0 >> 16;
                  const int ss0 = a1 & 0xffffu, h0 = a1 >> 16;
                  if (wd) {
                    const int n_a0 = ee0 - l0, n_a = n_a0 + (h0 - ss0);
#pragma unroll 1
                    for (int i = hf; i < n_a; i += 2) {
                      const int r = i < n_a0 ? l0 + i : ss0 + i - n_a0;
                      const int t = s_pos0[r];
                      if (!u2 || fabsf(s_ent[r].y - q1j) <= tol) {
                        const int p = t - sh + 32;
                        atomicOr(ra + (p >> 5), 1u << (p & 31));
                      }
                    }
                    if (u2) {
                      const int l1 = a2 & 0xffffu, ee1 = a2 >> 16;
                      const int ss1 = a3 & 0xffffu, h1 = a3 >> 16;
                      const int n_b0 = ee1 - l1, n_b = n_b0 + (h1 - ss1);
#pragma unroll 1
                      for (int i = hf; i < n_b; i += 2) {
                        const int t =
                            s_pos1[i < n_b0 ? l1 + i : ss1 + i - n_b0];
                        if (fabsf(s_d0t[t] - q0j) <= tol) {
                          const int p = t - sh + 32;
                          atomicOr(ra + (p >> 5), 1u << (p & 31));
                        }
                      }
                    }
                  } else if (h0 - l0 <= kPairWalk) {
                    for (int i = hf; i < h0 - l0; i += 2) {
                      const int r = l0 + i;
                      const int t = s_pos0[r];
                      bool ok = !u2 || fabsf(s_ent[r].y - q1j) <= tol;
                      if (ok && coefs > 2) {
                        ok = rest_close_inline(
                            db + ((size_t)a * t_len + t0 + t) * n_coefs, qb,
                            fj, f_len, coefs, tol);
                      }
                      if (ok) {
                        const int p = t - sh + 32;
                        atomicOr(ra + (p >> 5), 1u << (p & 31));
                      }
                    }
                  }
                }
                // a longer band tested entry by entry: the whole warp walks
                const unsigned longs = __ballot_sync(
                    kFull, hf == 0 && in && !wd &&
                               (int)(a1 >> 16) - (int)(a0 & 0xffffu) >
                                   kPairWalk);
                for (unsigned ml = longs; ml; ml &= ml - 1) {  // uniform
                  const int kk = __ffs(ml) - 1;
                  const unsigned b0 = __shfl_sync(kFull, a0, kk);
                  const unsigned b1 = __shfl_sync(kFull, a1, kk);
                  const int flk = __shfl_sync(kFull, fl, kk);
                  const float q1k = __shfl_sync(kFull, q1j, kk);
                  const int l0 = b0 & 0xffffu, h0 = b1 >> 16;
                  const int fk = g0 + h + kk;
                  const int shk = (o0 - (f_len - 1 - fk) - t0) & 31;
                  unsigned* rk = ra0 + kk * rs;
#pragma unroll 2
                  for (int i = lane; i < h0 - l0; i += 32) {
                    const int r = l0 + i;
                    const int t = s_pos0[r];
                    bool ok = !(flk & 1) || fabsf(s_ent[r].y - q1k) <= tol;
                    if (ok && coefs > 2) {
                      ok = rest_close_inline(
                          db + ((size_t)a * t_len + t0 + t) * n_coefs, qb, fk,
                          f_len, coefs, tol);
                    }
                    if (ok) {
                      const int p = t - shk + 32;
                      atomicOr(rk + (p >> 5), 1u << (p & 31));
                    }
                  }
                }
                __syncwarp();
                // coefficients 2.. on the hits
                if (in && wd && coefs > 2) {
                  for (int k = k_lo; k < k_hi; ++k) {
                    const unsigned x0 = ra[k];
                    unsigned x = x0;
                    for (unsigned mm = x0; mm; mm &= mm - 1) {
                      const int bit = __ffs(mm) - 1;
                      const int t = k * 32 + bit + sh - 32;
                      if (!rest_close_inline(
                              db + ((size_t)a * t_len + t0 + t) * n_coefs, qb,
                              fj, f_len, coefs, tol)) {
                        x &= ~(1u << bit);
                      }
                    }
                    if (x != x0) ra[k] = x;
                  }
                }
                if (lane == 0) {
                  slot[0] = bm >> h;  // the frames with a band: their rows
                  // route counts: frames on the bitsets, entry by entry
                  atomicAdd(&s_count[1],
                            (unsigned long long)__popc(bm & wides));
                  atomicAdd(&s_count[2],
                            (unsigned long long)__popc(bm & ~wides));
                }
              } else if (lane == 0) {
                slot[0] = 0u;  // no frame of the batch has a band
              }
              __syncwarp();  // the warp's writes, then one arrival
              if (lane == 0) mbar_arrive(s_full + si);
            }
          }
          jp += 2 * n_i;
        }
      }
    }
    BandSync()();
    if (threadIdx.x >= 1 && threadIdx.x < 3 && s_count[threadIdx.x]) {
      atomicAdd(routes + threadIdx.x, s_count[threadIdx.x]);
    }
    return;
  }

  // ------------------------------------------------------ count role --- //
  set_regs<WsRegs<kNW>::kCount, WsRegs<kNW>::kLaunch>();
  const int cw = warp - kBandWarps;
  unsigned* s_merge = reinterpret_cast<unsigned*>(smem + Lay::kMerge);
  // this warp's own fold and kOvf counts: a query's count warps are cw ..
  // cw + cpq - 1, their areas consecutive (a warp may start the next round
  // while another still ends this one, so no area is a query's)
  int* fq = reinterpret_cast<int*>(smem + Lay::fold_at(kNW, mw)) +
            cw * kNW * 1024;
  int* ovq = s_ovf + cw * kOvf;
  int jc = 0;  // this warp's batches so far
  for (int r0 = 0; r0 < nq; r0 += kCountWarps) {
    const int nr = min(kCountWarps, nq - r0);
    const int cpq = count_per_query(nr);
    const int k = cw / cpq, sub = cw & (cpq - 1);
    const bool mine = k < nr;
    const int o_first = round_first(s_first, r0, nr, n_off);
    int best = 0;
    for (int o0 = o_first; o0 < n_off; o0 += kOT) {
      Counters<kNW> cnt;
      cnt.clear();
      const int c_lo = max(0, o0 - (f_len - 1)) / chunk;
      const int c_hi = min(t_len - 1, o0 + kOT - 1) / chunk;
      for (int c = c_lo; c <= c_hi; ++c) {
        if (nl[c] == 0 || !mine) continue;  // uniform
        const int t0 = c * chunk;
        const int clen = min(chunk, t_len - t0);
        const int f_a = max(0, f_len - o0 - kOT + t0);
        const int f_b = min(f_len, f_len - 1 - o0 + t0 + clen);
        const int n_g = f_b > f_a ? (f_b - f_a + 31) >> 5 : 0;
        // its groups g = sub + i cpq, two batches each: m_b = 2 g + h
        const int n_b = n_g > sub ? 2 * ((n_g - sub + cpq - 1) / cpq) : 0;
        for (int ib = 0; ib < n_b; ++ib, ++jc) {
          const int m_b = 2 * (sub + (ib >> 1) * cpq) + (ib & 1);
          const int si = cw * kRing + (jc & (kRing - 1));
          const unsigned* slot = s_ring + si * Lay::kSlot;
          const unsigned* ra0 = slot + kHdr + 1;  // word 0 of frame 0's row
          mbar_wait(s_full + si, (jc / kRing) & 1);
          const unsigned counted = slot[0];
          // frame kf of the batch (frame fh + kf): the tile's offset o0 +
          // 32 u + i (u = lane + 32 jw) reads time b + 32 u + i of the
          // chunk, b = b0 + kf: bit i of its row's word q + 1 + u, q = b /
          // 32 (a row's words are 0 .. nwc, zero past them)
          const int fh = f_a + (m_b >> 1) * 32 + (m_b & 1) * kBatch;
          const int b0 = o0 - (f_len - 1 - fh) - t0;
          for (unsigned m = counted; m;) {  // uniform: kGrp frames at once
            int kfs[kGrp];  // the frames (-1: none, zeros added)
#pragma unroll
            for (int i = 0; i < kGrp; ++i) {
              kfs[i] = m ? __ffs(m) - 1 : -1;
              m &= m - 1;
            }
#pragma unroll
            for (int jw = 0; jw < kNW; ++jw) {
              // words no frame of the batch reaches: skipped
              if ((b0 >> 5) + 1 + 32 * jw > nwc ||
                  ((b0 + kBatch) >> 5) + 32 + 32 * jw < 0) {
                continue;  // uniform
              }
              unsigned x[kGrp];
#pragma unroll
              for (int i = 0; i < kGrp; ++i) {
                const int kf = max(kfs[i], 0);
                const int w = ((b0 + kf) >> 5) + 1 + 32 * jw + lane;
                const unsigned v = ra0[kf * rs + min(max(w, -1), nwc + 1)];
                x[i] = kfs[i] < 0 ? 0u : v;
              }
              cnt.add(jw, x);
              if (fold && cnt.n[jw] > kFoldAt - kGrp) {  // uniform
                cnt.flush();
                cnt.fold_into(fq);
              }
            }
            // the tile's last kOvf offsets (words 32 kNW + lane, lane < 4),
            // which only frames whose hits lie near the chunk's end reach:
            // their bits one by one
            if ((b0 >> 5) + 1 + 32 * kNW > nwc) continue;  // uniform
#pragma unroll
            for (int i = 0; i < kGrp; ++i) {
              if (kfs[i] < 0 || lane >= kOvf / 32) continue;
              const int w = ((b0 + kfs[i]) >> 5) + 1 + 32 * kNW + lane;
              unsigned x = ra0[kfs[i] * rs + min(max(w, -1), nwc + 1)];
              for (; x; x &= x - 1) {
                atomicAdd(ovq + lane * 32 + __ffs(x) - 1, 1);
              }
            }
          }
          __syncwarp();  // the warp's reads, then one arrival
          if (lane == 0) mbar_arrive(s_empty + si);  // the slot is read
        }
      }
      // the tile's counts are complete: merge the query's count warps (a
      // tree of bit-sliced adds; folded counts and kOvf counts summed by
      // its first), take the max
      cnt.flush();
      if (fold && mine) cnt.fold_into(fq);
      if (cpq > 1) {  // uniform
        if (fold) count_sync();
        for (int step = 1; !fold && step < cpq; step <<= 1) {
          if (mine && (sub & (2 * step - 1)) == step) {
            // the planes into this warp's merge area
            unsigned* o = s_merge + cw * kNW * kPlanes * 32;
#pragma unroll
            for (int jw = 0; jw < kNW; ++jw) {
#pragma unroll
              for (int kp = 0; kp < kPlanes; ++kp) {
                o[(jw * kPlanes + kp) * 32 + lane] = cnt.planes[jw][kp];
              }
            }
          }
          count_sync();
          if (mine && (sub & (2 * step - 1)) == 0) {  // added to the left
            const unsigned* o = s_merge + (cw + step) * kNW * kPlanes * 32;
#pragma unroll
            for (int jw = 0; jw < kNW; ++jw) {
              unsigned carry = 0u;
#pragma unroll
              for (int kp = 0; kp < kPlanes; ++kp) {
                const unsigned y = o[(jw * kPlanes + kp) * 32 + lane];
                const unsigned p = cnt.planes[jw][kp];
                cnt.planes[jw][kp] = p ^ y ^ carry;
                carry = (p & y) | (carry & (p ^ y));
              }
            }
          }
        }
      }
      if (mine && sub == 0) {
        int m = fold ? 0 : cnt.max_count();
        for (int i = lane; fold && i < 32 * 32 * kNW; i += 32) {
          int v = 0;
          for (int s = 0; s < cpq; ++s) {
            v += fq[s * kNW * 1024 + i];
            fq[s * kNW * 1024 + i] = 0;
          }
          m = max(m, v);
        }
        for (int i = lane; i < kOvf; i += 32) {
          int v = 0;
          for (int s = 0; s < cpq; ++s) {
            v += ovq[s * kOvf + i];
            ovq[s * kOvf + i] = 0;
          }
          m = max(m, v);
        }
        best = max(best, __reduce_max_sync(kFull, m));
      }
      if (cpq > 1) count_sync();  // merge areas and counts free
    }
    if (mine && sub == 0 && lane == 0) {
      votes[s_slot[r0 + k]] = best;
      atomicAdd(&s_count[0], 1ull);
    }
  }
  count_sync();
  if (threadIdx.x == kBandWarps * 32 && s_count[0]) {
    atomicAdd(routes, s_count[0]);
  }
}

}  // namespace


// Warps per block of the aligned index kernel for this chunk, query length
// and batch (at most 8 and at most one per query); 0 when not even one
// warp's histogram fits in shared memory (then the full scan and the
// grouped candidate form take the bit-sliced kernel on every item).
extern "C" int tiresias_match_aligned_warps(int chunk, int f_len, int batch) {
  int w = min(kWarps, batch);
  while (w > 0 && aligned_smem(chunk, f_len, w) > kMaxSmem) --w;
  return w;
}

// cand: null for votes [batch, rows], or [batch, n_cand] row ids for the
// candidate form's votes [batch, n_cand] (its own instantiation of each
// kernel, so the full kernels carry none of its branches).
extern "C" int tiresias_match_votes(const void* db, const void* q,
                                    const void* ent, const void* pos,
                                    const void* n_live, int batch, int rows,
                                    int t_len, int n_coefs, int coefs,
                                    int f_len, int chunk, int n_chunks,
                                    float tol, float share, const void* cand,
                                    int n_cand, void* votes, void* routes,
                                    void* stream) {
  // votes must be zeroed: blocks add their partial counts
  if (chunk > kMaxChunk || chunk % 2) return (int)cudaErrorInvalidValue;
  const long long groups = (f_len + 31) / 32;
  const long long items = (cand ? 1LL : (long long)batch) * groups;
  const long long blocks = cand ? (long long)batch * n_cand : rows;
  const dim3 grid((unsigned)blocks,
                  (unsigned)((items + kMaxItems - 1) / kMaxItems));
  auto kernel = cand ? match_votes_kernel<true> : match_votes_kernel<false>;
  kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)db, (const float*)q, (const float2*)ent,
      (const short*)pos, (const int*)n_live, batch, rows, t_len, n_coefs,
      coefs, f_len, chunk, n_chunks, tol, share, (const int*)cand, n_cand,
      (int*)votes, (unsigned long long*)routes);
  return (int)cudaGetLastError();
}

// The index's kept coefficient-1 order (ops/match_index.py; null for a
// one-coefficient store) and the work items of the bit-sliced kernel.
struct Kept {
  const float* d1;
  const short* pos1;
  const int* n1;
};
// A launch's rows of the bit-sliced kernel: the rows the full scan's index
// kernel listed (work[0, n_work[0]), qmask [rows, mw] their queries' masks),
// or (qmask null) work items of group_item's, listed (work, n_work) or not.
struct BitsItems {
  const int* work;
  const unsigned long long* n_work;
  const unsigned* qmask;
  int mw;
  int every, n_cand;        // group_item's
  const int* slots;
  const int4* items;
  const int* n_items;
};

// Launches the bit-sliced kernel on `grid` blocks (an upper bound of the
// rows or work items; blocks past them leave). routes: three u64 (items,
// frames on the bitsets, frames entry by entry).
static int launch_bits(const void* db, const void* q, const void* ent,
                       const void* pos, const void* n_live, Kept kept,
                       int rows, int t_len, int n_coefs, int coefs,
                       int f_len, int chunk, int n_chunks, float tol,
                       long long grid, const BitsItems& it, int* votes,
                       unsigned long long* routes, cudaStream_t st) {
  if (chunk > kMaxChunk || chunk < 2 || chunk % 2 || f_len < 1 ||
      t_len < 1 || grid > 0x7fffffffLL ||
      (coefs > 1 && (!kept.d1 || !kept.pos1 || !kept.n1)) ||
      it.mw < 1 ||
      (it.qmask ? !it.work || !it.n_work
                : it.n_cand < 1 || it.every < 0 ||
                      it.every > 32 * it.mw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (grid < 1) return (int)cudaSuccess;
  const bool big = chunk > 1024;
  const long long n_off = (long long)t_len + f_len - 1;
  int nw = n_off <= 1024 + kOvf ? 1 : n_off <= 2048 + kOvf ? 2 : 3;
  const bool fold = f_len > kFoldAt;
  auto total = [&](int n) {
    return big ? WsLayout<true>::total(n, fold, it.mw)
               : WsLayout<false>::total(n, fold, it.mw);
  };
  while (nw > 1 && total(nw) > kMaxSmem) --nw;  // smaller offset tiles
  if (total(nw) > kMaxSmem) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, const float2*,
                          const short*, const int*, const float*,
                          const short*, const int*, int, int, int, int, int,
                          int, int, float, int, const int*,
                          const unsigned long long*, const unsigned*, int,
                          int, int, const int*, const int4*, const int*,
                          int*, unsigned long long*);
  static const Kernel kernels[2][3] = {
      {match_votes_aligned_bits_kernel_ws<1, false>,
       match_votes_aligned_bits_kernel_ws<2, false>,
       match_votes_aligned_bits_kernel_ws<3, false>},
      {match_votes_aligned_bits_kernel_ws<1, true>,
       match_votes_aligned_bits_kernel_ws<2, true>,
       match_votes_aligned_bits_kernel_ws<3, true>}};
  const Kernel kernel = kernels[big ? 1 : 0][nw - 1];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total(nw));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kWsThreads, (size_t)total(nw), st>>>(
      (const float*)db, (const float*)q, (const float2*)ent,
      (const short*)pos, (const int*)n_live, kept.d1, kept.pos1, kept.n1,
      rows, t_len, n_coefs, coefs, f_len, chunk, n_chunks, tol, (int)fold,
      it.work, it.n_work, it.qmask, it.mw, it.every, it.n_cand, it.slots,
      it.items, it.n_items, votes, routes);
  return (int)cudaGetLastError();
}

// K5's full scan by the bit-sliced kernel alone, every row for every query
// (the forced route "bits", and queries whose offset histogram the index
// kernel cannot hold): votes [batch, rows] zeroed; routes: three u64
// (items, frames on the bitsets, frames entry by entry); d1k/pos1k/n1k the
// index's kept coefficient-1 order (null with coefs 1). One launch a
// kEvery queries (each block's slots and first offsets in shared memory).
constexpr int kEvery = 256;
extern "C" int tiresias_match_votes_aligned_bits(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, const void* d1k, const void* pos1k, const void* n1k,
    int batch, int rows, int t_len, int n_coefs, int coefs, int f_len,
    int chunk, int n_chunks, float tol, void* votes, void* routes,
    void* stream) {
  const size_t q_len = (size_t)(coefs + 2) * f_len;
  for (int b0 = 0; b0 < batch; b0 += kEvery) {
    const int nb = min(kEvery, batch - b0);
    const BitsItems it{nullptr, nullptr, nullptr, (nb + 31) / 32, nb,
                       rows,    nullptr, nullptr, nullptr};
    const int err = launch_bits(
        db, (const float*)q + b0 * q_len, ent, pos, n_live,
        {(const float*)d1k, (const short*)pos1k, (const int*)n1k}, rows,
        t_len, n_coefs, coefs, f_len, chunk, n_chunks, tol, rows, it,
        (int*)votes + (size_t)b0 * rows, (unsigned long long*)routes,
        (cudaStream_t)stream);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

// Resident blocks of the every-pair kernel on this device (its grid).
static int dense_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, match_votes_aligned_dense_kernel, kThreads5, 0);
    grid = max(1, sms * per_sm);
  }
  return grid;
}

template <bool kCand>
static int match_votes_aligned(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, Kept kept, int batch, int rows, int t_len,
    int n_coefs, int coefs, int f_len, int chunk, int n_chunks, float tol,
    float share, int warps, const int* cand, int n_cand, void* votes,
    void* work, void* n_work, void* qmask, void* row_flag, void* routes,
    cudaStream_t st) {
  unsigned long long* nw = (unsigned long long*)n_work;
  unsigned long long* rt = (unsigned long long*)routes;
  cudaError_t err = cudaMemsetAsync(nw, 0, 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)batch * (kCand ? n_cand : rows);
  if (warps == 0 && !kCand) {  // forced: the every-pair kernel
    const int grid = pairs < dense_grid() ? (int)pairs : dense_grid();
    match_votes_aligned_dense_kernel<<<grid, kThreads5, 0, st>>>(
        (const float*)db, (const float*)q, batch, rows, t_len, n_coefs,
        coefs, f_len, tol, nw, (int*)votes);
    return (int)cudaGetLastError();
  }
  const long long smem = aligned_smem(chunk, f_len, warps);
  if (warps < 0 || warps > (kCand ? 1 : kWarps) || smem > kMaxSmem ||
      chunk % 2 || (kCand && share < INFINITY)) {
    return (int)cudaErrorInvalidValue;
  }
  const int mw = (batch + 31) / 32;
  if (!kCand) {
    err = cudaMemsetAsync(qmask, 0, (size_t)rows * mw * sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(row_flag, 0, (size_t)rows * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(match_votes_aligned_kernel<kCand>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = kCand ? pairs : rows;
  match_votes_aligned_kernel<kCand>
      <<<(unsigned)blocks, warps * 32, (size_t)smem, st>>>(
          (const float*)db, (const float*)q, (const float2*)ent,
          (const short*)pos, (const int*)n_live, batch, rows, t_len,
          n_coefs, coefs, f_len, chunk, n_chunks, tol, share, cand, n_cand,
          (int*)votes, (int*)work, nw, (unsigned*)qmask, mw, (int*)row_flag,
          rt);
  err = cudaGetLastError();
  if (err != cudaSuccess || kCand || !(share < INFINITY)) return (int)err;
  // the wide items: the listed rows with their queries
  const BitsItems it{(const int*)work, nw, (const unsigned*)qmask, mw, 0,
                     rows, nullptr, nullptr, nullptr};
  return launch_bits(db, q, ent, pos, n_live, kept, rows, t_len, n_coefs,
                     coefs, f_len, chunk, n_chunks, tol, rows, it,
                     (int*)votes, rt + 2, st);
}

// routes: [index items, wide items, then the bit-sliced kernel's three];
// work: one int per row, n_work two u64 of scratch, qmask rows * ceil(batch
// / 32) u32 and row_flag rows ints of scratch (all null with cand). The
// index kernel takes each item whose bands hold at most share of its pairs
// and hands the others to the bit-sliced kernel (not launched with share
// infinite). warps 0 runs the every-pair kernel on every item (a forced
// route of the full scan only). cand as for tiresias_match_votes: the
// per-item candidate form, one warp per item (warps must be 1), has no
// wide route (share must be infinite). d1k/pos1k/n1k: the index's kept
// coefficient-1 order for the bit-sliced kernel (null with coefs 1).
extern "C" int tiresias_match_votes_aligned(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, const void* d1k, const void* pos1k, const void* n1k,
    int batch, int rows, int t_len, int n_coefs, int coefs, int f_len,
    int chunk, int n_chunks, float tol, float share, int warps,
    const void* cand, int n_cand, void* votes, void* work, void* n_work,
    void* qmask, void* row_flag, void* routes, void* stream) {
  const int* cd = (const int*)cand;
  const cudaStream_t st = (cudaStream_t)stream;
  const Kept kept{(const float*)d1k, (const short*)pos1k, (const int*)n1k};
  if (cd) {
    return match_votes_aligned<true>(db, q, ent, pos, n_live, kept, batch,
                                     rows, t_len, n_coefs, coefs, f_len,
                                     chunk, n_chunks, tol, share, warps, cd,
                                     n_cand, votes, work, n_work, nullptr,
                                     nullptr, routes, st);
  }
  return match_votes_aligned<false>(db, q, ent, pos, n_live, kept, batch,
                                    rows, t_len, n_coefs, coefs, f_len,
                                    chunk, n_chunks, tol, share, warps,
                                    nullptr, 0, votes, work, n_work, qmask,
                                    row_flag, routes, st);
}

// The candidate form's work list (see group_scan_kernel): counts [rows] int
// scratch, slots [batch * n_cand] int (the first n_valid used), items
// [max_items] int4 (max_items >= min(rows, batch * n_cand) + ceil(batch *
// n_cand / g)), n_items one int on the device. g: queries per item.
extern "C" int tiresias_group_candidates(const void* cand, int batch,
                                         int n_cand, int rows, int g,
                                         void* counts, void* slots,
                                         void* items, void* n_items,
                                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (g < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * n_cand;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = want < 1 ? 1u : want > 4096 ? 4096u : (unsigned)want;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)rows * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  group_count_kernel<<<blocks, threads, 0, st>>>((const int*)cand, n, rows,
                                                 (int*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scan_kernel<<<1, kScan, 0, st>>>((int*)counts, rows, g,
                                         (int4*)items, (int*)n_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scatter_kernel<<<blocks, threads, 0, st>>>(
      (const int*)cand, n, rows, (int*)counts, (int*)slots);
  return (int)cudaGetLastError();
}

// K4's grouped candidate form over a work list of at most max_items items
// of up to g (<= kGroup4) queries; votes [batch, n_cand] zeroed.
extern "C" int tiresias_match_votes_group(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, int t_len, int n_coefs, int coefs, int f_len,
    int chunk, int n_chunks, float tol, float share, float share_small,
    int shared_min, int n_cand, int g, const void* slots, const void* items,
    const void* n_items, int max_items, void* votes, void* routes,
    void* stream) {
  if (chunk > kMaxChunk || chunk % 2 || g < 1 || g > kGroup4 ||
      max_items < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_item = (long long)g * ((f_len + 31) / 32);
  const dim3 grid((unsigned)max_items,
                  (unsigned)((per_item + kMaxItems - 1) / kMaxItems));
  match_votes_group_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)db, (const float*)q, (const float2*)ent,
      (const short*)pos, (const int*)n_live, t_len, n_coefs, coefs, f_len,
      chunk, n_chunks, tol, share, share_small, shared_min, n_cand,
      (const int*)slots, (const int4*)items, (const int*)n_items,
      (int*)votes, (unsigned long long*)routes);
  return (int)cudaGetLastError();
}

// Resident blocks of the grouped dense kernel on this device.
template <bool kRest>
static int group_dense_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, match_votes_aligned_group_dense_kernel<kRest>, kThreads5,
        0);
    grid = max(1, sms * per_sm);
  }
  return grid;
}

// K5's grouped candidate form: the index kernel (warps per block, 1 to
// kWarps), then the wide kernels of the mask `wide` over the items it
// listed: 1 the bit-sliced kernel (the items of at least bits_min
// queries), 2 the grouped every-pair kernel (the others). warps 0 runs the
// one wide kernel `wide` names (1 or 2) on every item. work: 2 * max_items
// ints, n_work four u64 of scratch, routes as for
// tiresias_match_votes_aligned; items of up to g (<= kGroup5) queries;
// d1k/pos1k/n1k the index's kept coefficient-1 order (null with coefs 1).
// With items and n_items null there is no list (see
// group_item): every > 0 serves the full scan of that many queries (slots
// null, max_items = n_cand = rows: votes [every, rows]); every 0 batch 1's
// candidates (slots = cand [1, n_cand], max_items = n_cand).
extern "C" int tiresias_match_votes_aligned_group(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, const void* d1k, const void* pos1k, const void* n1k,
    int t_len, int n_coefs, int coefs, int f_len, int chunk, int n_chunks,
    float tol, float share, float share_small, int shared_min,
    float share_bits, int bits_min, int warps, int wide, int n_cand, int g,
    int every, int rows, const void* slots, const void* items,
    const void* n_items, int max_items, void* votes, void* work,
    void* n_work, void* routes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long smem = aligned_smem(chunk, f_len, warps);
  if (g < 1 || g > kGroup5 || max_items < 1 || warps < 0 ||
      warps > kWarps || (warps && (smem > kMaxSmem || chunk % 2)) ||
      rows < 1 || every < 0 || every > kGroup5 || (wide & ~3) ||
      (!warps && wide != 1 && wide != 2) ||
      (items ? every != 0 || !slots || !n_items
             : max_items != n_cand || (every ? n_cand != rows : !slots))) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned long long* nw = (unsigned long long*)n_work;
  unsigned long long* rt = (unsigned long long*)routes;
  cudaError_t err = cudaMemsetAsync(nw, 0, 4 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (warps > 0) {
    err = cudaFuncSetAttribute(match_votes_aligned_group_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    match_votes_aligned_group_kernel<<<(unsigned)max_items, warps * 32,
                                       (size_t)smem, st>>>(
        (const float*)db, (const float*)q, (const float2*)ent,
        (const short*)pos, (const int*)n_live, t_len, n_coefs, coefs, f_len,
        chunk, n_chunks, tol, share, share_small, shared_min, share_bits,
        bits_min, n_cand, every, rows, (const int*)slots,
        (const int4*)items, (const int*)n_items, max_items, (int*)votes,
        (int*)work, nw, rt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (wide & 1) {
    const int* listed = warps > 0 ? (const int*)work : nullptr;
    const BitsItems it{listed, listed ? nw : nullptr, nullptr, 1, every,
                       n_cand, (const int*)slots, (const int4*)items,
                       (const int*)n_items};
    err = (cudaError_t)launch_bits(
        db, q, ent, pos, n_live,
        {(const float*)d1k, (const short*)pos1k, (const int*)n1k}, rows,
        t_len, n_coefs, coefs, f_len, chunk, n_chunks, tol, max_items, it,
        (int*)votes, rt + 2, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(wide & 2)) return (int)cudaSuccess;
  const int resident =
      coefs > 2 ? group_dense_grid<true>() : group_dense_grid<false>();
  const int grid = max_items < resident ? max_items : resident;
  auto kernel = coefs > 2 ? match_votes_aligned_group_dense_kernel<true>
                          : match_votes_aligned_group_dense_kernel<false>;
  kernel<<<grid, kThreads5, 0, st>>>(
      (const float*)db, (const float*)q, t_len, n_coefs, coefs, f_len, tol,
      n_cand, every, rows, (const int*)slots, (const int4*)items,
      (const int*)n_items, warps > 0 ? (const int*)work + max_items : nullptr,
      nw + 2, (int*)votes);
  return (int)cudaGetLastError();
}
