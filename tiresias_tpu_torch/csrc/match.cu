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
// pairs takes the dense route, decided per item on the device: K4 sweeps
// the sorted chunk with the whole warp, as a dense K4 sweeps a row; K5 puts
// the item on a work list that a dense K5 kernel serves right after, on the
// same stream. The kernels add the items of each route into a device
// counter.
//
// Candidate form (the certified strict/aligned prefilter's rescore, the
// Pallas kernels run over each query's candidate rows at
// tiresias_tpu/ops/match_pallas.py:566-577): given cand [batch, n_cand]
// int32 row ids, the kernels compute votes[b, j] of query b against row
// cand[b, j] only, equal to the full kernels' votes at that row. One block
// takes one (query, candidate) item and stages that row's index chunks for
// it alone (no chunk is shared across the batch, so staging is per item);
// K5 puts dense items on its work list as item ids. A row id outside
// [0, rows) scores 0.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPad = -1e6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunk = 2048;  // K4's static stage (ops/match_index.py)
constexpr int kMaxSmem = 232448 - 1024;  // dynamic shared memory per block

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Coefficients 2..coefs-1 of stored frame `frame` against query frame f.
__device__ __noinline__ bool rest_close(const float* frame, const float* qb,
                                        int f, int f_len, int coefs,
                                        float tol) {
  for (int c = 2; c < coefs; ++c) {
    if (!(fabsf(frame[c] - qb[(size_t)c * f_len + f]) <= tol)) return false;
  }
  return true;
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
      if (dense) work[atomicAdd(n_work, 1ull)] = (int)out;
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

// Votes of (query b, row a) = work[w] = b * rows + a for w < n_work[0], or
// of w = b * rows + a for every pair when work is null. With cand, an item
// is a candidate slot b * n_cand + j of row cand[item] instead, and its
// votes go to votes[item]. Blocks take items in turn from the counter
// n_work[1] (zero on entry), so a grid of the resident blocks stays busy to
// the end.
template <bool kCand>
__global__ void __launch_bounds__(kThreads5)
    match_votes_aligned_dense_kernel(const float* __restrict__ db,
                                     const float* __restrict__ q, int batch,
                                     int rows, int t_len, int n_coefs,
                                     int coefs, int f_len, float tol,
                                     const int* __restrict__ cand,
                                     int n_cand,
                                     const int* __restrict__ work,
                                     unsigned long long* n_work,
                                     int* __restrict__ votes) {
  __shared__ float4 qs[kStage5];
  __shared__ float w0[kWin];
  __shared__ float w1[kWin];
  __shared__ int red[kThreads5 / 32];
  __shared__ unsigned long long s_next;
  const unsigned long long total =
      work ? n_work[0]
           : (unsigned long long)batch * (kCand ? n_cand : rows);
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
    const long long item = work ? work[w] : (long long)w;
    const int b = (int)(item / (kCand ? n_cand : rows));
    const int a = kCand ? cand[item] : (int)(item % rows);
    if (kCand && (a < 0 || a >= rows)) continue;  // uniform; votes stay 0
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
      votes[kCand ? (size_t)item : (size_t)b * rows + a] = m;
    }
  }
}

}  // namespace

// Warps per block of the aligned index kernel for this chunk, query length
// and batch (at most 8 and at most one per query); 0 when not even one
// warp's histogram fits in shared memory (then every pair takes the dense
// kernel).
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

// Resident blocks of a dense kernel on this device (its grid).
template <bool kCand>
static int dense_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, match_votes_aligned_dense_kernel<kCand>, kThreads5, 0);
    grid = max(1, sms * per_sm);
  }
  return grid;
}

template <bool kCand>
static int match_votes_aligned(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, int batch, int rows, int t_len, int n_coefs,
    int coefs, int f_len, int chunk, int n_chunks, float tol, float share,
    int warps, const int* cand, int n_cand, void* votes, void* work,
    void* n_work, void* routes, cudaStream_t st) {
  unsigned long long* nw = (unsigned long long*)n_work;
  cudaError_t err = cudaMemsetAsync(nw, 0, 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)batch * (kCand ? n_cand : rows);
  const int grid =
      pairs < dense_grid<kCand>() ? (int)pairs : dense_grid<kCand>();
  if (warps == 0) {
    match_votes_aligned_dense_kernel<kCand><<<grid, kThreads5, 0, st>>>(
        (const float*)db, (const float*)q, batch, rows, t_len, n_coefs,
        coefs, f_len, tol, cand, n_cand, nullptr, nw, (int*)votes);
    return (int)cudaGetLastError();
  }
  const long long smem = aligned_smem(chunk, f_len, warps);
  if (warps < 0 || warps > (kCand ? 1 : kWarps) || smem > kMaxSmem ||
      chunk % 2) {
    return (int)cudaErrorInvalidValue;
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
          (int*)votes, (int*)work, nw, (unsigned long long*)routes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  match_votes_aligned_dense_kernel<kCand><<<grid, kThreads5, 0, st>>>(
      (const float*)db, (const float*)q, batch, rows, t_len, n_coefs, coefs,
      f_len, tol, cand, n_cand, (const int*)work, nw, (int*)votes);
  return (int)cudaGetLastError();
}

// routes: [index items, dense items]; work: one int per item (batch * rows,
// or batch * n_cand with cand) and n_work two u64 of scratch. warps 0 runs
// the dense kernel on every item. cand as for tiresias_match_votes; the
// candidate form runs one warp per item (warps must be 1 or 0).
extern "C" int tiresias_match_votes_aligned(
    const void* db, const void* q, const void* ent, const void* pos,
    const void* n_live, int batch, int rows, int t_len, int n_coefs,
    int coefs, int f_len, int chunk, int n_chunks, float tol, float share,
    int warps, const void* cand, int n_cand, void* votes, void* work,
    void* n_work, void* routes, void* stream) {
  const int* cd = (const int*)cand;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cd) {
    return match_votes_aligned<true>(db, q, ent, pos, n_live, batch, rows,
                                     t_len, n_coefs, coefs, f_len, chunk,
                                     n_chunks, tol, share, warps, cd, n_cand,
                                     votes, work, n_work, routes, st);
  }
  return match_votes_aligned<false>(db, q, ent, pos, n_live, batch, rows,
                                    t_len, n_coefs, coefs, f_len, chunk,
                                    n_chunks, tol, share, warps, nullptr, 0,
                                    votes, work, n_work, routes, st);
}
