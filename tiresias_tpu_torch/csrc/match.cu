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
//   votes [batch, rows] int32.
// Stored frame t matches query frame f when
//   d0 != PAD && |d0-q0| <= tol && (|d1-q1| <= tol || use2 <= 0)
//   && |dc-qc| <= tol for 2 <= c < coefs,
// compared as float32 fabsf(d - q) <= tol, exactly as the TPU kernels do.
// The Pallas kernels encoded both masks as values (PAD -1e6, inactive query
// frames +1e6) and so served only tol < 1e5; here the PAD test and the
// active flag are explicit, and every tolerance is exact.
//
//   bag (K4):     votes[b, a] = #{active f : some t matches}
//   aligned (K5): votes[b, a] = max over o of #{active f : t = o - (F-1) + f
//                 matches}, o = t - f + F - 1 the time offset (PARITY D9)
//
// What bounds them on the H100: compares, not bytes. A search tests
// B*F*A*T frame pairs (64 x 94 x 10,000 x 1,024 = 6e10 at batch 64 on a
// 10k-track catalog) at ~5-7 instructions each, while the 82 MB catalog is
// read once per block from L2 or device memory. So both kernels spend
// their instructions on compares: K4 gives each lane one query frame and
// broadcasts stored frames to the warp from shared memory; K5 gives each
// thread nine consecutive time offsets and slides them along a register
// ring, one shared-memory load per coefficient and query frame. Both skip
// inactive frames and all-padding chunks with uniform branches, and test
// coefficients >= 2 only after coefficients 0 and 1 matched (rarely, from
// the caches). Sums are integers, so votes are deterministic.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPad = -1e6f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

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

// Coefficients 2..coefs-1 of stored frame `frame` against query frame f.
__device__ __noinline__ bool rest_close(const float* frame, const float* qb,
                                        int f, int f_len, int coefs,
                                        float tol) {
  for (int c = 2; c < coefs; ++c) {
    if (!(fabsf(frame[c] - qb[(size_t)c * f_len + f]) <= tol)) return false;
  }
  return true;
}

// ---------------------------------------------------------------- K4 --- //
// One block per stored row (grid.x) and range of work items (grid.y); an
// item is one query's group of 32 consecutive frames, one frame per lane.
// The row streams through shared memory in chunks of kTChunk frames, as
// (d0, d1) pairs with PAD turned into NaN; every lane of a warp reads the
// same pair (a broadcast, two frames per 16-byte load) and tests it against
// its own query frame in registers, so a stored frame costs a warp ~5
// instructions for 32 frame pairs and the query is read once per item.
// A lane stops counting once its frame has hit; a warp leaves the chunk
// when all its live frames have. Each item's hit bits collect in shared
// memory across chunks; a query's votes are the popcounts of its items,
// added into the zeroed output with one integer atomicAdd per block and
// query (integer sums: deterministic whatever the order).
constexpr int kWarps = 8;
constexpr int kTChunk = 2048;   // stored frames per stage (16 KB)
constexpr int kMaxItems = 512;  // items per block (hit words in shared)

// Sweeps stored frames [0, n) of the staged chunk (n even) for one lane's
// query frame. kMode 1: coefficient 0 only; 2: coefficients 0 and 1;
// 3: more, tested only where 0 and 1 matched.
template <int kMode>
__device__ __forceinline__ bool sweep(const float2* srow, int n, float q0,
                                      float q1, bool nouse2, bool live,
                                      float tol, const float* row, int t0,
                                      int n_coefs, const float* qf,
                                      int f_len, int coefs) {
  bool hit = false;
  for (int u0 = 0; u0 < n; u0 += 64) {
    const int u1 = min(n, u0 + 64);
    for (int u = u0; u < u1; u += 2) {
      const float4 d = *reinterpret_cast<const float4*>(srow + u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = h ? d.z : d.x;
        const float d1 = h ? d.w : d.y;
        // bitwise & and |: both compares run, no branch
        bool ok = fabsf(d0 - q0) <= tol;
        if (kMode >= 2) ok &= nouse2 | (fabsf(d1 - q1) <= tol);
        if (kMode == 3 && ok) {
          ok = rest_close(row + (size_t)(t0 + u + h) * n_coefs, qf, 0,
                          f_len, coefs, tol);
        }
        hit |= ok;
      }
    }
    if (__all_sync(kFull, hit || !live)) break;
  }
  return hit;
}

__global__ void __launch_bounds__(kWarps * 32)
    match_votes_kernel(const float* __restrict__ db,
                       const float* __restrict__ q, int batch, int rows,
                       int t_len, int n_coefs, int coefs, int f_len,
                       float tol, int* __restrict__ votes) {
  __shared__ __align__(16) float2 srow[kTChunk];
  __shared__ unsigned hits[kMaxItems];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a = blockIdx.x;
  const int groups = (f_len + 31) / 32;
  const int i0 = blockIdx.y * kMaxItems;
  const int n_items = min(kMaxItems, batch * groups - i0);
  const float* row = db + (size_t)a * t_len * n_coefs;
  for (int i = threadIdx.x; i < n_items; i += blockDim.x) hits[i] = 0u;
  for (int t0 = 0; t0 < t_len; t0 += kTChunk) {
    const int tc = min(kTChunk, t_len - t0);
    const int n = (tc + 1) & ~1;
    __syncthreads();  // the previous chunk is consumed
    bool any_frame = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float2 v = make_float2(nan_f(), nan_f());  // NaN never matches
      if (i < tc) {
        const float* fr = row + (size_t)(t0 + i) * n_coefs;
        const float x = fr[0];
        if (x != kPad) {
          v = make_float2(x, coefs > 1 ? fr[1] : 0.f);
          any_frame = true;
        }
      }
      srow[i] = v;
    }
    if (!__syncthreads_or(any_frame)) continue;  // all padding
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
      bool hit;
      if (coefs == 1) {
        hit = sweep<1>(srow, n, q0, q1, nouse2, live, tol, row, t0, n_coefs,
                       qb + f, f_len, coefs);
      } else if (coefs == 2) {
        hit = sweep<2>(srow, n, q0, q1, nouse2, live, tol, row, t0, n_coefs,
                       qb + f, f_len, coefs);
      } else {
        hit = sweep<3>(srow, n, q0, q1, nouse2, live, tol, row, t0, n_coefs,
                       qb + f, f_len, coefs);
      }
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == 0) hits[it] = done | m;
    }
  }
  __syncthreads();
  if (n_items <= 0) return;
  const int b_first = i0 / groups;
  const int b_last = (i0 + n_items - 1) / groups;
  for (int b = b_first + threadIdx.x; b <= b_last; b += blockDim.x) {
    const int lo = max(b * groups, i0) - i0;
    const int hi = min((b + 1) * groups, i0 + n_items) - i0;
    int c = 0;
    for (int it = lo; it < hi; ++it) c += __popc(hits[it]);
    if (c) atomicAdd(votes + (size_t)b * rows + a, c);
  }
}

// ---------------------------------------------------------------- K5 --- //
// One block per (query, stored row). Offsets o in [0, t_len + f_len - 1)
// are walked in time chunks of kOffChunk; each thread owns kK consecutive
// offsets (o = o0 + kK*tid + k) and sums their hits over the query frames
// in registers. For query frames [f0, f0 + fs) the chunk reads stored
// frames from o0 - (F-1) + f0 on: that window (the chunk plus an fs-frame
// halo) is staged in shared memory. Frame j of the stage needs window
// values kK*tid + k + j, k < kK: the thread keeps them in a ring of kK
// registers and loads ONE new value per coefficient and frame (kK odd, so
// the strided loads of a warp hit 32 different banks). A long query runs
// in several stages (offset sums add over f). Each thread keeps a running
// max over its offsets; one block max at the end. This chunk loop takes
// the place of the Pallas kernel's sliding accumulator window. kK = 9
// makes one chunk (1,152 offsets) cover a 1,024-frame tier and a 128-frame
// query bucket.
constexpr int kThreads5 = 128;
constexpr int kK = 9;
constexpr int kOffChunk = kThreads5 * kK;
constexpr int kStage5 = 128;
constexpr int kWin = kOffChunk + kStage5;

__global__ void __launch_bounds__(kThreads5)
    match_votes_aligned_kernel(const float* __restrict__ db,
                               const float* __restrict__ q, int batch,
                               int rows, int t_len, int n_coefs, int coefs,
                               int f_len, float tol, int* __restrict__ votes) {
  __shared__ float4 qs[kStage5];
  __shared__ float w0[kWin];
  __shared__ float w1[kWin];
  __shared__ int red[kThreads5 / 32];
  const int b = blockIdx.x % batch;
  const int a = blockIdx.x / batch;
  const bool two = coefs > 1;
  const float* qb = q + (size_t)b * (coefs + 2) * f_len;
  const float* row = db + (size_t)a * t_len * n_coefs;
  const int n_off = t_len + f_len - 1;
  const bool one_stage = f_len <= kStage5;
  const int base = threadIdx.x * kK;
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
                  ok = rest_close(row + (size_t)(tw0 + base + k + j) * n_coefs,
                                  qb, f0 + j, f_len, coefs, tol);
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
  for (int s = 16; s > 0; s >>= 1) {
    best = max(best, __shfl_xor_sync(kFull, best, s));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = red[0];
    for (int w = 1; w < kThreads5 / 32; ++w) m = max(m, red[w]);
    votes[(size_t)b * rows + a] = m;
  }
}

}  // namespace

extern "C" int tiresias_match_votes(const void* db, const void* q, int batch,
                                    int rows, int t_len, int n_coefs,
                                    int coefs, int f_len, float tol,
                                    void* votes, void* stream) {
  // votes must be zeroed: blocks add their partial counts
  const long long items = (long long)batch * ((f_len + 31) / 32);
  const dim3 grid(rows, (unsigned)((items + kMaxItems - 1) / kMaxItems));
  match_votes_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)db, (const float*)q, batch, rows, t_len, n_coefs, coefs,
      f_len, tol, (int*)votes);
  return (int)cudaGetLastError();
}

extern "C" int tiresias_match_votes_aligned(const void* db, const void* q,
                                            int batch, int rows, int t_len,
                                            int n_coefs, int coefs, int f_len,
                                            float tol, void* votes,
                                            void* stream) {
  const long long blocks = (long long)batch * rows;
  match_votes_aligned_kernel<<<(unsigned)blocks, kThreads5, 0,
                               (cudaStream_t)stream>>>(
      (const float*)db, (const float*)q, batch, rows, t_len, n_coefs, coefs,
      f_len, tol, (int*)votes);
  return (int)cudaGetLastError();
}
