// Lattice vote kernel K3' for Hopper (sm_90a): u8 tensor-core votes that
// read only the map columns a query batch can use.
//
// Replaces the fused XLA contraction of
// tiresias_tpu/ops/match_lattice.py::_hit_matmul (reached from lattice_votes):
//
//   votes[b, a] = sum_k counts[b, k] * (value_map[a, k] <= tol)
//
// with the query histogram counts [B, K] int32 and the per-audio lattice
// distance map value_map [A, K] float32 (+inf rows: padding, tombstones).
//
// What bounds it on the H100: reading value_map, A*K*4 bytes (26 MB at 10k
// tracks); the B*A*K products are nothing for the tensor cores. But a real
// query's histogram is sparse: a 3 s query puts its ~94 frames into a few of
// the 640 buckets. The design:
//  - lattice_planes_kernel splits counts into P u8 planes,
//    count = sum_p 256^p * plane_p (the wrapper picks P from a bound on the
//    counts), and flags every (64-query tile, 32-bucket step) that holds a
//    non-zero count;
//  - lattice_votes_kernel walks only the flagged steps of its query tile.
//    Zero counts add nothing, so an unflagged step's map columns are never
//    read and never multiplied; the decision stays on the device.
//  - A block owns 64 audio rows x 64 queries, a warp 16 rows. The block
//    stages its queries' counts planes for the flagged steps once, by
//    cp.async. Each warp reads its rows' map segment of a step (128 bytes a
//    row) with 16-byte loads straight into registers, kDepth steps ahead,
//    so the next step's loads are in flight while one multiplies.
//  - The warp compares the segment with tol into 0/1 u8 hits, packed
//    straight into the A fragment of mma.sync.m16n8k32.row.col.s32.u8.u8.s32
//    (audio rows on M, queries on N, a step's 32 buckets on K), and
//    multiplies them with each counts plane into int32 accumulators.
//  - Within a step the buckets are contracted in a permuted order (the sum
//    does not care): lane t of a quad takes the 8 contiguous buckets 8t..8t+7
//    as fragment columns 4t..4t+3 and 16+4t..16+4t+3, so a quad reads a row's
//    128-byte segment and a lane's B fragment is one 8-byte shared load.
// Measured on an H100 (PERF.md, K3' row): a 4-stage cp.async ring of 64 x 32
// map tiles behind a block barrier took 18.4 us on dense counts at B=1
// (about one memory round trip per step: ~5 warps per SM cannot hide the
// per-step address work and barrier); this register form takes 11.4 us.
// Exactness: a plane's partial sum is at most the bound P was chosen for
// (or 255 * K), so each accumulator is exact; the planes recombine with
// 32-bit wrapping shifts, exact wherever the int32 result is. NaN and +inf
// never satisfy <= tol.
//
// The vote step is templated on the map's element type (MapStep): besides
// float, bound_scan below reads uint8 maps of floor(d * 64) distances with
// it, a lane's 8 buckets of a row as one 8-byte load, turned into 0/1 hits
// with one __vcmpleu4 against floor(tol): for an integer m and tol >= 0,
// (float)m <= tol is m <= floor(tol), so the test is exact.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // audio rows per block: 16 per warp
constexpr int kQueries = 64;   // queries per block: 8 n-tiles of 8
constexpr int kStep = 32;      // buckets per step: the depth of m16n8k32
constexpr int kDepth = 2;      // steps in flight per warp
constexpr int kThreads = 128;  // 4 warps
constexpr int kPlanesThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// d += a (16x32 u8, row-major) * b (32x8 u8, column-major), int32
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block per (step, 64-query tile): 8 buckets of one query per thread.
// planes [P][B][steps*kStep] u8, zero past k_size; flags [tiles][steps].
__global__ void __launch_bounds__(kPlanesThreads)
    lattice_planes_kernel(const int* __restrict__ counts, int batch,
                          int k_size, int steps, int n_planes,
                          uint8_t* __restrict__ planes,
                          uint8_t* __restrict__ flags) {
  const int s = blockIdx.x, tile = blockIdx.y;
  const int n = tile * kQueries + threadIdx.x / 4;
  const int k0 = s * kStep + (threadIdx.x % 4) * 8;
  uint32_t c[8];
  bool any = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + j;
    c[j] = n < batch && k < k_size
               ? static_cast<uint32_t>(counts[(size_t)n * k_size + k])
               : 0u;
    any |= c[j] != 0;
  }
  if (n < batch) {
    for (int p = 0; p < n_planes; ++p) {
      uint2 w = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w.x |= ((c[j] >> (8 * p)) & 0xffu) << (8 * j);
        w.y |= ((c[j + 4] >> (8 * p)) & 0xffu) << (8 * j);
      }
      *reinterpret_cast<uint2*>(
          planes + ((size_t)p * batch + n) * steps * kStep + k0) = w;
    }
  }
  const int flagged = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[tile * steps + s] = flagged != 0;
}

// A lane's map values of one step: [0] row r buckets k+8t..+3, [1] row r+8
// the same, [2] row r buckets k+8t+4..+7, [3] row r+8 the same (pa and pb
// point at bucket 8t of rows r and r+8). Past the map's edge the counts
// planes are 0, so whatever hit a value there gives adds nothing. vec:
// rows are aligned for the vector load (float: k_size % 4 == 0; uint8:
// k_size % 8 == 0).
template <typename T>
struct MapStep;

template <>
struct MapStep<float> {
  using Reg = float4;
  static constexpr int kVec = 4;
  __device__ static __forceinline__ void load(Reg (&v)[4], const float* pa,
                                              const float* pb, bool oka,
                                              bool okb, int k, int kt,
                                              int k_size, bool vec) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float* src = ((h & 1) ? pb : pa) + k + 4 * (h >> 1);
      const bool ok = (h & 1) ? okb : oka;
      const int kk = kt + 4 * (h >> 1);
      v[h] = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      if (vec) {
        if (ok && kk < k_size)
          v[h] = __ldg(reinterpret_cast<const float4*>(src));
      } else if (ok) {
        if (kk < k_size) v[h].x = __ldg(src);
        if (kk + 1 < k_size) v[h].y = __ldg(src + 1);
        if (kk + 2 < k_size) v[h].z = __ldg(src + 2);
        if (kk + 3 < k_size) v[h].w = __ldg(src + 3);
      }
    }
  }
  // four hits as four bytes, element 0 in the low byte (mma's element order)
  __device__ static __forceinline__ uint32_t hits(Reg v, float tol, int) {
    return static_cast<uint32_t>(v.x <= tol) |
           static_cast<uint32_t>(v.y <= tol) << 8 |
           static_cast<uint32_t>(v.z <= tol) << 16 |
           static_cast<uint32_t>(v.w <= tol) << 24;
  }
};

template <>
struct MapStep<uint8_t> {
  using Reg = uint32_t;  // four map bytes, bucket order from the low byte
  static constexpr int kVec = 8;
  __device__ static __forceinline__ void load(Reg (&v)[4], const uint8_t* pa,
                                              const uint8_t* pb, bool oka,
                                              bool okb, int k, int kt,
                                              int k_size, bool vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* src = (h ? pb : pa) + k;
      const bool ok = h ? okb : oka;
      uint2 w = make_uint2(0xffffffffu, 0xffffffffu);
      if (vec) {
        if (ok && kt < k_size) w = __ldg(reinterpret_cast<const uint2*>(src));
      } else if (ok) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kt + j < k_size) {
            const uint32_t b = __ldg(src + j);
            uint32_t& dst = j < 4 ? w.x : w.y;
            dst = (dst & ~(0xffu << (8 * (j % 4)))) | (b << (8 * (j % 4)));
          }
        }
      }
      v[h] = w.x;      // buckets 8t..8t+3 of the row
      v[h + 2] = w.y;  // buckets 8t+4..8t+7
    }
  }
  // ti = floor(tol) clamped to [-1, 255] (-1: nothing passes)
  __device__ static __forceinline__ uint32_t hits(Reg v, float, int ti) {
    if (ti < 0) return 0u;
    return __vcmpleu4(v, static_cast<uint32_t>(ti) * 0x01010101u) &
           0x01010101u;
  }
};

// Dynamic shared memory: the flagged steps' indices (steps ints, padded to
// 16 bytes), then their counts [flagged][P][64 queries][32] u8.
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
    lattice_votes_kernel(const T* __restrict__ value_map,
                         const uint8_t* __restrict__ planes,
                         const uint8_t* __restrict__ flags, int batch,
                         int rows, int k_size, int steps, float tol,
                         int* __restrict__ votes) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* list = reinterpret_cast<int*>(smem);
  uint8_t* cs = smem + ((steps * 4 + 15) & ~15);
  __shared__ int n_list;
  const int a0 = blockIdx.x * kRows, tile = blockIdx.y;
  const int b0 = tile * kQueries, nb = min(kQueries, batch - b0);
  const int nt = (nb + 7) / 8;  // n-tiles holding queries
  const int kp = steps * kStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = warp * 16 + g;  // this lane's rows r and r + 8
  const bool vec = k_size % MapStep<T>::kVec == 0;
  const bool oka = a0 + r < rows, okb = a0 + r + 8 < rows;
  const T* pa = value_map + (size_t)(oka ? a0 + r : 0) * k_size + 8 * t;
  const T* pb = value_map + (size_t)(okb ? a0 + r + 8 : 0) * k_size + 8 * t;
  const int ti = !(tol >= 0.f) ? -1 : tol >= 255.f ? 255 : (int)floorf(tol);

  // the tile's flagged steps, in order
  if (warp == 0) {
    int n = 0;
    for (int s0 = 0; s0 < steps; s0 += 32) {
      const int s = s0 + lane;
      const bool f = s < steps && flags[tile * steps + s];
      const uint32_t m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1))] = s;
      n += __popc(m);
    }
    if (lane == 0) n_list = n;
  }
  __syncthreads();
  const int n_steps = n_list;
  // the counts of those steps, once (only this tile's nb queries: the
  // columns of queries past nb are never stored)
  const int per_step = P * nb * 2;  // 16-byte chunks
  for (int q = threadIdx.x; q < n_steps * per_step; q += kThreads) {
    const int i = q / per_step, rem = q % per_step;
    const int p = rem / (nb * 2), n = (rem / 2) % nb, c = rem % 2;
    cp_async16(cs + ((i * P + p) * kQueries + n) * kStep + 16 * c,
               planes + ((size_t)p * batch + b0 + n) * kp + list[i] * kStep +
                   16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  typename MapStep<T>::Reg buf[kDepth][4];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < n_steps) {
      const int k = list[d] * kStep;
      MapStep<T>::load(buf[d], pa, pb, oka, okb, k, k + 8 * t, k_size, vec);
    }
  int acc[P][8][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int i0 = 0; i0 < n_steps; i0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int i = i0 + d;
      if (i < n_steps) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          a[h] = MapStep<T>::hits(buf[d][h], tol, ti);
        }
        if (i + kDepth < n_steps) {
          const int k = list[i + kDepth] * kStep;
          MapStep<T>::load(buf[d], pa, pb, oka, okb, k, k + 8 * t, k_size,
                           vec);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n < nt) {
              const uint2 b = *reinterpret_cast<const uint2*>(
                  cs + ((i * P + p) * kQueries + 8 * n + g) * kStep + 8 * t);
              mma_u8(acc[p][n], a, b.x, b.y);
            }
          }
        }
      }
    }
  }

  // acc[p][n]: rows r (e = 0, 1) and r + 8 (e = 2, 3), queries 8n + 2t + e%2
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v = 0;
#pragma unroll
      for (int p = 0; p < P; ++p)
        v += static_cast<uint32_t>(acc[p][n][e]) << (8 * p);
      const int q = b0 + 8 * n + 2 * t + (e & 1);
      const int a = a0 + r + 8 * (e >> 1);
      if (q < batch && a < rows)
        votes[(size_t)q * rows + a] = static_cast<int>(v);
    }
  }
}

template <int P, typename T>
int launch_votes(const T* value_map, const uint8_t* planes,
                 const uint8_t* flags, int batch, int rows, int k_size,
                 int steps, float tol, int* votes, cudaStream_t stream) {
  const size_t bytes = (size_t)((steps * 4 + 15) & ~15) +
                       (size_t)steps * P * kQueries * kStep;
  if (bytes > 48 * 1024) {  // past the default dynamic limit
    const cudaError_t rc = cudaFuncSetAttribute(
        lattice_votes_kernel<P, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((rows + kRows - 1) / kRows,
                  (batch + kQueries - 1) / kQueries);
  lattice_votes_kernel<P, T><<<grid, kThreads, bytes, stream>>>(
      value_map, planes, flags, batch, rows, k_size, steps, tol, votes);
  return (int)cudaGetLastError();
}

template <typename T>
int lattice_votes(const void* counts, const void* value_map, int batch,
                  int rows, int k_size, float tol, int n_planes,
                  void* scratch, void* votes, void* stream) {
  if (n_planes < 1 || n_planes > 4 || batch < 1 || rows < 1 || k_size < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int steps = (k_size + kStep - 1) / kStep;
  const int tiles = (batch + kQueries - 1) / kQueries;
  uint8_t* planes = static_cast<uint8_t*>(scratch);
  uint8_t* flags = planes + (size_t)n_planes * batch * steps * kStep;
  lattice_planes_kernel<<<dim3(steps, tiles), kPlanesThreads, 0, s>>>(
      (const int*)counts, batch, k_size, steps, n_planes, planes, flags);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const T* m = (const T*)value_map;
  int* out = (int*)votes;
  switch (n_planes) {
    case 1:
      return launch_votes<1>(m, planes, flags, batch, rows, k_size, steps,
                             tol, out, s);
    case 2:
      return launch_votes<2>(m, planes, flags, batch, rows, k_size, steps,
                             tol, out, s);
    case 3:
      return launch_votes<3>(m, planes, flags, batch, rows, k_size, steps,
                             tol, out, s);
    default:
      return launch_votes<4>(m, planes, flags, batch, rows, k_size, steps,
                             tol, out, s);
  }
}

// ---- bound_scan: the certified prefilters' whole bound stage ------------ //
//
// Replaces the bound stages of tiresias_tpu/ops/match_lattice.py: bound_votes
// (:304, the strict/aligned prefilter: per bound coefficient c the query's
// clip(q[..., c], lo, hi) * s histogram, the XLA-fused _hit_matmul against
// that coefficient's uint8 map, coefficient 1's credit of the frames that
// bypass its test, the min) and _prefilter_core's (:583-591, the dialplan
// prefilter: the histogram of trunc(q0) in the band, _hit_matmul against
// the uint8 map), each followed by the context mask (bound -1 where
// ctx_ids != ctx_id). From the raw query values to the final [B, A] int32
// bound in two launches, whatever the number of maps (one or two):
//  - bound_scan_planes_kernel, one block per (query, map): buckets each
//    frame as frame_buckets does (clip keeping NaN, scale, truncf, the
//    lattice range and the band, all in float32, masked before any integer
//    cast), counts in shared memory, writes the u8 count planes, one flag
//    per (map, 32-bucket step) with a count, the bypass credit, and (for
//    the dialplan rescore) the int32 histogram of the first map;
//  - bound_scan_kernel: a block stages its query tile's planes of every
//    flagged (map, step) once, then each warp walks those steps for 16-row
//    tiles with K3''s u8 mma.sync and __vcmpleu4 hits, one accumulator set
//    per map, and its epilogue writes min over the maps (plus the credit)
//    or -1 outside the context.
// What bounds it on the H100: the flagged steps' map bytes (2 x 10,112 x 768
// at most on the strict path, L2-resident when warm) and the votes written
// once; below a few steps, the launch and the block's setup (the flags, the
// staging of its planes: two dependent trips to L2). The design, chosen by
// measuring variants in turns on the card (PERF.md):
//  - the planes are step-major ([map][plane][step][query][32]), so a query
//    tile's planes of a step are one contiguous run to stage; staging them
//    from query-major planes (64 queries' 32-byte pieces of a step)
//    was the largest single part of a block's time on dense counts;
//  - a warp owns 16-row tiles (the mma's M) and takes them in turn, as many
//    warps a block as the rows need for one block an SM (three an SM with
//    8-query tiles up to 8 queries, whose few accumulators leave the room);
//  - its lanes load their 8 bytes of rows r and r + 8 a step straight into
//    a register ring, 4 steps ahead at one plane (2 past), across its row
//    tiles: a ring slot whose last step of a tile is consumed takes the same
//    step of the warp's next tile, so with a real query's one or two flagged
//    steps the next tiles' rows are in flight while one tile finishes (a
//    slot's index stays static: no dynamic register index). Rings of 8 and
//    16 steps measured no faster, nor did a per-warp ring of TMA boxes (32
//    bytes x 16 rows into shared memory on mbarriers), nor whole 128-byte
//    lines a lane quad.
constexpr int kMaxMaps = 2;
constexpr int kScanPlanesThreads = 256;
constexpr int kScanWarps = 8;  // most warps per vote block

// One uint8 map of a scan and how the query's values are bucketed onto it.
struct ScanMap {
  const uint8_t* map;  // [rows][k_size]
  int coef;            // the query column bucketed onto this map
  int k_min, k_size;
  int bypass;  // count active & use2 only; credit active & ~use2
  int ti;      // floor(threshold) clamped to [-1, 255] (-1: nothing passes)
  int vec;     // rows aligned for 8-byte loads
  float lo, hi, scale;  // clip(x, lo, hi) * scale (NaN stays NaN)
  float band_lo, band_hi;
};

// Passed by value as a __grid_constant__ kernel parameter: indexed in
// place, never copied to local memory.
struct ScanSpecs {
  ScanMap m[kMaxMaps];
};

// Scratch layout (bytes): planes [n_maps][P][s_max][bpad][32] u8, flags
// [n_maps * s_max][bpad] u8 (bpad: batch rounded up to 64, so a query
// tile's run of a step is 16-byte aligned), then the credit [n_maps][batch]
// int32 at a 16-byte boundary.
struct ScanScratch {
  size_t flags, credit, total;
  int bpad;
};

__host__ __device__ inline ScanScratch scan_scratch(int n_maps, int s_max,
                                                    int batch, int n_planes) {
  ScanScratch s;
  s.bpad = (batch + 63) & ~63;
  s.flags = (size_t)n_maps * n_planes * s_max * s.bpad * kStep;
  s.credit = (s.flags + (size_t)n_maps * s_max * s.bpad + 15) & ~(size_t)15;
  s.total = s.credit + (size_t)n_maps * batch * 4;
  return s;
}

constexpr int kFrameUnroll = 4;  // frames a thread loads before counting

// One block per (query, map). hist: s_max * 32 ints of dynamic shared memory.
__global__ void __launch_bounds__(kScanPlanesThreads)
    bound_scan_planes_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ active,
                             const uint8_t* __restrict__ use2, int batch,
                             int frames, int n_coefs,
                             const __grid_constant__ ScanSpecs specs,
                             int s_max, int n_planes,
                             uint8_t* __restrict__ scratch,
                             int* __restrict__ counts) {
  extern __shared__ int hist[];
  __shared__ int n_bypass;
  const int b = blockIdx.x, mi = blockIdx.y;
  const ScanMap& sp = specs.m[mi];
  const int kp = s_max * kStep;
  for (int j = threadIdx.x; j < kp; j += blockDim.x) hist[j] = 0;
  if (threadIdx.x == 0) n_bypass = 0;
  __syncthreads();
  const float k_lo = (float)sp.k_min, k_hi = (float)(sp.k_min + sp.k_size);
  int bypassed = 0;
  for (int f0 = threadIdx.x; f0 < frames;
       f0 += kFrameUnroll * blockDim.x) {
    // the loads of kFrameUnroll frames first, then their counts
    float x[kFrameUnroll];
    bool act[kFrameUnroll];
#pragma unroll
    for (int j = 0; j < kFrameUnroll; ++j) {
      const int f = f0 + j * blockDim.x;
      act[j] = false;
      x[j] = 0.f;
      if (f < frames) {
        const size_t i = (size_t)b * frames + f;
        act[j] = active[i] != 0;
        if (sp.bypass) {
          const bool u = use2[i] != 0;
          bypassed += act[j] && !u;
          act[j] = act[j] && u;
        }
        x[j] = q[i * n_coefs + sp.coef];
      }
    }
#pragma unroll
    for (int j = 0; j < kFrameUnroll; ++j) {
      float v = x[j];
      // torch.clamp keeps NaN; fminf/fmaxf alone would put it on a bound
      if (v == v) v = fminf(fmaxf(v, sp.lo), sp.hi);
      const float kq = truncf(v * sp.scale);  // NaN fails every test below
      if (act[j] && kq >= k_lo && kq < k_hi && kq >= sp.band_lo &&
          kq <= sp.band_hi)
        atomicAdd(&hist[(int)kq - sp.k_min], 1);
    }
  }
  if (bypassed) atomicAdd(&n_bypass, bypassed);
  __syncthreads();
  const ScanScratch lay = scan_scratch(gridDim.y, s_max, batch, n_planes);
  for (int j8 = threadIdx.x; j8 < kp / 8; j8 += blockDim.x) {
    uint32_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = static_cast<uint32_t>(hist[8 * j8 + j]);
    const int s = j8 / 4;  // step-major: [map][plane][step][query][32]
    for (int p = 0; p < n_planes; ++p) {
      uint2 w = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w.x |= ((c[j] >> (8 * p)) & 0xffu) << (8 * j);
        w.y |= ((c[j + 4] >> (8 * p)) & 0xffu) << (8 * j);
      }
      *reinterpret_cast<uint2*>(
          scratch +
          ((((size_t)mi * n_planes + p) * s_max + s) * lay.bpad + b) * kStep +
          8 * (j8 % 4)) = w;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = warp; s < s_max; s += blockDim.x / 32) {
    const bool any = __any_sync(0xffffffffu, hist[s * kStep + lane] != 0);
    if (lane == 0)
      scratch[lay.flags + ((size_t)mi * s_max + s) * lay.bpad + b] = any;
  }
  if (counts != nullptr && mi == 0)
    for (int j = threadIdx.x; j < sp.k_size; j += blockDim.x)
      counts[(size_t)b * sp.k_size + j] = hist[j];
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(scratch + lay.credit)[mi * batch + b] = n_bypass;
}

// Dynamic shared memory: the staged planes [M * s_max][P][QT][32] u8 (only
// the flagged pairs' slots are filled), then the pair flags and the flagged
// list (M * s_max ints each) and the credit [M][QT].
template <int M, int P, int QT>
__global__ void __launch_bounds__(kScanWarps * 32, QT == 8 ? 3 : 1)
    bound_scan_kernel(const __grid_constant__ ScanSpecs specs,
                      const uint8_t* __restrict__ scratch,
                      int batch, int rows, int s_max,
                      const int* __restrict__ ctx_ids, int ctx_id,
                      int* __restrict__ votes) {
  constexpr int NT = QT / 8;         // n-tiles of 8 queries
  constexpr int D = P == 1 ? 4 : 2;  // steps in flight per warp
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_list;
  const int n_warps = blockDim.x / 32;
  const int pairs = M * s_max;
  uint8_t* cs = smem;
  int* fl = reinterpret_cast<int*>(cs + (size_t)pairs * P * QT * kStep);
  int* list = fl + pairs;
  int* cred = list + pairs;
  const ScanScratch lay = scan_scratch(M, s_max, batch, P);
  const uint8_t* flags = scratch + lay.flags;
  const int* credit = reinterpret_cast<const int*>(scratch + lay.credit);
  const int b0 = blockIdx.y * QT, nb = min(QT, batch - b0);
  const int nt = (nb + 7) / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  for (int e = threadIdx.x; e < pairs; e += blockDim.x) fl[e] = 0;
  for (int e = threadIdx.x; e < M * QT; e += blockDim.x)
    cred[e] = e % QT < nb ? credit[(e / QT) * batch + b0 + e % QT] : 0;
  __syncthreads();
  // a (map, step) pair is walked when any query of the tile counts there:
  // its tile's flags are nb contiguous bytes, read 16 (8-query tiles: 8) at
  // a time
  constexpr int kChunk = QT < 16 ? 8 : 16, kChunks = QT / kChunk;
  for (int e = threadIdx.x; e < pairs * kChunks; e += blockDim.x) {
    const int pr = e / kChunks, c = e % kChunks, valid = nb - kChunk * c;
    if (valid <= 0) continue;
    const uint8_t* src = flags + (size_t)pr * lay.bpad + b0 + kChunk * c;
    uint32_t wv[4] = {0u, 0u, 0u, 0u};
    if (kChunk == 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(src);
      wv[0] = w.x, wv[1] = w.y, wv[2] = w.z, wv[3] = w.w;
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(src);
      wv[0] = w.x, wv[1] = w.y;
    }
    uint32_t any = 0;
#pragma unroll
    for (int h = 0; h < kChunk / 4; ++h) {
      const int n = min(4, max(0, valid - 4 * h));  // bytes of queries < nb
      any |= wv[h] & (n == 4 ? 0xffffffffu : (1u << (8 * n)) - 1u);
    }
    if (any) fl[pr] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int e0 = 0; e0 < pairs; e0 += 32) {
      const int e = e0 + lane;
      const bool f = e < pairs && fl[e];
      const uint32_t m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1))] = e;
      n += __popc(m);
    }
    if (lane == 0) n_list = n;
  }
  __syncthreads();
  const int n_steps = n_list;
  // the tile's planes of those steps, once for every row tile of the block:
  // a (step, plane)'s nb queries are nb * 32 contiguous bytes
  for (int ip = warp; ip < n_steps * P; ip += n_warps) {
    const int i = ip / P, p = ip % P;
    const int e = list[i];
    const uint8_t* src =
        scratch + ((((size_t)(M == 1 || e < s_max ? 0 : 1) * P + p) * s_max +
                    (M == 1 || e < s_max ? e : e - s_max)) *
                       lay.bpad +
                   b0) *
                      kStep;
    uint8_t* dst = cs + (i * P + p) * QT * kStep;
    for (int c = lane; c < nb * 2; c += 32)
      cp_async16(dst + 16 * c, src + 16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int n_tiles = (rows + 15) / 16;
  const int stride = gridDim.x * n_warps;
  const int tile0 = blockIdx.x * n_warps + warp;
  // the maps' hot fields in registers (M is 1 or 2: a map is picked by a
  // select, never by a dynamic index)
  const uint8_t* base[M];
  int ks[M], ti[M];
  bool vec[M];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    base[mi] = specs.m[mi].map + 8 * t;
    ks[mi] = specs.m[mi].k_size;
    ti[mi] = specs.m[mi].ti;
    vec[mi] = specs.m[mi].vec != 0;
  }
  // step i of tile tl into ring slot d: the lane's 8 bytes of rows r and
  // r + 8
  typename MapStep<uint8_t>::Reg buf[D][4];
  auto fetch = [&](int d, int tl, int i) {
    const int e = list[i];
    const bool m0 = M == 1 || e < s_max;
    const int k = (m0 ? e : e - s_max) * kStep;
    const int r = tl * 16 + g, kk = m0 ? ks[0] : ks[M - 1];
    const bool oka = r < rows, okb = r + 8 < rows;
    const uint8_t* bp = m0 ? base[0] : base[M - 1];
    MapStep<uint8_t>::load(buf[d], bp + (size_t)(oka ? r : 0) * kk,
                           bp + (size_t)(okb ? r + 8 : 0) * kk, oka, okb, k,
                           k + 8 * t, kk, m0 ? vec[0] : vec[M - 1]);
  };
  if (tile0 < n_tiles) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < n_steps) fetch(d, tile0, d);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // acc[m][p][n]: rows r (e = 0, 1) and r + 8 (e = 2, 3), queries
  // b0 + 8n + 2t + e%2
  int acc[M][P][NT][4];
  for (int tl = tile0; tl < n_tiles; tl += stride) {
#pragma unroll
    for (int mi = 0; mi < M; ++mi)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][p][n][e] = 0;
    const bool more = tl + stride < n_tiles;
    // slot d holds steps d, d + D, ... of the tile; once a slot's last step
    // of this tile is consumed it takes step d of the next tile
    for (int i0 = 0; i0 < n_steps; i0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = i0 + d;
        if (i < n_steps) {
          const int mi = M == 1 || list[i] < s_max ? 0 : 1;
          const int thr = mi == 0 ? ti[0] : ti[M - 1];
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 4; ++h)
            a[h] = MapStep<uint8_t>::hits(buf[d][h], 0.f, thr);
          if (i + D < n_steps)
            fetch(d, tl, i + D);
          else if (more)
            fetch(d, tl + stride, d);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if (m != mi) continue;  // warp-uniform: one accumulator set a map
#pragma unroll
            for (int p = 0; p < P; ++p) {
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                if (n < nt) {
                  const uint2 bf = *reinterpret_cast<const uint2*>(
                      cs + ((i * P + p) * QT + 8 * n + g) * kStep + 8 * t);
                  mma_u8(acc[m][p][n], a, bf.x, bf.y);
                }
              }
            }
          }
        }
      }
    }
    const int r = tl * 16 + g;
    const bool oka = r < rows, okb = r + 8 < rows;
    const bool keep_a = ctx_ids == nullptr || (oka && ctx_ids[r] == ctx_id);
    const bool keep_b =
        ctx_ids == nullptr || (okb && ctx_ids[r + 8] == ctx_id);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qn = 8 * n + 2 * t + (e & 1);
        int best = INT_MAX;
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          uint32_t v = 0;
#pragma unroll
          for (int p = 0; p < P; ++p)
            v += static_cast<uint32_t>(acc[mi][p][n][e]) << (8 * p);
          best = min(best, static_cast<int>(v) + cred[mi * QT + qn]);
        }
        const int a = r + 8 * (e >> 1);
        if (b0 + qn < batch && a < rows)
          votes[(size_t)(b0 + qn) * rows + a] =
              (e >> 1 ? keep_b : keep_a) ? best : -1;
      }
    }
  }
}

int g_sms = 0;  // the card's SM count, read once

template <int M, int P, int QT>
int launch_scan(const ScanSpecs& specs, const uint8_t* scratch, int batch,
                int rows, int s_max, const int* ctx_ids, int ctx_id,
                int* votes, cudaStream_t stream) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms <= 0) g_sms = 1;
  }
  // warps enough for one block per SM to hold every 16-row tile once; past
  // kScanWarps warps a block, as many blocks as fit on the SMs at once,
  // whose warps take several tiles in turn
  const int n_tiles = (rows + 15) / 16;
  const int warps = min(kScanWarps, max(1, (n_tiles + g_sms - 1) / g_sms));
  const int pairs = M * s_max;
  const size_t bytes = (size_t)pairs * P * QT * kStep +
                       (size_t)(2 * pairs + M * QT) * 4;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        bound_scan_kernel<M, P, QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bound_scan_kernel<M, P, QT>, warps * 32, bytes);
  const int blocks =
      min(g_sms * max(1, per_sm), (n_tiles + warps - 1) / warps);
  const dim3 grid(blocks, (batch + QT - 1) / QT);
  bound_scan_kernel<M, P, QT><<<grid, warps * 32, bytes, stream>>>(
      specs, scratch, batch, rows, s_max, ctx_ids, ctx_id, votes);
  return (int)cudaGetLastError();
}

template <int M>
int launch_scan_p(const ScanSpecs& specs, const uint8_t* scratch, int batch,
                  int rows, int s_max, int n_planes, const int* ctx_ids,
                  int ctx_id, int* votes, cudaStream_t s) {
  // up to 8 queries: 8-query tiles, whose few accumulators leave room for
  // three blocks an SM; past two planes a 64-query tile's staged planes
  // outgrow shared memory
  if (batch <= 8 && n_planes <= 2)
    return n_planes == 1
               ? launch_scan<M, 1, 8>(specs, scratch, batch, rows, s_max,
                                           ctx_ids, ctx_id, votes, s)
               : launch_scan<M, 2, 8>(specs, scratch, batch, rows, s_max,
                                           ctx_ids, ctx_id, votes, s);
  switch (n_planes) {
    case 1:
      return launch_scan<M, 1, 64>(specs, scratch, batch, rows, s_max,
                                        ctx_ids, ctx_id, votes, s);
    case 2:
      return launch_scan<M, 2, 64>(specs, scratch, batch, rows, s_max,
                                        ctx_ids, ctx_id, votes, s);
    case 3:
      return launch_scan<M, 3, 32>(specs, scratch, batch, rows, s_max,
                                        ctx_ids, ctx_id, votes, s);
    default:
      return launch_scan<M, 4, 32>(specs, scratch, batch, rows, s_max,
                                        ctx_ids, ctx_id, votes, s);
  }
}

// Host arrays: ints [n_maps][4] = coef, k_min, k_size, bypass; floats
// [n_maps][6] = lo, hi, scale, band_lo, band_hi, threshold; maps [n_maps]
// device pointers (null for the planes launch). s_max: the most steps of
// any map.
int scan_specs(int n_maps, const int* ints, const float* floats,
               const void* const* maps, ScanSpecs* specs, int* s_max) {
  if (n_maps < 1 || n_maps > kMaxMaps) return (int)cudaErrorInvalidValue;
  *specs = ScanSpecs{};
  *s_max = 0;
  for (int i = 0; i < n_maps; ++i) {
    ScanMap& m = specs->m[i];
    m.map = maps == nullptr ? nullptr : (const uint8_t*)maps[i];
    m.coef = ints[4 * i];
    m.k_min = ints[4 * i + 1];
    m.k_size = ints[4 * i + 2];
    m.bypass = ints[4 * i + 3];
    m.lo = floats[6 * i];
    m.hi = floats[6 * i + 1];
    m.scale = floats[6 * i + 2];
    m.band_lo = floats[6 * i + 3];
    m.band_hi = floats[6 * i + 4];
    const float thr = floats[6 * i + 5];
    m.ti = !(thr >= 0.f) ? -1 : thr >= 255.f ? 255 : (int)floorf(thr);
    m.vec = m.k_size % 8 == 0 && (uintptr_t)m.map % 8 == 0;
    if (m.k_size < 1 || m.coef < 0) return (int)cudaErrorInvalidValue;
    *s_max = max(*s_max, (m.k_size + kStep - 1) / kStep);
  }
  return 0;
}

}  // namespace

// Bytes of scratch bound_scan needs (allocated by the wrapper,
// ops/match_lattice.py::bound_scan).
extern "C" int tiresias_bound_scan_scratch(int n_maps, int max_k, int batch,
                                           int n_planes) {
  return (int)scan_scratch(n_maps, (max_k + kStep - 1) / kStep, batch,
                           n_planes)
      .total;
}

// q [batch][frames][n_coefs] float32, active and use2 [batch][frames] bool
// (use2 read only for bypass maps); counts: null, or [batch][k_size of map 0]
// int32 for the histogram.
extern "C" int tiresias_bound_scan_planes(const void* q, const void* active,
                                          const void* use2, int batch,
                                          int frames, int n_coefs, int n_maps,
                                          const int* ints,
                                          const float* floats, int n_planes,
                                          void* scratch, void* counts,
                                          void* stream) {
  ScanSpecs specs;
  int s_max = 0;
  int rc = scan_specs(n_maps, ints, floats, nullptr, &specs, &s_max);
  if (rc != 0) return rc;
  if (batch < 1 || frames < 0 || n_coefs < 1 || n_planes < 1 ||
      n_planes > 4 || s_max * kStep * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_maps; ++i)
    if (specs.m[i].coef >= n_coefs) return (int)cudaErrorInvalidValue;
  bound_scan_planes_kernel<<<dim3(batch, n_maps), kScanPlanesThreads,
                             s_max * kStep * 4, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)active, (const uint8_t*)use2, batch,
      frames, n_coefs, specs, s_max, n_planes, (uint8_t*)scratch,
      (int*)counts);
  return (int)cudaGetLastError();
}

// maps: n_maps device pointers to [rows][k_size] uint8; ctx_ids: null, or
// [rows] int32 (votes -1 where ctx_ids != ctx_id); votes [batch][rows] int32.
extern "C" int tiresias_bound_scan(const void* const* maps, int n_maps,
                                   const int* ints, const float* floats,
                                   int batch, int rows, int n_planes,
                                   const void* scratch, const void* ctx_ids,
                                   int ctx_id, void* votes, void* stream) {
  ScanSpecs specs;
  int s_max = 0;
  int rc = scan_specs(n_maps, ints, floats, maps, &specs, &s_max);
  if (rc != 0) return rc;
  if (batch < 1 || rows < 1 || n_planes < 1 || n_planes > 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sc = (const uint8_t*)scratch;
  const int* ids = (const int*)ctx_ids;
  int* out = (int*)votes;
  if (n_maps == 1)
    return launch_scan_p<1>(specs, sc, batch, rows, s_max, n_planes, ids,
                            ctx_id, out, s);
  return launch_scan_p<2>(specs, sc, batch, rows, s_max, n_planes, ids,
                          ctx_id, out, s);
}

// scratch: the u8 planes [n_planes][batch][steps * 32], then the flags
// [tiles][steps] (steps = ceil(k_size / 32), tiles = ceil(batch / 64)),
// allocated by the wrapper (ops/match_lattice.py::hit_votes).
extern "C" int tiresias_lattice_votes(const void* counts,
                                      const void* value_map, int batch,
                                      int rows, int k_size, float tol,
                                      int n_planes, void* scratch,
                                      void* votes, void* stream) {
  return lattice_votes<float>(counts, value_map, batch, rows, k_size, tol,
                              n_planes, scratch, votes, stream);
}
