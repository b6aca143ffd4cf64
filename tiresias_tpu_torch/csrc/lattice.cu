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
// The same kernel, templated on the map's element type, runs the certified
// prefilters' bound scans (tiresias_tpu/ops/match_lattice.py:588, the
// dialplan bound _hit_matmul(c, vm_q, tol * BOUND_Q), and :304 bound_votes
// over the per-coefficient maps) on uint8 maps of floor(d * 64) distances:
// a lane reads its 8 buckets of a row as one 8-byte load (a quarter of the
// float32 bytes, the bound scan's whole cost) and turns them into 0/1 hits
// with one __vcmpleu4 against floor(tol): for an integer m and tol >= 0,
// (float)m <= tol is m <= floor(tol), so the test is exact.
#include <cuda_runtime.h>
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

}  // namespace

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

// The same over a uint8 map (the prefilters' bound scans).
extern "C" int tiresias_lattice_votes_u8(const void* counts,
                                         const void* value_map, int batch,
                                         int rows, int k_size, float tol,
                                         int n_planes, void* scratch,
                                         void* votes, void* stream) {
  return lattice_votes<uint8_t>(counts, value_map, batch, rows, k_size, tol,
                                n_planes, scratch, votes, stream);
}
