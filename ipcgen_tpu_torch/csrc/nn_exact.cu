// Exact 1-NN of float32 points in 3-D for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this search to XLA
// (ipcgen_tpu/ops/knn.py nearest_neighbor_indices, :140-180).  It was added
// for the label grid's residue (ops/grid_nn.py LabelGrid.query): the hits
// whose nearest TLS point the two grid levels cannot prove, about 20 k rows a
// room against 1.3 M references in the BLK2GO sim batch and about 50 k with
// the dense 32-line profile.  The plain chunked loop (ops/knn.py
// nearest_neighbor_plain) wrote a (1024 x 5461) distance block to device
// memory for every step of a Python loop, some 36,000 launches a room, and
// took 1.2 s (BLK2GO) and 3.8 s (dense 32-line) a room on an H100, most of
// the card's busy time in the sim batch.
//
// What it computes: for every query q, the index of the reference r with the
// smallest d2 = (dx dx + dy dy) + dz dz, d = q - r, every difference, product
// and sum rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn; the source is
// also built with -fmad=false), so the float32 distances are the plain
// version's bit for bit; ties go to the smallest index, as argmin and
// ops/knn.py select_smallest resolve them.  No matmul and no norm expansion
// |q|^2 - 2 q.r + |r|^2, whose cancellation makes sub-millimetre near-ties
// resolve either way.  A query that no reference beats +inf for (non-finite
// distances only) keeps index 0, as in the plain version.
//
// What bounds it: operations, not bytes.  N x M pairs at 8 float32
// operations each (3 differences, 3 products, 2 sums), plus the compare and
// the two selects of the running minimum; the references are read once per
// query tile, from L2 after the first tile, and the queries once.
//
// Design
// ------
// Query tiles in registers.  A CUDA block of kThreads threads holds
// kQueryTile = kThreads x kQueriesPerThread queries, kQueriesPerThread in
// each thread's registers (queries tid, tid + 256, tid + 512, tid + 768 of
// the tile) with their running (best d2, index).
//
// References through shared memory.  The block streams its reference range
// in stages of kRefTile points, double-buffered with cp.async: the next stage
// is in flight while this one is searched.  A stage is the references' own
// (x, y, z) rows, 12 bytes a point, copied 16 bytes at a time (the last copy
// zero-filled past the end).  Every thread reads the same point at the same
// time, a broadcast: three LDS.128 serve four references to the thread's
// four queries, 16 pairs.
//
// Splits.  About 20 k queries make only 20 query tiles, so the reference
// range is also split over blockIdx.y in chunks of whole stages
// (ops/_kernels.py nn_exact_schedule), for about 16 blocks a streaming
// multiprocessor: 4 resident (256 threads, at most 64 registers each,
// 24 KB of shared memory) over 4 waves.
//
// Merge.  Inside a block each thread scans its range in ascending index
// order and replaces its best only on a strictly smaller d2, so it keeps the
// smallest index among equal distances.  The splits merge with a 64-bit
// atomicMin on the key (float bits of d2 << 32) | index: for d2 >= 0 the
// bits order as the values do, so the smaller distance wins and, among
// equal ones, the smaller index.  The wrapper fills the keys with
// (bits of +inf << 32) | 0 first and keeps the low 32 bits afterwards.
//
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueriesPerThread = 4;
constexpr int kQueryTile = kThreads * kQueriesPerThread;
constexpr int kRefTile = 1024;
constexpr int kStageFloats = 3 * kRefTile;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying references [start, start + count) into `dst`: their 3 count
// floats, 16 bytes a copy.  start % 4 == 0 keeps every copy 16-byte aligned
// (refs is); the copy that runs past the last float reads only what is left.
__device__ __forceinline__ void start_stage(float* dst, const float* refs, int start,
                                            int count) {
  const float* src = refs + 3 * (size_t)start;
  const int floats = 3 * count;
  for (int c = threadIdx.x; 4 * c < floats; c += kThreads) {
    const int left = floats - 4 * c;
    cp_async16(dst + 4 * c, src + 4 * c, left >= 4 ? 16 : 4 * left);
  }
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx, float ry,
                                       float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void take(float d, int j, float& best, int& arg) {
  if (d < best) {
    best = d;
    arg = j;
  }
}

// Grid (query tiles, splits); split y searches references
// [y * chunk, min((y + 1) * chunk, m)), chunk a multiple of kRefTile.
__global__ void __launch_bounds__(kThreads, 4)
nn_exact_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
                unsigned long long* __restrict__ keys, int n, int m, int chunk) {
  __shared__ __align__(16) float stage[2][kStageFloats];
  const int r_begin = blockIdx.y * chunk;
  const int r_end = (int)min((long long)m, (long long)r_begin + chunk);
  const int n_stages = (r_end - r_begin + kRefTile - 1) / kRefTile;
  start_stage(stage[0], refs, r_begin, min(kRefTile, r_end - r_begin));
  cp_async_commit();

  const float kInf = __int_as_float(0x7f800000);
  float qx[kQueriesPerThread], qy[kQueriesPerThread], qz[kQueriesPerThread];
  float best[kQueriesPerThread];
  int arg[kQueriesPerThread];
  const int q0 = blockIdx.x * kQueryTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int qi = q0 + k * kThreads;
    const bool in = qi < n;
    qx[k] = in ? queries[3 * (size_t)qi] : 0.0f;
    qy[k] = in ? queries[3 * (size_t)qi + 1] : 0.0f;
    qz[k] = in ? queries[3 * (size_t)qi + 2] : 0.0f;
    best[k] = kInf;
    arg[k] = 0;
  }

  for (int s = 0; s < n_stages; ++s) {
    const int start = r_begin + s * kRefTile;
    if (s + 1 < n_stages) {
      const int next = start + kRefTile;
      start_stage(stage[(s + 1) & 1], refs, next, min(kRefTile, r_end - next));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const float* sm = stage[s & 1];
    const float4* sm4 = reinterpret_cast<const float4*>(sm);
    const int count = min(kRefTile, r_end - start);
    const int quads = count >> 2;
#pragma unroll 2
    for (int g = 0; g < quads; ++g) {
      const float4 a = sm4[3 * g], b = sm4[3 * g + 1], c = sm4[3 * g + 2];
      const int j = start + 4 * g;
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        take(dist2(qx[k], qy[k], qz[k], a.x, a.y, a.z), j, best[k], arg[k]);
        take(dist2(qx[k], qy[k], qz[k], a.w, b.x, b.y), j + 1, best[k], arg[k]);
        take(dist2(qx[k], qy[k], qz[k], b.z, b.w, c.x), j + 2, best[k], arg[k]);
        take(dist2(qx[k], qy[k], qz[k], c.y, c.z, c.w), j + 3, best[k], arg[k]);
      }
    }
    for (int r = 4 * quads; r < count; ++r) {
      const float rx = sm[3 * r], ry = sm[3 * r + 1], rz = sm[3 * r + 2];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        take(dist2(qx[k], qy[k], qz[k], rx, ry, rz), start + r, best[k], arg[k]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it refills
  }

#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int qi = q0 + k * kThreads;
    if (qi < n && best[k] < kInf) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best[k])) << 32) |
          static_cast<unsigned>(arg[k]);
      atomicMin(keys + qi, key);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() right after the launch.
// queries (n, 3) and refs (m, 3) float32, refs 16-byte aligned; keys (n,)
// uint64 filled with (bits of +inf << 32) | 0; splits x chunk covers m with
// no empty split.
int nn_exact_launch(const void* queries, const void* refs, void* keys, int n, int m,
                    int chunk, int splits, void* stream) {
  if (n <= 0 || m <= 0 || chunk <= 0 || chunk % kRefTile != 0 || splits <= 0 ||
      splits > 65535 || (long long)chunk * (splits - 1) >= m ||
      (long long)chunk * splits < m || (uintptr_t)refs % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((n + kQueryTile - 1) / kQueryTile), (unsigned)splits);
  nn_exact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)queries, (const float*)refs, (unsigned long long*)keys, n, m, chunk);
  return (int)cudaGetLastError();
}

const char* nn_exact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
