// Candidate-pair ray/triangle intersection for Hopper (sm_90a): the exact
// pair prepass and the pair walk.
//
// pairs_prepass_kernel replaces the candidate prepass of
// ipcgen_tpu/ops/raycast_mxu.py, candidate_blocks (:297-401).  That is XLA
// code, not a Pallas kernel; its plain PyTorch version here is
// subtile_pairs(candidate_blocks(...)) with no cap on groups or blocks
// (exact_prepass_plain in ipcgen_tpu_torch/ops/raycast_pairs.py).
//
// raycast_pairs_kernel replaces the two Pallas TPU kernels of raycast_mxu.py:
//   _flat_kernel  (:619-732) - one grid step per (ray tile, candidate block)
//                              pair, the 5 Pluecker products as an MXU matmul;
//   _pairs_kernel (:470-592) - the exact fallback that walked every block for
//                              a tile whose capped candidate list overflowed.
// On the card nothing caps the lists, so every subtile walks its exact list
// and the fallback's work is ordinary pairs.  Its plain PyTorch version is
// raycast_pairs_plain in ops/raycast_pairs.py.
//
// The prepass
// -----------
// One CUDA block of kPreThreads = 256 threads per tile of n_sub subtiles of
// 256 rays; thread t holds ray t of every subtile (n_sub rays).  Leaf blocks
// are taken kChunkBlocks at a time.  Stage 1 slab-tests every ray against the
// chunk's block groups (AABB unions of `group` consecutive blocks) and marks a
// group in a shared bit set when any ray of the tile enters it (__any_sync,
// then one shared atomicOr per warp).  Stage 2 slab-tests the rays against the
// blocks of the marked groups only, OR-reduces each thread's n_sub subtile
// bits over the warp (__reduce_or_sync) and merges them into a shared byte per
// block.  Then the chunk's blocks are compacted in ascending order: warp
// ballots give each block's rank in each subtile's list.  The kernel runs
// twice: the count pass writes each subtile's list length, the tile's group
// count, the size of its block union and its stage-1 group bits (one bit per
// tile and group, in device memory); the caller turns the lengths into CSR
// offsets (torch.cumsum, one host read of the total); the fill pass reads the
// group bits, repeats stage 2 and writes each list at its offset.
// The slab test is candidate_blocks' _tile_slab_or: d_safe = +-1e-12 for
// |d| < 1e-12, inv = 1 / d_safe, (lo - o) * inv rounded once each, entry and
// exit clamped to -+3e38, hit when exit >= max(entry, 0) and entry < t_max.
// torch.minimum / maximum propagate NaN, so a NaN-padded box fails there;
// fminf / fmaxf would drop the NaN, so a NaN slab distance fails here
// explicitly (as slab_hit in raycast_culled.cu).
// What bounds it on the card: about 33 fp32 operations per slab test (6
// differences, 6 products, 6 NaN checks, 13 min / max, 2 compares), ray-tile
// x group tests in stage 1 and ray x block tests of the hit groups in stage 2;
// device memory moves only the rays, the boxes and the lists.  It is bound by
// fp32 instruction throughput, and by the second pass, which repeats stage 2
// to place the lists without a per-tile buffer of NB entries.
//
// The pair walk
// -------------
// The pair list is CSR: subtile s walks blocks[offsets[s] .. offsets[s+1]),
// ascending, and pairs are numbered in subtile order.  A CUDA block of
// kWalkThreads = 64 threads takes kChunk consecutive pairs; each thread holds
// kRays = 4 rays of the current subtile (rays t, t + 64, t + 128, t + 192), so
// every coefficient read from shared memory (a warp-wide broadcast) feeds four
// rays.  The 25 non-zero coefficient rows of each block's panel (12.8 KB at
// TB = 128) are double-buffered with cp.async: the next pair's panel is in
// flight while the current one is walked.  When the subtile changes, the block
// hands its running minimum on with a per-ray 64-bit atomicMin on
// (t bits << 32) | slot, which is the lexicographic (t, slot) minimum because
// only t > 0 can win; best_init and best_finalize bracket the walk.  The
// result does not depend on the order of the CUDA blocks.
// The products are summed in the order of the plain version's matmul (feature
// rows 0..9, t_num's constant last), so the two round alike: t_num is a
// difference of large terms for a ray far from a triangle's plane, and another
// order moves t by up to 1e-3 relative and flips near-ties between triangles
// that share an edge.
// What bounds it on the card: per (ray, triangle) 25 fp32 FMAs, one divide for
// the rare candidates that pass the sign test, and 25 shared-memory broadcast
// loads per four rays.  A panel is read from device memory once per pair and
// reused by 256 rays, so it is bound by fp32 instruction throughput, not by
// device memory.  wgmma, TMA and persistent blocks are later work.
//
// Semantics kept from the Pallas kernels:
//  - one watertight sign test over the three edge sides and t_num/t_den
//    (shared edges are exactly negated in the neighbouring triangle);
//  - t > 1e-6 as |num| > 1e-6 * |den|, plus |den| > 1e-9; padded triangles
//    (n = 0, so 0/0) fail both and never win;
//  - the running best starts at (t_init, -1), t_init = t_max (1e30 when the
//    range is unbounded), and a hit must be strictly nearer;
//  - ties in t go to the smallest packed slot block * TB + lane.
// Build without --use_fast_math: the divides and the comparisons must be IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kFeat = 10;          // ray feature rows: d(3), m(3), o(3), 1
constexpr int kCoef = 25;          // non-zero panel coefficients per triangle
constexpr int kSub = 256;          // rays per subtile
constexpr int kWalkThreads = 64;   // threads per walk block
constexpr int kRays = kSub / kWalkThreads;  // rays per walk thread
constexpr int kChunk = 8;          // pairs per walk block
constexpr int kPreThreads = 256;   // threads per prepass block
constexpr int kPreWarps = kPreThreads / 32;
constexpr int kChunkBlocks = 4096; // leaf blocks per prepass chunk
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// The prepass
// ---------------------------------------------------------------------------
struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float ds = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return __fdiv_rn(1.0f, ds);
}

// Does the ray enter the box (lo, hi) within [0, t_max)?  (_tile_slab_or)
__device__ __forceinline__ bool slab(const SlabRay& r, const float* lo,
                                     const float* hi, float t_max) {
  const float t1x = __fmul_rn(__fsub_rn(__ldg(lo + 0), r.ox), r.ix);
  const float t2x = __fmul_rn(__fsub_rn(__ldg(hi + 0), r.ox), r.ix);
  const float t1y = __fmul_rn(__fsub_rn(__ldg(lo + 1), r.oy), r.iy);
  const float t2y = __fmul_rn(__fsub_rn(__ldg(hi + 1), r.oy), r.iy);
  const float t1z = __fmul_rn(__fsub_rn(__ldg(lo + 2), r.oz), r.iz);
  const float t2z = __fmul_rn(__fsub_rn(__ldg(hi + 2), r.oz), r.iz);
  if (isnan(t1x) || isnan(t2x) || isnan(t1y) || isnan(t2y) || isnan(t1z) ||
      isnan(t2z)) {
    return false;
  }
  const float entry = fmaxf(fmaxf(fmaxf(-kBig, fminf(t1x, t2x)), fminf(t1y, t2y)),
                            fminf(t1z, t2z));
  const float exit = fminf(fminf(fminf(kBig, fmaxf(t1x, t2x)), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
  return exit >= fmaxf(entry, 0.0f) && entry < t_max;
}

template <int NSUB, bool kFill>
__global__ void __launch_bounds__(kPreThreads)
pairs_prepass_kernel(const float* __restrict__ origins,   // (T * NSUB * 256, 3)
                     const float* __restrict__ dirs,      // (T * NSUB * 256, 3)
                     const float* __restrict__ block_lo,  // (NB, 3)
                     const float* __restrict__ block_hi,  // (NB, 3)
                     const float* __restrict__ group_lo,  // (NG, 3)
                     const float* __restrict__ group_hi,  // (NG, 3)
                     int* __restrict__ sub_counts,        // (T * NSUB), count pass
                     int* __restrict__ tile_groups,       // (T), count pass
                     int* __restrict__ tile_union,        // (T), count pass
                     unsigned* __restrict__ tile_gbits,   // (T * ceil(NG / 32))
                     const int* __restrict__ offsets,     // (T * NSUB + 1), fill pass
                     int* __restrict__ blocks,            // (P), fill pass
                     int nb, int group, float t_max) {
  __shared__ unsigned masks[kChunkBlocks / 4];  // one byte of subtile bits per block
  __shared__ unsigned gbits[kChunkBlocks / 32];  // one bit per group
  __shared__ int warp_cnt[NSUB + 1][kPreWarps];
  __shared__ int run[NSUB + 1];  // list lengths so far; [NSUB]: the union
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  SlabRay ray[NSUB];
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const size_t r = ((size_t)tile * NSUB + s) * kSub + threadIdx.x;
    ray[s] = SlabRay{origins[3 * r], origins[3 * r + 1], origins[3 * r + 2],
                     safe_inv(dirs[3 * r]), safe_inv(dirs[3 * r + 1]),
                     safe_inv(dirs[3 * r + 2])};
  }
  if (threadIdx.x <= NSUB) run[threadIdx.x] = 0;
  int groups_hit = 0;  // thread 0's count
  int my_offset[NSUB];
  if (kFill) {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) my_offset[s] = offsets[tile * NSUB + s];
  }

  const int chunk_groups = kChunkBlocks / group;  // a multiple of 32
  const int ng = (nb + group - 1) / group;
  unsigned* my_gbits = tile_gbits + (size_t)tile * ((ng + 31) / 32);
  for (int g0 = 0; g0 < ng; g0 += chunk_groups) {
    const int g1 = min(g0 + chunk_groups, ng);
    const int b0 = g0 * group;
    const int n_blk = min(g1 * group, nb) - b0;
    for (int i = threadIdx.x; i < kChunkBlocks / 4; i += kPreThreads) masks[i] = 0u;
    for (int i = threadIdx.x; i < kChunkBlocks / 32; i += kPreThreads) gbits[i] = 0u;
    __syncthreads();

    // Stage 1: the groups any ray of the tile enters (the fill pass reads
    // what the count pass found).
    const int words = (g1 - g0 + 31) / 32;
    if (kFill) {
      for (int i = threadIdx.x; i < words; i += kPreThreads) gbits[i] = my_gbits[(g0 >> 5) + i];
    } else {
      for (int g = g0; g < g1; ++g) {
        bool any = false;
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          any |= slab(ray[s], group_lo + 3 * g, group_hi + 3 * g, t_max);
        }
        if (__any_sync(kFull, any) && lane == 0) {
          atomicOr(&gbits[(g - g0) >> 5], 1u << ((g - g0) & 31));
        }
      }
    }
    __syncthreads();
    if (!kFill) {
      for (int i = threadIdx.x; i < words; i += kPreThreads) my_gbits[(g0 >> 5) + i] = gbits[i];
      if (threadIdx.x == 0) {
        for (int i = 0; i < words; ++i) groups_hit += __popc(gbits[i]);
      }
    }

    // Stage 2: each subtile's bit for the blocks of those groups.
    for (int gi = 0; gi < g1 - g0; ++gi) {
      if (!((gbits[gi >> 5] >> (gi & 31)) & 1u)) continue;
      for (int k = 0; k < group; ++k) {
        const int b = (g0 + gi) * group + k;
        if (b >= nb) break;
        unsigned bits = 0u;
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          if (slab(ray[s], block_lo + 3 * b, block_hi + 3 * b, t_max)) bits |= 1u << s;
        }
        bits = __reduce_or_sync(kFull, bits);
        if (lane == 0 && bits) {
          const int bl = b - b0;
          atomicOr(&masks[bl >> 2], bits << ((bl & 3) * 8));
        }
      }
    }
    __syncthreads();

    // Compaction: rank of each hit block in each subtile's list, ascending.
    for (int base = 0; base < n_blk; base += kPreThreads) {
      const int bl = base + threadIdx.x;
      const unsigned bits = bl < n_blk ? (masks[bl >> 2] >> ((bl & 3) * 8)) & 0xFFu : 0u;
      if (!__syncthreads_or(bits != 0u)) continue;  // no block of this piece is hit
      unsigned bal[NSUB + 1];
#pragma unroll
      for (int s = 0; s <= NSUB; ++s) {
        bal[s] = __ballot_sync(kFull, s < NSUB ? (bits >> s) & 1u : bits != 0u);
        if (lane == 0) warp_cnt[s][warp] = __popc(bal[s]);
      }
      __syncthreads();
      if (kFill) {
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          if (!((bits >> s) & 1u)) continue;
          int pos = run[s] + __popc(bal[s] & lt_mask);
          for (int w = 0; w < warp; ++w) pos += warp_cnt[s][w];
          blocks[my_offset[s] + pos] = b0 + bl;
        }
      }
      __syncthreads();
      if (threadIdx.x <= NSUB) {
        int total = 0;
        for (int w = 0; w < kPreWarps; ++w) total += warp_cnt[threadIdx.x][w];
        run[threadIdx.x] += total;
      }
      // The next piece's __syncthreads_or orders this update before its reads.
    }
    __syncthreads();
  }
  if (!kFill) {
    if (threadIdx.x < NSUB) sub_counts[tile * NSUB + threadIdx.x] = run[threadIdx.x];
    if (threadIdx.x == NSUB) tile_union[tile] = run[NSUB];
    if (threadIdx.x == 0) tile_groups[tile] = groups_hit;
  }
}

template <int NSUB>
cudaError_t launch_prepass(int fill, int n_tiles, cudaStream_t stream,
                           const float* o, const float* d, const float* blo,
                           const float* bhi, const float* glo, const float* ghi,
                           int* sub_counts, int* tile_groups, int* tile_union,
                           unsigned* tile_gbits, const int* offsets, int* blocks, int nb,
                           int group, float t_max) {
  if (fill) {
    pairs_prepass_kernel<NSUB, true><<<n_tiles, kPreThreads, 0, stream>>>(
        o, d, blo, bhi, glo, ghi, sub_counts, tile_groups, tile_union, tile_gbits,
        offsets, blocks, nb, group, t_max);
  } else {
    pairs_prepass_kernel<NSUB, false><<<n_tiles, kPreThreads, 0, stream>>>(
        o, d, blo, bhi, glo, ghi, sub_counts, tile_groups, tile_union, tile_gbits,
        offsets, blocks, nb, group, t_max);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pair walk
// ---------------------------------------------------------------------------
// Coefficient j of a triangle -> (feature row, column group) of build_trif.
__device__ __forceinline__ void coef_source(int j, int* row, int* grp) {
  if (j < 18) {          // edges 0..2: rows 0..5 (d then m) of groups 0..2
    *grp = j / 6;
    *row = j % 6;
  } else if (j < 22) {   // t_num: rows 6..9 (o, 1) of group 3
    *grp = 3;
    *row = 6 + (j - 18);
  } else {               // t_den: rows 0..2 (d) of group 4
    *grp = 4;
    *row = j - 22;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying block b's 25 non-zero coefficient rows into dst,
// coefficient-major: coefficient j of lane k lands at dst[j * tb + k].  With
// `vec` (tb % 4 == 0 and trif 16-byte aligned) in 16-byte pieces.
__device__ __forceinline__ void start_panel_copy(float* dst, const float* trif,
                                                 int b, int tb, bool vec) {
  const int width = 5 * tb;
  const float* src = trif + (size_t)b * kFeat * width;
  if (vec) {
    const int pieces = tb / 4;
    for (int i = threadIdx.x; i < kCoef * pieces; i += kWalkThreads) {
      const int j = i / pieces, c = i - j * pieces;
      int row, grp;
      coef_source(j, &row, &grp);
      cp_async16(dst + j * tb + c * 4, src + row * width + grp * tb + c * 4);
    }
  } else {
    for (int i = threadIdx.x; i < kCoef * tb; i += kWalkThreads) {
      const int j = i / tb, k = i - j * tb;
      int row, grp;
      coef_source(j, &row, &grp);
      cp_async4(dst + i, src + row * width + grp * tb + k);
    }
  }
}

__device__ __forceinline__ float dot6(const float* x, const float* c) {
  float a = __fmul_rn(x[0], c[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) a = __fmaf_rn(x[j], c[j], a);
  return a;
}

// One panel (block b) against the thread's rays.
__device__ __forceinline__ void walk_panel(const float* pn, int b, int tb,
                                           const float (&x)[kRays][9],
                                           float (&bt)[kRays], int (&bs)[kRays]) {
#pragma unroll 2
  for (int k = 0; k < tb; ++k) {
    float c[kCoef];
#pragma unroll
    for (int j = 0; j < kCoef; ++j) c[j] = pn[j * tb + k];
    const int slot = b * tb + k;
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const float s0 = dot6(x[i], c);
      const float s1 = dot6(x[i], c + 6);
      const float s2 = dot6(x[i], c + 12);
      // t_num's constant is added last, as the matmul's row of ones adds it.
      const float num = __fadd_rn(
          __fmaf_rn(x[i][8], c[20], __fmaf_rn(x[i][7], c[19], __fmul_rn(x[i][6], c[18]))),
          c[21]);
      const float den = __fmaf_rn(x[i][2], c[24],
                                  __fmaf_rn(x[i][1], c[23], __fmul_rn(x[i][0], c[22])));
      const int i0 = __float_as_int(s0), i1 = __float_as_int(s1);
      const int i2 = __float_as_int(s2);
      const int inum = __float_as_int(num), iden = __float_as_int(den);
      // All five sign bits equal: inside the triangle and t >= 0.
      if (((i0 ^ i1) | (i0 ^ i2) | (inum ^ iden)) < 0) continue;
      const float an = fabsf(num), ad = fabsf(den);
      if (!(an > 1e-6f * ad) || !(ad > 1e-9f)) continue;
      const float t = __fdiv_rn(an, ad);
      if (t < bt[i] || (t == bt[i] && slot < bs[i])) {
        bt[i] = t;
        bs[i] = slot;
      }
    }
  }
}

__device__ __forceinline__ void load_rays(const float* f, int s, float (&x)[kRays][9]) {
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    const float* fr = f + ((size_t)s * kSub + threadIdx.x + i * kWalkThreads) * kFeat;
#pragma unroll
    for (int j = 0; j < 9; ++j) x[i][j] = fr[j];
  }
}

// Merge subtile s's running minimum into the per-ray 64-bit minimum.
__device__ __forceinline__ void flush(unsigned long long* best, int s,
                                      const float (&bt)[kRays], const int (&bs)[kRays]) {
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    if (bs[i] < 0) continue;
    unsigned long long* dst = best + (size_t)s * kSub + threadIdx.x + i * kWalkThreads;
    const unsigned long long packed =
        ((unsigned long long)__float_as_uint(bt[i]) << 32) | (unsigned)bs[i];
    if (packed < *(volatile unsigned long long*)dst) atomicMin(dst, packed);
  }
}

__global__ void __launch_bounds__(kWalkThreads)
raycast_pairs_kernel(const float* __restrict__ f,        // (S*256, 10)
                     const float* __restrict__ trif,     // (NB, 10, 5*TB)
                     const int* __restrict__ offsets,    // (S+1)
                     const int* __restrict__ blocks,     // (P)
                     unsigned long long* __restrict__ best,  // (S*256)
                     int n_subtiles, int n_pairs, int tb, int vec, float t_init) {
  extern __shared__ __align__(16) float panels[];  // 2 x kCoef * tb
  const int panel = kCoef * tb;
  const int p0 = blockIdx.x * kChunk;
  const int p1 = min(p0 + kChunk, n_pairs);
  // The subtile of pair p0: offsets[lo] <= p0 < offsets[hi].
  int lo = 0, hi = n_subtiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= p0) lo = mid; else hi = mid;
  }
  int s = lo;
  int s_end = offsets[s + 1];
  float x[kRays][9];
  float bt[kRays];
  int bs[kRays];
  load_rays(f, s, x);
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    bt[i] = t_init;
    bs[i] = -1;
  }
  start_panel_copy(panels, trif, blocks[p0], tb, vec);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    if (p + 1 < p1) {
      start_panel_copy(panels + ((p + 1 - p0) & 1) * panel, trif, blocks[p + 1], tb, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // pair p's panel has landed
    __syncthreads();
    if (p >= s_end) {  // a new subtile: hand the last one's minimum on
      flush(best, s, bt, bs);
      do {
        ++s;
        s_end = offsets[s + 1];
      } while (p >= s_end);
      load_rays(f, s, x);
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        bt[i] = t_init;
        bs[i] = -1;
      }
    }
    walk_panel(panels + ((p - p0) & 1) * panel, blocks[p], tb, x, bt, bs);
    __syncthreads();  // the buffer may be refilled
  }
  flush(best, s, bt, bs);
}

__global__ void best_init(unsigned long long* best, int n, unsigned long long miss) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = miss;
}

__global__ void best_finalize(const unsigned long long* __restrict__ best,
                              float* __restrict__ t_out, int* __restrict__ slot_out,
                              int n, unsigned long long miss) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long p = best[i];
  t_out[i] = p == miss ? INFINITY : __int_as_float((int)(p >> 32));
  slot_out[i] = p == miss ? -1 : (int)(p & 0xFFFFFFFFull);
}

}  // namespace

extern "C" {

// Each launch function runs on `stream` and returns cudaGetLastError() after
// its last launch (0 when every launch was accepted).

// One pass of the prepass over n_tiles tiles of n_sub subtiles: fill = 0
// writes sub_counts, tile_groups, tile_union and tile_gbits; fill = 1 reads
// tile_gbits and writes blocks at offsets.  group: a power of two <= 128.
int raycast_pairs_prepass_launch(const void* origins, const void* dirs,
                                 const void* block_lo, const void* block_hi,
                                 const void* group_lo, const void* group_hi,
                                 void* sub_counts, void* tile_groups, void* tile_union,
                                 void* tile_gbits, const void* offsets, void* blocks,
                                 int n_tiles, int n_sub, int nb, int group, float t_max,
                                 int fill, void* stream) {
  if (n_tiles <= 0 || nb <= 0 || group <= 0 || group > 128 || (group & (group - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float *o = (const float*)origins, *d = (const float*)dirs;
  const float *blo = (const float*)block_lo, *bhi = (const float*)block_hi;
  const float *glo = (const float*)group_lo, *ghi = (const float*)group_hi;
  int *cnt = (int*)sub_counts, *grp = (int*)tile_groups, *uni = (int*)tile_union;
  unsigned* gb = (unsigned*)tile_gbits;
  const int* off = (const int*)offsets;
  int* blk = (int*)blocks;
#define PREPASS(N)                                                                 \
  case N:                                                                          \
    return (int)launch_prepass<N>(fill, n_tiles, st, o, d, blo, bhi, glo, ghi, cnt, \
                                  grp, uni, gb, off, blk, nb, group, t_max)
  switch (n_sub) {
    PREPASS(1);
    PREPASS(2);
    PREPASS(4);
    PREPASS(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PREPASS
}

// The pair walk: best_init, raycast_pairs_kernel over the n_pairs pairs, then
// best_finalize into t_out (+inf on a miss) and slot_out (-1 on a miss).
int raycast_pairs_launch(const void* f, const void* trif, const void* offsets,
                         const void* blocks, void* best, void* t_out, void* slot_out,
                         int n_subtiles, int n_pairs, int tb, int vec, float t_init,
                         void* stream) {
  if (n_subtiles <= 0 || n_pairs < 0 || tb <= 0 || (vec && tb % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = n_subtiles * kSub;
  unsigned bits;
  memcpy(&bits, &t_init, sizeof(bits));
  const unsigned long long miss = ((unsigned long long)bits << 32) | 0xFFFFFFFFull;
  best_init<<<(n + 255) / 256, 256, 0, st>>>((unsigned long long*)best, n, miss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_pairs > 0) {
    const size_t smem = 2 * (size_t)kCoef * tb * sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(raycast_pairs_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    raycast_pairs_kernel<<<(n_pairs + kChunk - 1) / kChunk, kWalkThreads, smem, st>>>(
        (const float*)f, (const float*)trif, (const int*)offsets, (const int*)blocks,
        (unsigned long long*)best, n_subtiles, n_pairs, tb, vec, t_init);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  best_finalize<<<(n + 255) / 256, 256, 0, st>>>(
      (const unsigned long long*)best, (float*)t_out, (int*)slot_out, n, miss);
  return (int)cudaGetLastError();
}

const char* raycast_pairs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
