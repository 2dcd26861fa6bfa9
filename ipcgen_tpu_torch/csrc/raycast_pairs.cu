// Candidate-pair ray/triangle intersection for Hopper (sm_90a): the exact
// pair prepass and the pair walk.
//
// pairs_prepass_kernel and pairs_prepass_fill_kernel replace the candidate
// prepass of ipcgen_tpu/ops/raycast_mxu.py, candidate_blocks (:297-401).  That is XLA
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
// Three levels of boxes: leaf blocks; groups, the NaN-aware AABB unions of
// `group` consecutive blocks (the caller's group_lo / group_hi); and mega
// boxes, the NaN-aware unions of kMega = 8 consecutive groups, which the
// kernel builds in shared memory from the group table (per axis the least
// and the greatest non-NaN lo or hi coordinate of its groups: the union of
// the boxes as point sets; NaN where all are NaN).
//
// The count pass, pairs_prepass_kernel: one CUDA block of kPreThreads = 256
// threads per tile of n_sub subtiles of 256 rays; thread t holds ray t of
// every subtile (n_sub rays).  Groups are taken a chunk at a time
// (kChunkGroups, and at most kChunkBlocks blocks: the whole main room of
// 6,144 blocks is one chunk).  The chunk's group table is loaded into shared
// memory once and the megas built from it.  Stage 0 tests every ray against
// the megas; stage 1 the groups of the megas that some ray of the tile
// enters; stage 2 the blocks of the groups that some ray enters, whose boxes
// are staged in shared memory kStage at a time.  A box is marked when any ray
// of the tile enters it (__any_sync, or __reduce_or_sync of each thread's
// n_sub subtile bits, then one shared atomicOr per warp).  Stage 2 leaves one
// byte of subtile bits per block; the chunk's bytes go to the tile's row of
// a scratch buffer in device memory (T x NB bytes, rows padded to 16), and
// their popcounts give each subtile's list length and the tile's union.  The
// caller turns the lengths into CSR offsets (torch.cumsum, one host read of
// the total).  The fill pass, pairs_prepass_fill_kernel, runs no slab test: each
// thread takes a run of its tile's row, counts each subtile's bits in it, a
// block-wide scan gives its place in each list, and it writes the blocks in
// ascending order.
//
// The slab test is candidate_blocks' _tile_slab_or: d_safe = +-1e-12 for
// |d| < 1e-12, inv = 1 / d_safe, (lo - o) * inv rounded once each, entry and
// exit clamped to -+3e38, hit when exit >= max(entry, 0) and entry < t_max.
// torch.minimum / maximum propagate NaN, so any NaN slab distance is a miss.
// Two forms, which give the same answer:
//  - checked (slab_checked): the rounding above with an explicit NaN check
//    of the six distances (fminf / fmaxf would drop a NaN that torch
//    propagates).  It runs on a tile that holds a non-finite ray component,
//    and on every tile when t_max is not in (0, 3e38].  Such a tile tests
//    every group (no mega level).
//  - fast (slab_fast): the other tiles.  A box with a NaN coordinate is
//    never entered (its distances are NaN for every ray), so it is flagged
//    once when its table is built and skipped.  For the rest no distance is
//    NaN: d finite gives |inv| in [2.9e-39, 1e12], never 0 or inf, and a
//    finite o and lo give a finite or infinite lo - o, so (lo - o) * inv is
//    never 0 * inf.  Then fminf / fmaxf equal torch's minimum / maximum, and
//    with t_prev the largest float below t_max:
//        exit >= max(entry, 0) and entry < t_max
//    <=> max(0, mins) <= min(t_prev, maxes).
//    (max(entry, 0) = max(0, mins) as entry's -3e38 clamp is below 0;
//    entry < t_max <=> max(0, mins) < t_max as t_max > 0; and once
//    max(0, mins) < t_max <= 3e38, exit's 3e38 clamp cannot decide.)  That is
//    6 differences, 6 products, 6 min / max per axis, 3 + 3 for the entry and
//    exit chains and one compare: 25 issue slots where the checked form takes
//    33 (its 6 NaN checks and 2 clamps).
//
// Why the lists stay exact: for a finite ray, no level prunes a box that the
// ray enters.  With o finite and inv finite and non-zero (safe_inv of a
// finite d), the map x -> fl(fl(x - o) * inv) is monotone in x (rounding to
// nearest is monotone, and so is the product by a fixed inv: non-decreasing
// for inv > 0, non-increasing for inv < 0) and never NaN for a non-NaN x,
// so on each axis the interval of slab distances of a box lies inside that
// of any box whose coordinate range contains the first one's lo and hi.  A
// union box built as above contains the lo and hi of each member with no
// NaN coordinate, and has no NaN coordinate itself when such a member
// exists.  So for a finite ray that enters a member (no NaN distance, which
// needs a member with no NaN coordinate), on every axis the union's min
// distance is <= the member's and its max distance >= the member's; hence
// entry_union <= entry_member and exit_union >= exit_member, and
// exit_union >= exit_member >= max(entry_member, 0) >= max(entry_union, 0),
// entry_union <= entry_member < t_max: the ray enters the union.  So on a
// tile of finite rays a group that some ray enters lies in a mega that some
// ray enters, the `groups` count is exact, and each subtile's list equals
// the plain version's.  The mega's hull of lo and hi (rather than min lo,
// max hi) keeps this true for a box given with lo > hi on an axis.
// For a non-finite ray the argument can fail: an infinite direction gives
// inv = 0, and a union with an infinite coordinate then gives
// (inf - o) * 0 = NaN, a miss, while a finite member gives entry = exit = 0,
// a hit.  So a checked tile skips the mega level.  Its group level matches
// the plain version whatever the ray, because the kernel tests the plain
// version's own groups (the caller's group_lo / group_hi) with its own
// arithmetic.
//
// What bounds it on the card: fp32 issue slots.  The least work these lists
// need is each ray's own descent: every mega, the groups of the megas the
// ray enters and the blocks of the groups it enters (prepass_floors in
// ops/raycast_pairs.py), at 25 slots a test.  The kernel descends a tile at
// a time: every ray of the tile tests the groups of the megas any of its
// rays enters, and the blocks of the groups any of them enters.  Device
// memory moves the rays, the boxes, the T x NB byte buffer and the lists,
// tens of MB.  The test is comparisons and min / max with no product to
// accumulate, so tensor cores and wgmma do not apply.
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
//  - t > 1e-6 as |num| > 1e-6 * |den|, plus |den| > 1e-9 and num of den's
//    sign; padded triangles (n = 0, so 0/0) fail and never win;
//  - the running best starts at (t_init, -1), t_init = t_max (1e30 when the
//    range is unbounded), and a hit must be strictly nearer;
//  - ties in t go to the smallest packed slot block * TB + lane.
// The edge test (ops/raycast_pairs.py, "The edge test", derives the band):
// closed triangles, a side of 0 is inside.  The float32 sides are computed
// about the scene centre and are trusted only beyond the band
// R (R kd + km) of the (ray, block), R = radius[b] (block_radius) and kd,
// km from the ray's features (ray_band_terms): a triangle with a side beyond
// it on the wrong side of den is rejected, one with all three beyond it on
// den's side is hit.  Otherwise, and only when its t would replace the
// running best, inside_f64 decides in float64 from the raw inputs (the ray's
// o and d, tri_data rows 0-8, read from global memory on this rare path, not
// from the panels) about the ray's origin, with no scene centre, each
// product and sum rounded on its own in the plain version's order
// (sides_f64), so a shared edge's two sides are exact negatives and the
// kernel's float64 sides equal the plain version's.
// The float64 path diverges within a warp, and H100 runs float64 at half the
// float32 rate; it is rare, and the counting launch (f64_count) says how rare.
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
constexpr int kMega = 8;             // groups per mega box (MEGA in raycast_pairs.py)
constexpr int kChunkGroups = 1024;   // most groups per prepass chunk
constexpr int kChunkMegas = kChunkGroups / kMega;
constexpr int kChunkBlocks = 8192;   // most leaf blocks per prepass chunk
constexpr int kStage = 512;          // block boxes staged in shared memory at once
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;
// The band's constants: u = 2^-24 times BAND_D, BAND_M, BAND_OD of
// ops/raycast_pairs.py (exact in float32), and _RADIUS_SLACK.
constexpr float kBandU = 5.9604644775390625e-8f;
constexpr float kBandD = 33.0f * kBandU;
constexpr float kBandM = 27.0f * kBandU;
constexpr float kBandOD = 37.0f * kBandU;
constexpr float kRadiusSlack = 1.0f + 9.5367431640625e-7f;

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

// Does the ray enter the box b = (lo xyz, hi xyz) within [0, t_max)?
// (_tile_slab_or, with an explicit NaN check: any ray, any t_max.)
__device__ __forceinline__ bool slab_checked(const SlabRay& r, const float* b, float t_max) {
  const float t1x = __fmul_rn(__fsub_rn(b[0], r.ox), r.ix);
  const float t2x = __fmul_rn(__fsub_rn(b[3], r.ox), r.ix);
  const float t1y = __fmul_rn(__fsub_rn(b[1], r.oy), r.iy);
  const float t2y = __fmul_rn(__fsub_rn(b[4], r.oy), r.iy);
  const float t1z = __fmul_rn(__fsub_rn(b[2], r.oz), r.iz);
  const float t2z = __fmul_rn(__fsub_rn(b[5], r.oz), r.iz);
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

// The same answer for a finite ray, a box with no NaN coordinate and
// 0 < t_max <= 3e38, with t_prev the largest float below t_max (header).
__device__ __forceinline__ bool slab_fast(const SlabRay& r, const float* b, float t_prev) {
  const float t1x = __fmul_rn(__fsub_rn(b[0], r.ox), r.ix);
  const float t2x = __fmul_rn(__fsub_rn(b[3], r.ox), r.ix);
  const float t1y = __fmul_rn(__fsub_rn(b[1], r.oy), r.iy);
  const float t2y = __fmul_rn(__fsub_rn(b[4], r.oy), r.iy);
  const float t1z = __fmul_rn(__fsub_rn(b[2], r.oz), r.iz);
  const float t2z = __fmul_rn(__fsub_rn(b[5], r.oz), r.iz);
  const float entry = fmaxf(fmaxf(fmaxf(0.0f, fminf(t1x, t2x)), fminf(t1y, t2y)),
                            fminf(t1z, t2z));
  const float exit = fminf(fminf(fminf(t_prev, fmaxf(t1x, t2x)), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
  return entry <= exit;
}

template <int NSUB>
__device__ __forceinline__ unsigned subtile_bits(const SlabRay (&ray)[NSUB], const float* b,
                                                 bool checked, float t_max, float t_prev) {
  unsigned bits = 0u;
  if (checked) {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) bits |= (unsigned)slab_checked(ray[s], b, t_max) << s;
  } else {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) bits |= (unsigned)slab_fast(ray[s], b, t_prev) << s;
  }
  return bits;
}

__device__ __forceinline__ bool box_has_nan(const float* b) {
  return isnan(b[0]) || isnan(b[1]) || isnan(b[2]) || isnan(b[3]) || isnan(b[4]) ||
         isnan(b[5]);
}

// Shared memory of the count pass (dynamic: about 54 KB).
struct PrepassSmem {
  float gbox[kChunkGroups * 6];       // the chunk's groups: lo xyz, hi xyz
  float mbox[kChunkMegas * 6];        // its megas
  float sbox[kStage * 6];             // staged block boxes
  int sid[kStage];                    // their chunk-local ids; -1: NaN or past NB
  int glist[kChunkGroups];            // the hit groups, ascending
  unsigned masks[kChunkBlocks / 4];   // one byte of subtile bits per block
  unsigned gvalid[kChunkGroups / 32]; // groups with no NaN coordinate
  unsigned gbits[kChunkGroups / 32];  // groups some ray enters
  unsigned mvalid[kChunkMegas / 32];
  unsigned mbits[kChunkMegas / 32];
  int totals[9];                      // NSUB list lengths, then the union
  int n_hit;
};

// Count pass: each subtile's list length, the tile's group count and union
// size, and its row of subtile bytes in `rows`; with `stage_counts` (the
// counting launch) also the boxes considered at each level times the tile's
// rays, and the checked tiles.
template <int NSUB>
__global__ void __launch_bounds__(kPreThreads)
pairs_prepass_kernel(const float* __restrict__ origins,   // (T * NSUB * 256, 3)
                     const float* __restrict__ dirs,      // (T * NSUB * 256, 3)
                     const float* __restrict__ block_lo,  // (NB, 3)
                     const float* __restrict__ block_hi,  // (NB, 3)
                     const float* __restrict__ group_lo,  // (NG, 3)
                     const float* __restrict__ group_hi,  // (NG, 3)
                     int* __restrict__ sub_counts,        // (T * NSUB)
                     int* __restrict__ tile_groups,       // (T)
                     int* __restrict__ tile_union,        // (T)
                     unsigned* __restrict__ rows,         // (T, row_words)
                     unsigned long long* __restrict__ stage_counts,  // (4) or null
                     int nb, int group, int row_words, float t_max, float t_prev,
                     int fast_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrepassSmem& sm = *reinterpret_cast<PrepassSmem*>(smem_raw);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;

  SlabRay ray[NSUB];
  bool finite = true;
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const size_t r = ((size_t)tile * NSUB + s) * kSub + threadIdx.x;
    const float ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
    const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
    finite &= isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) &&
              isfinite(dy) && isfinite(dz);
    ray[s] = SlabRay{ox, oy, oz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
  }
  if (threadIdx.x <= NSUB) sm.totals[threadIdx.x] = 0;
  // A tile with a non-finite ray component takes the checked form.
  const bool checked = __syncthreads_or(!finite) || !fast_t;

  int cnt[NSUB + 1];  // this thread's share of the list lengths and the union
#pragma unroll
  for (int s = 0; s <= NSUB; ++s) cnt[s] = 0;
  int groups_hit = 0;                                    // thread 0's count
  unsigned long long n_mega = 0, n_group = 0, n_block = 0;  // thread 0's counts
  const int ng = (nb + group - 1) / group;
  const int chunk_groups = min(kChunkGroups, kChunkBlocks / group);  // a multiple of kMega
  unsigned* row = rows + (size_t)tile * row_words;
  for (int c0 = 0; c0 < ng; c0 += chunk_groups) {
    const int ncg = min(chunk_groups, ng - c0);
    const int nmc = (ncg + kMega - 1) / kMega;
    const int b0 = c0 * group;
    const int n_blk = min(b0 + ncg * group, nb) - b0;
    const bool last = c0 + ncg == ng;
    // The chunk's words of the row: the last chunk pads the row to its end.
    const int n_words = last ? row_words - b0 / 4 : n_blk / 4;

    for (int i = threadIdx.x; i < ncg * 3; i += kPreThreads) {
      const int g = i / 3, a = i - 3 * g;
      sm.gbox[6 * g + a] = group_lo[3 * c0 + i];
      sm.gbox[6 * g + 3 + a] = group_hi[3 * c0 + i];
    }
    for (int i = threadIdx.x; i < n_words; i += kPreThreads) sm.masks[i] = 0u;
    if (threadIdx.x < kChunkGroups / 32) {
      sm.gvalid[threadIdx.x] = 0u;
      sm.gbits[threadIdx.x] = 0u;
    }
    if (threadIdx.x < kChunkMegas / 32) {
      sm.mvalid[threadIdx.x] = 0u;
      sm.mbits[threadIdx.x] = 0u;
    }
    __syncthreads();

    // Megas and the NaN flags of the groups and megas.
    for (int m = threadIdx.x; m < nmc; m += kPreThreads) {
      float lo[3] = {NAN, NAN, NAN}, hi[3] = {NAN, NAN, NAN};
      unsigned valid = 0u;
      for (int k = 0; k < kMega && kMega * m + k < ncg; ++k) {
        const float* b = sm.gbox + 6 * (kMega * m + k);
        if (!box_has_nan(b)) valid |= 1u << k;
#pragma unroll
        for (int a = 0; a < 3; ++a) {  // fminf / fmaxf drop a NaN: the union
          lo[a] = fminf(lo[a], fminf(b[a], b[3 + a]));
          hi[a] = fmaxf(hi[a], fmaxf(b[a], b[3 + a]));
        }
      }
      float* mb = sm.mbox + 6 * m;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mb[a] = lo[a];
        mb[3 + a] = hi[a];
      }
      if (valid) atomicOr(&sm.gvalid[m >> 2], valid << ((m & 3) * 8));
      if (!box_has_nan(mb)) atomicOr(&sm.mvalid[m >> 5], 1u << (m & 31));
    }
    __syncthreads();

    // Stages 0 and 1: the groups some ray of the tile enters.
    if (checked) {
      for (int w = 0; w < (ncg + 31) / 32; ++w) {
        for (unsigned gv = sm.gvalid[w]; gv; gv &= gv - 1) {
          const int g = 32 * w + __ffs(gv) - 1;
          const bool any = subtile_bits<NSUB>(ray, sm.gbox + 6 * g, true, t_max, t_prev) != 0u;
          if (__any_sync(kFull, any) && lane == 0) atomicOr(&sm.gbits[w], 1u << (g & 31));
        }
      }
      n_group += ncg;
    } else {
      for (int w = 0; w < (nmc + 31) / 32; ++w) {
        for (unsigned mv = sm.mvalid[w]; mv; mv &= mv - 1) {
          const int m = 32 * w + __ffs(mv) - 1;
          const bool any = subtile_bits<NSUB>(ray, sm.mbox + 6 * m, false, t_max, t_prev) != 0u;
          if (__any_sync(kFull, any) && lane == 0) atomicOr(&sm.mbits[w], 1u << (m & 31));
        }
      }
      n_mega += nmc;
      __syncthreads();
      for (int w = 0; w < (nmc + 31) / 32; ++w) {
        for (unsigned mh = sm.mbits[w]; mh; mh &= mh - 1) {
          const int m = 32 * w + __ffs(mh) - 1;
          n_group += min(kMega, ncg - kMega * m);
          const unsigned cand = (sm.gvalid[m >> 2] >> ((m & 3) * 8)) & 0xFFu;
          for (unsigned gv = cand; gv; gv &= gv - 1) {
            const int g = kMega * m + __ffs(gv) - 1;
            const bool any =
                subtile_bits<NSUB>(ray, sm.gbox + 6 * g, false, t_max, t_prev) != 0u;
            if (__any_sync(kFull, any) && lane == 0) atomicOr(&sm.gbits[g >> 5], 1u << (g & 31));
          }
        }
      }
    }
    __syncthreads();

    // The hit groups in ascending order (warp 0 scans the bit words).
    if (threadIdx.x < 32) {
      const int words = (ncg + 31) / 32;
      const unsigned bits = lane < words ? sm.gbits[lane] : 0u;
      const int n = __popc(bits);
      int incl = n;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, k);
        if (lane >= k) incl += y;
      }
      int pos = incl - n;
      for (unsigned b = bits; b; b &= b - 1) sm.glist[pos++] = 32 * lane + __ffs(b) - 1;
      if (lane == 31) sm.n_hit = incl;
    }
    __syncthreads();
    const int n_hit = sm.n_hit;
    groups_hit += n_hit;

    // Stage 2: the blocks of the hit groups, kStage boxes at a time.
    const int per_batch = kStage / group;
    for (int h0 = 0; h0 < n_hit; h0 += per_batch) {
      const int n_stage = min(per_batch, n_hit - h0) * group;
      for (int j = threadIdx.x; j < n_stage; j += kPreThreads) {
        const int bl = sm.glist[h0 + j / group] * group + (j & (group - 1));
        int id = -1;
        if (bl < n_blk) {
          const int b = b0 + bl;
          float* sb = sm.sbox + 6 * j;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            sb[a] = __ldg(block_lo + 3 * b + a);
            sb[3 + a] = __ldg(block_hi + 3 * b + a);
          }
          if (!box_has_nan(sb)) id = bl;
        }
        sm.sid[j] = id;
      }
      __syncthreads();
      for (int j = 0; j < n_stage; ++j) {
        const int bl = sm.sid[j];
        if (bl < 0) continue;
        unsigned bits = subtile_bits<NSUB>(ray, sm.sbox + 6 * j, checked, t_max, t_prev);
        bits = __reduce_or_sync(kFull, bits);
        if (lane == 0 && bits) atomicOr(&sm.masks[bl >> 2], bits << ((bl & 3) * 8));
      }
      __syncthreads();
    }
    if (stage_counts && threadIdx.x == 0) {
      for (int h = 0; h < n_hit; ++h) n_block += min(group, n_blk - sm.glist[h] * group);
    }

    // The chunk's bytes to the tile's row; each subtile's bits and the union.
    for (int i = threadIdx.x; i < n_words; i += kPreThreads) {
      const unsigned v = sm.masks[i];
      row[b0 / 4 + i] = v;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) cnt[s] += __popc(v & (0x01010101u << s));
      cnt[NSUB] += __popc(__vcmpne4(v, 0u)) >> 3;
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s <= NSUB; ++s) {
    const int total = __reduce_add_sync(kFull, (unsigned)cnt[s]);
    if (lane == 0) atomicAdd(&sm.totals[s], total);
  }
  __syncthreads();
  if (threadIdx.x < NSUB) sub_counts[tile * NSUB + threadIdx.x] = sm.totals[threadIdx.x];
  if (threadIdx.x == NSUB) tile_union[tile] = sm.totals[NSUB];
  if (threadIdx.x == 0) {
    tile_groups[tile] = groups_hit;
    if (stage_counts) {
      const unsigned long long rays = NSUB * kSub;
      atomicAdd(stage_counts + 0, n_mega * rays);
      atomicAdd(stage_counts + 1, n_group * rays);
      atomicAdd(stage_counts + 2, n_block * rays);
      atomicAdd(stage_counts + 3, checked ? 1ull : 0ull);
    }
  }
}

// Fill pass: no slab test.  Thread t takes words [t * per, (t + 1) * per) of
// the tile's row, so the threads' runs are in block order; a block-wide scan
// of each subtile's counts gives each thread's place in the subtile's list.
template <int NSUB>
__global__ void __launch_bounds__(kPreThreads)
pairs_prepass_fill_kernel(const unsigned* __restrict__ rows,  // (T, row_words)
                    const int* __restrict__ offsets,    // (T * NSUB + 1)
                    int* __restrict__ blocks,           // (P)
                    int row_words) {
  __shared__ int warp_tot[NSUB][kPreWarps];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* row = rows + (size_t)tile * row_words;
  const int per = (row_words + kPreThreads - 1) / kPreThreads;
  const int w0 = min((int)threadIdx.x * per, row_words), w1 = min(w0 + per, row_words);
  int pos[NSUB];
#pragma unroll
  for (int s = 0; s < NSUB; ++s) pos[s] = 0;
  for (int w = w0; w < w1; ++w) {
    const unsigned v = row[w];
#pragma unroll
    for (int s = 0; s < NSUB; ++s) pos[s] += __popc(v & (0x01010101u << s));
  }
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const int n = pos[s];
    int incl = n;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, k);
      if (lane >= k) incl += y;
    }
    pos[s] = incl - n;
    if (lane == 31) warp_tot[s][warp] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    int base = offsets[tile * NSUB + s];
    for (int k = 0; k < warp; ++k) base += warp_tot[s][k];
    pos[s] += base;
  }
  for (int w = w0; w < w1; ++w) {
    const unsigned v = row[w];
    if (!v) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned byte = (v >> (8 * k)) & 0xFFu;
      if (!byte) continue;
      const int b = 4 * w + k;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        if ((byte >> s) & 1u) blocks[pos[s]++] = b;
      }
    }
  }
}

// Words of a tile's row of subtile bytes: NB bytes padded to 16.
inline int prepass_row_words(int nb) { return (nb + 15) / 16 * 4; }

template <int NSUB>
cudaError_t launch_prepass(int fill, int n_tiles, cudaStream_t stream, const float* o,
                           const float* d, const float* blo, const float* bhi,
                           const float* glo, const float* ghi, int* sub_counts,
                           int* tile_groups, int* tile_union, unsigned* rows,
                           const int* offsets, int* blocks, unsigned long long* stage_counts,
                           int nb, int group, float t_max) {
  const int row_words = prepass_row_words(nb);
  if (fill) {
    pairs_prepass_fill_kernel<NSUB><<<n_tiles, kPreThreads, 0, stream>>>(rows, offsets, blocks,
                                                                   row_words);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(PrepassSmem);
  cudaError_t err = cudaFuncSetAttribute(pairs_prepass_kernel<NSUB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // The fast form needs 0 < t_max <= 3e38 (header); t_prev is the float
  // below t_max.
  const int fast_t = t_max > 0.0f && t_max <= kBig;
  const float t_prev = fast_t ? nextafterf(t_max, 0.0f) : t_max;
  pairs_prepass_kernel<NSUB><<<n_tiles, kPreThreads, smem, stream>>>(
      o, d, blo, bhi, glo, ghi, sub_counts, tile_groups, tile_union, rows, stage_counts, nb,
      group, row_words, t_max, t_prev, fast_t);
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

// The three float64 sides of ray r against triangle (b, k) about the ray's
// origin, d.((p - o) x (q - o)) (sides_f64 in ops/raycast_pairs.py,
// operation for operation): is each 0 or of den's sign?
__device__ __noinline__ bool inside_f64(const float* __restrict__ origins,
                                        const float* __restrict__ dirs,
                                        const float* __restrict__ tri_data, size_t r, int b,
                                        int k, int tb, bool den_pos) {
  const double o[3] = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
  const double d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
  const float* tp = tri_data + (size_t)b * 16 * tb + k;
  double v[3][3];  // v0 - o, (v0 + e1) - o, (v0 + e2) - o
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double v0 = tp[a * tb];
    v[0][a] = __dsub_rn(v0, o[a]);
    v[1][a] = __dsub_rn(__dadd_rn(v0, (double)tp[(3 + a) * tb]), o[a]);
    v[2][a] = __dsub_rn(__dadd_rn(v0, (double)tp[(6 + a) * tb]), o[a]);
  }
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const double* p = v[e];
    const double* q = v[(e + 1) % 3];
    const double cx = __dsub_rn(__dmul_rn(p[1], q[2]), __dmul_rn(p[2], q[1]));
    const double cy = __dsub_rn(__dmul_rn(p[2], q[0]), __dmul_rn(p[0], q[2]));
    const double cz = __dsub_rn(__dmul_rn(p[0], q[1]), __dmul_rn(p[1], q[0]));
    const double side =
        __dadd_rn(__dadd_rn(__dmul_rn(d[0], cx), __dmul_rn(d[1], cy)), __dmul_rn(d[2], cz));
    inside &= side == 0.0 || (den_pos ? side > 0.0 : side < 0.0);
  }
  return inside;
}

// The raw inputs of the float64 path, and its count (null but on the
// counting launch).
struct RawInputs {
  const float* origins;   // (S*256, 3)
  const float* dirs;      // (S*256, 3)
  const float* tri_data;  // (NB, 16, TB)
  unsigned long long* f64_count;
};

// One panel (block b) against the thread's rays (rays of subtile s).
__device__ __forceinline__ void walk_panel(const float* pn, int b, int tb, float radius,
                                           const float (&x)[kRays][9],
                                           const float (&kd)[kRays], const float (&km)[kRays],
                                           float (&bt)[kRays], int (&bs)[kRays],
                                           const RawInputs& raw, int s, unsigned& n_f64) {
  float band[kRays];
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    band[i] = __fmul_rn(radius, __fadd_rn(__fmul_rn(radius, kd[i]), km[i]));
  }
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
      // The sides as seen from den's side (inside >= 0); fminf as torch.fmin.
      const unsigned flip = __float_as_uint(den) & 0x80000000u;
      const float lo = fminf(fminf(__uint_as_float(__float_as_uint(s0) ^ flip),
                                   __uint_as_float(__float_as_uint(s1) ^ flip)),
                             __uint_as_float(__float_as_uint(s2) ^ flip));
      if (lo < -band[i]) continue;  // a side surely outside
      if ((__float_as_int(num) ^ __float_as_int(den)) < 0) continue;  // t < 0
      const float an = fabsf(num), ad = fabsf(den);
      if (!(an > 1e-6f * ad) || !(ad > 1e-9f)) continue;
      const float t = __fdiv_rn(an, ad);
      if (!(t < bt[i] || (t == bt[i] && slot < bs[i]))) continue;
      if (!(lo > band[i])) {  // a side within the band: float64 decides
        ++n_f64;
        const size_t r = (size_t)s * kSub + threadIdx.x + i * kWalkThreads;
        if (!inside_f64(raw.origins, raw.dirs, raw.tri_data, r, b, k, tb, den > 0.0f)) {
          continue;
        }
      }
      bt[i] = t;
      bs[i] = slot;
    }
  }
}

// The rays of subtile s and their band terms (ray_band_terms, operation for
// operation).
__device__ __forceinline__ void load_rays(const float* f, int s, float (&x)[kRays][9],
                                          float (&kd)[kRays], float (&km)[kRays]) {
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    const float* fr = f + ((size_t)s * kSub + threadIdx.x + i * kWalkThreads) * kFeat;
#pragma unroll
    for (int j = 0; j < 9; ++j) x[i][j] = fr[j];
    float a[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) a[j] = fabsf(x[i][j]);
    const float d1 = __fadd_rn(__fadd_rn(a[0], a[1]), a[2]);
    const float d_inf = fmaxf(fmaxf(a[0], a[1]), a[2]);
    const float m1 = __fadd_rn(__fadd_rn(a[3], a[4]), a[5]);
    const float rho = __fmul_rn(fmaxf(fmaxf(a[6], a[7]), a[8]), kRadiusSlack);
    kd[i] = __fmul_rn(d1, kBandD);
    km[i] = __fadd_rn(__fmul_rn(m1, kBandM), __fmul_rn(__fmul_rn(rho, d_inf), kBandOD));
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
                     const float* __restrict__ radius,   // (NB)
                     const int* __restrict__ offsets,    // (S+1)
                     const int* __restrict__ blocks,     // (P)
                     unsigned long long* __restrict__ best,  // (S*256)
                     RawInputs raw, int n_subtiles, int n_pairs, int tb, int vec,
                     float t_init) {
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
  float kd[kRays], km[kRays];
  float bt[kRays];
  int bs[kRays];
  unsigned n_f64 = 0;
  load_rays(f, s, x, kd, km);
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
      load_rays(f, s, x, kd, km);
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        bt[i] = t_init;
        bs[i] = -1;
      }
    }
    const int b = blocks[p];
    walk_panel(panels + ((p - p0) & 1) * panel, b, tb, __ldg(radius + b), x, kd, km, bt, bs,
               raw, s, n_f64);
    __syncthreads();  // the buffer may be refilled
  }
  flush(best, s, bt, bs);
  if (raw.f64_count) {
    const unsigned total = __reduce_add_sync(kFull, n_f64);
    if ((threadIdx.x & 31) == 0 && total) atomicAdd(raw.f64_count, (unsigned long long)total);
  }
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

// One pass of the prepass over n_tiles tiles of n_sub subtiles: fill = 0
// (pairs_prepass_kernel) writes sub_counts, tile_groups, tile_union and the
// tiles' rows of subtile bytes in `rows` (n_tiles * ceil(nb / 16) * 4 words);
// fill = 1 (pairs_prepass_fill_kernel) reads `rows` and writes blocks at offsets.
// group: a power of two <= 128.
int prepass(const void* origins, const void* dirs, const void* block_lo,
            const void* block_hi, const void* group_lo, const void* group_hi,
            void* sub_counts, void* tile_groups, void* tile_union, void* rows,
            const void* offsets, void* blocks, void* stage_counts, int n_tiles, int n_sub,
            int nb, int group, float t_max, int fill, void* stream) {
  if (n_tiles <= 0 || nb <= 0 || group <= 0 || group > 128 || (group & (group - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float *o = (const float*)origins, *d = (const float*)dirs;
  const float *blo = (const float*)block_lo, *bhi = (const float*)block_hi;
  const float *glo = (const float*)group_lo, *ghi = (const float*)group_hi;
  int *cnt = (int*)sub_counts, *grp = (int*)tile_groups, *uni = (int*)tile_union;
  unsigned* rw = (unsigned*)rows;
  const int* off = (const int*)offsets;
  int* blk = (int*)blocks;
  unsigned long long* sc = (unsigned long long*)stage_counts;
#define PREPASS(N)                                                                 \
  case N:                                                                          \
    return (int)launch_prepass<N>(fill, n_tiles, st, o, d, blo, bhi, glo, ghi, cnt, \
                                  grp, uni, rw, off, blk, sc, nb, group, t_max)
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

}  // namespace

extern "C" {

// One pass of the prepass (see prepass above).  stage_counts: null, or (on
// the count pass) 4 zeroed uint64 to which the count pass adds the megas,
// groups and blocks it considers, each times the tile's rays, and the tiles
// that took the checked form.
int raycast_pairs_prepass_launch(const void* origins, const void* dirs,
                                 const void* block_lo, const void* block_hi,
                                 const void* group_lo, const void* group_hi,
                                 void* sub_counts, void* tile_groups, void* tile_union,
                                 void* rows, const void* offsets, void* blocks,
                                 void* stage_counts, int n_tiles, int n_sub, int nb,
                                 int group, float t_max, int fill, void* stream) {
  return prepass(origins, dirs, block_lo, block_hi, group_lo, group_hi, sub_counts,
                 tile_groups, tile_union, rows, offsets, blocks, stage_counts, n_tiles, n_sub,
                 nb, group, t_max, fill, stream);
}

// Each launch function runs on `stream` and returns cudaGetLastError() after
// its last launch (0 when every launch was accepted).

// The pair walk: best_init, raycast_pairs_kernel over the n_pairs pairs, then
// best_finalize into t_out (+inf on a miss) and slot_out (-1 on a miss).
// origins, dirs (S*256, 3) are the rays of f's rows, tri_data (NB, 16, TB)
// the triangles of trif's panels and radius (NB) their block radii; all
// float32.  f64_count: null, or (the counting launch) one zeroed uint64 to
// which the walk adds its float64 edge decisions.
int raycast_pairs_launch(const void* f, const void* origins, const void* dirs,
                         const void* trif, const void* tri_data, const void* radius,
                         const void* offsets, const void* blocks, void* best, void* t_out,
                         void* slot_out, void* f64_count, int n_subtiles, int n_pairs, int tb,
                         int vec, float t_init, void* stream) {
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
    const RawInputs raw{(const float*)origins, (const float*)dirs, (const float*)tri_data,
                        (unsigned long long*)f64_count};
    raycast_pairs_kernel<<<(n_pairs + kChunk - 1) / kChunk, kWalkThreads, smem, st>>>(
        (const float*)f, (const float*)trif, (const float*)radius, (const int*)offsets,
        (const int*)blocks, (unsigned long long*)best, raw, n_subtiles, n_pairs, tb, vec,
        t_init);
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
