// Two-level AABB-culled Moller-Trumbore raycast for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _raycast_kernel of
// ipcgen_tpu/ops/raycast_pallas.py (:41-115, launched at :138).  It computes
// the same function: for each ray, the lexicographic minimum (t, packed slot)
// over every triangle it hits with 1e-6 < t, starting from (t_init, -1), so a
// hit at exactly t_max is dropped and ties go to the smallest slot.  The plain
// PyTorch version of the same function is raycast_culled_plain in
// ipcgen_tpu_torch/ops/raycast_culled.py.
//
// Design
// ------
// Culling per warp.  A warp of kGroup = 32 consecutive rays (one ray a lane)
// walks the hierarchy on its own, with warp votes and no block-wide barrier
// after the start; a CUDA block is kWarps independent warps.  In beam order
// 32 rays sweep a few degrees of one scan line, so a warp visits few boxes
// that only some of its rays enter.
//
// Near-to-far order.  The warp slab-tests the super blocks (each lane its
// own ray) and lists those any lane enters, keyed by the smallest entry
// distance over its lanes (__reduce_min_sync on the float bits, the low bits
// replaced by the list position).  It takes them nearest first, and inside a
// super its leaf blocks nearest first (the same keys, 32 leaves a round).
// The walk stops when the nearest key left is beyond every lane's running
// best.  Each visit is decided again just before it, with the lanes' current
// bests and the exact slab test.  The list holds kListCap supers; a warp that
// enters more refills it from where its scan stopped.
//
// Mega boxes.  The scan would slab-test every super for every ray.  Each
// CUDA block first builds, in shared memory, the union boxes of kMegaFactor
// consecutive supers (Morton order keeps them close); the scan skips all of
// a mega box's supers when no lane enters it.  The scan and the keys use the
// slab test without its NaN checks: it passes every box the exact test
// passes, and lists or orders boxes only.
//
// Order-free result.  Every lane keeps the lexicographic minimum of
// (t, slot), and a box is visited when its entry tmin <= best (not <): a
// skipped box could otherwise hold an equal t at a smaller slot.  A box whose
// eps-padded AABB no lane enters by its best cannot hold a hit at or before
// it, so the result is the same in any visiting order and equals the
// block-scan oracle's (ascending blocks, strict <).
//
// Panels.  Each warp double-buffers the (9, TB) panel of the leaf blocks it
// visits in its own slice of shared memory with cp.async: while one panel is
// tested, the next leaf, chosen with the bests before the test, is in flight;
// if the test leaves no lane entering it, it is dropped and the walk goes on.
// The panel rows are padded to a multiple of 4 with NaN (never a hit) and read
// as float4 along the triangle index, so 9 LDS.128 broadcasts serve 4
// triangles.
//
// Divide only for survivors.  A test computes det, then u's, v's and t's
// numerators U, V and N in the association of moller_trumbore_components,
// and returns as soon as it is sure to fail: |det| <= 1e-9 (the exact
// guard); U or V of the opposite sign to det and larger than
// |det| * fl(1e-7 * K); N zero or of the opposite sign; |N| larger than
// |det| * fl(best * K); K = kSlack = 1 + 16u.  Only the survivors take the
// IEEE 1 / det and u = U r, v = V r, t = N r (r = fl(1 / det)), exactly the
// sequence of moller_trumbore_components, so every result is bit-identical.
// Why a rejection on magnitude is safe (u = 2^-24, every step rounded to
// nearest; X is U, V or N against the bound B = 1e-7 or best, B > 1e-9):
//   thr = fl(|det| * fl(B * K)) >= |det| B K (1 - u)^2
//   |det r| >= 1 - 4u  (1 - u if 1 / det is normal; a subnormal 1 / det
//                       errs by at most 2^-150 against |1 / det| >= 2^-128)
//   |X| > thr  =>  |X r| > B K (1 - u)^2 (1 - 4u) >= B (1 + 9u)
//   |fl(X r)| >= fl(B (1 + 9u)) > B, since ulp(B) <= 2u B; or it is inf.
// So u < -1e-7 or v < -1e-7 (the barycentric test fails), or t > best (it
// could never replace (best, slot)).  If B * K overflows, thr is +inf and
// nothing is rejected; a NaN is never rejected early and fails later.
//
// Bit-exactness against the oracle and the plain version:
//  - every product, sum and difference is written with __fmul_rn, __fadd_rn
//    and __fsub_rn, which nvcc never contracts into FMAs, in the association
//    of moller_trumbore_components (ops/geometry.py); the source is also
//    built with -fmad=false (ops/_kernels.py);
//  - 1/det and 1/d are IEEE divides (__fdiv_rn): a zero direction component
//    gives +-inf as in torch;
//  - a visit's slab test fails whenever one of its six slab distances is NaN
//    (a NaN-padded AABB, or (lo - o) * inf with o on the slab plane), as the
//    NaN-propagating torch.minimum/maximum/clamp make it fail.
// Build without --use_fast_math.
//
// What bounds it on the card: fp32 issue slots.  Per (ray, triangle) of a
// visited block 14 to 45 unfused operations (no FMA may form), by how far
// the prescreen lets it go, plus compares and 9/4 shared-memory loads; per
// survivor the divide's SASS sequence.  The least work is each ray's own
// leaf blocks entered before its final t (the per-ray floor of
// raycast_culled.visit_floors, chip_smoke.py's bound); a warp adds the
// blocks that only some of its lanes enter, and the scan adds a slab test per
// ray and mega box, and per super in the mega boxes it enters.  Device
// memory moves little: a panel is read once per visiting warp, mostly from
// L2.
//
// raycast_culled_kernel<true> is the counting instantiation: the same walk
// plus counters (warp visits of leaf blocks, the ray-triangle tests of active
// lanes, the tests past each prescreen stage, warp visits of supers),
// launched through raycast_culled_count_launch by chip_smoke.py and the
// card tests only; the main path launches raycast_culled_kernel<false>.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;         // rays per warp, one per lane: the culling group
constexpr int kWarps = 4;          // warps per CUDA block
constexpr int kListCap = 256;      // supers listed per warp at a time
constexpr int kListRegs = kListCap / 32;
constexpr int kMegaFactor = 8;     // supers per mega box, or more past kMaxMegas boxes
constexpr int kMaxMegas = 128;
constexpr int kPanelRows = 9;      // v0, e1, e2 components of tri_data rows 0..8
constexpr int kTriRows = 16;       // rows per tri_data block
constexpr float kMtEps = 1e-9f;    // determinant guard (MT_EPS)
constexpr float kBaryLo = -1e-7f;  // -BARY_EPS
constexpr float kBaryHi = (float)(1.0 + 1e-7);  // 1 + BARY_EPS, rounded once
constexpr float kTMin = 1e-6f;
constexpr float kSlack = 1.0f + 1.0f / 1048576.0f;  // 1 + 2^-20 = 1 + 16 unit roundoffs
constexpr float kBaryK = 1e-7f * kSlack;            // fl(BARY_EPS * kSlack)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;  // an empty key

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// ray_aabb_hit of ops/geometry.py with tmin <= best: does [0, best] of the
// ray enter the box (lo, hi)?  On a pass, *entry = max(tmin, 0).  kExact: a
// NaN slab distance fails, as torch's NaN-propagating min / max make it
// fail; without it (the scans that only list and order boxes) fminf / fmaxf
// drop a NaN, which can only pass more boxes: with no NaN the two agree.
template <bool kExact>
__device__ __forceinline__ bool slab_box(const Ray& r, float lox, float loy, float loz,
                                         float hix, float hiy, float hiz, float best,
                                         float* entry) {
  const float t1x = __fmul_rn(__fsub_rn(lox, r.ox), r.ix);
  const float t2x = __fmul_rn(__fsub_rn(hix, r.ox), r.ix);
  const float t1y = __fmul_rn(__fsub_rn(loy, r.oy), r.iy);
  const float t2y = __fmul_rn(__fsub_rn(hiy, r.oy), r.iy);
  const float t1z = __fmul_rn(__fsub_rn(loz, r.oz), r.iz);
  const float t2z = __fmul_rn(__fsub_rn(hiz, r.oz), r.iz);
  if (kExact && (isnan(t1x) || isnan(t2x) || isnan(t1y) || isnan(t2y) || isnan(t1z) ||
                 isnan(t2z))) {
    return false;
  }
  const float tmin =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax =
      fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  *entry = tmin > 0.0f ? tmin : 0.0f;
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= best;
}

template <bool kExact>
__device__ __forceinline__ bool slab_at(const Ray& r, const float* lo, const float* hi,
                                        float best, float* entry) {
  return slab_box<kExact>(r, __ldg(lo), __ldg(lo + 1), __ldg(lo + 2), __ldg(hi),
                          __ldg(hi + 1), __ldg(hi + 2), best, entry);
}

// The warp's key of a box: the smallest entry bits over the lanes that
// enter it (entries are >= +0, so their bits order as the floats), kNone if
// no lane does.
__device__ __forceinline__ unsigned warp_key(bool pass, float entry) {
  return __reduce_min_sync(kFull, pass ? __float_as_uint(entry) : kNone);
}

// Does any lane enter the box by its best?  (The exact test: it decides a
// visit.)
__device__ __forceinline__ bool warp_enters(const Ray& r, bool active, const float* lo,
                                            const float* hi, float best) {
  float entry;
  return __any_sync(kFull, active && slab_at<true>(r, lo, hi, best, &entry));
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

// Start copying rows 0..8 of block b into the warp's panel (row stride tbp),
// 16 bytes at a time with `vec` (tb % 4 == 0 and tri_data 16-byte aligned).
__device__ __forceinline__ void start_panel_copy(float* dst, const float* tri_data,
                                                 int b, int tb, int tbp, bool vec,
                                                 int lane) {
  const float* src = tri_data + (size_t)b * kTriRows * tb;
  if (vec) {
    const int pieces = tb / 4;
    for (int i = lane; i < kPanelRows * pieces; i += 32) {
      const int row = i / pieces, c = i - row * pieces;
      cp_async16(dst + row * tbp + c * 4, src + row * tb + c * 4);
    }
  } else {
    for (int i = lane; i < kPanelRows * tb; i += 32) {
      const int row = i / tb, k = i - row * tb;
      cp_async4(dst + row * tbp + k, src + i);
    }
  }
}

// One ray against one triangle: moller_trumbore_components of
// ops/geometry.py, operation for operation, behind the prescreen of the
// header; a hit replaces (best_t, best_slot) when it is the
// lexicographically smaller.  best_k = fl(best_t * kSlack).
template <bool kCount>
__device__ __forceinline__ void mt_test(const Ray& r, float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z, float e2x,
                                        float e2y, float e2z, int slot, float& best_t,
                                        int& best_slot, float& best_k, unsigned (&passed)[4]) {
  const float px = __fsub_rn(__fmul_rn(r.dy, e2z), __fmul_rn(r.dz, e2y));
  const float py = __fsub_rn(__fmul_rn(r.dz, e2x), __fmul_rn(r.dx, e2z));
  const float pz = __fsub_rn(__fmul_rn(r.dx, e2y), __fmul_rn(r.dy, e2x));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)),
                              __fmul_rn(e1z, pz));
  const float ad = fabsf(det);
  if (!(ad > kMtEps)) return;  // the exact determinant guard
  if (kCount) ++passed[0];
  // A numerator with det's sign taken off has the sign of its quotient.
  const unsigned dsign = __float_as_uint(det) & 0x80000000u;
  const float bary_thr = __fmul_rn(ad, kBaryK);
  const float tx = __fsub_rn(r.ox, v0x);
  const float ty = __fsub_rn(r.oy, v0y);
  const float tz = __fsub_rn(r.oz, v0z);
  const float un =
      __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)), __fmul_rn(tz, pz));
  const float su = __uint_as_float(__float_as_uint(un) ^ dsign);
  if (-su > bary_thr) return;  // u < -1e-7
  if (kCount) ++passed[1];
  const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
  const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
  const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
  const float vn = __fadd_rn(__fadd_rn(__fmul_rn(r.dx, qx), __fmul_rn(r.dy, qy)),
                             __fmul_rn(r.dz, qz));
  const float sv = __uint_as_float(__float_as_uint(vn) ^ dsign);
  if (-sv > bary_thr) return;  // v < -1e-7
  if (kCount) ++passed[2];
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                              __fmul_rn(e2z, qz));
  const float sn = __uint_as_float(__float_as_uint(num) ^ dsign);
  if (!(sn > 0.0f) || sn > __fmul_rn(ad, best_k)) return;  // t <= 0, or t > best
  if (kCount) ++passed[3];
  const float inv_det = __fdiv_rn(1.0f, det);
  const float u = __fmul_rn(un, inv_det);
  const float v = __fmul_rn(vn, inv_det);
  const float t = __fmul_rn(num, inv_det);
  if (u >= kBaryLo && v >= kBaryLo && __fadd_rn(u, v) <= kBaryHi && t > kTMin &&
      (t < best_t || (t == best_t && slot < best_slot))) {
    best_t = t;
    best_slot = slot;
    best_k = __fmul_rn(t, kSlack);
  }
}

// The lane's ray against the panel of one leaf block (slot0 = block * TB),
// four triangles per step from one float4 of each row.
template <bool kCount>
__device__ __forceinline__ void test_panel(const Ray& r, const float* pn, int tbp, int slot0,
                                           float& best_t, int& best_slot, float& best_k,
                                           unsigned (&passed)[4]) {
#pragma unroll 1
  for (int k = 0; k < tbp; k += 4) {
    float4 c[kPanelRows];
#pragma unroll
    for (int row = 0; row < kPanelRows; ++row) {
      c[row] = *reinterpret_cast<const float4*>(pn + row * tbp + k);
    }
#define MT_LANE(F, J)                                                                  \
  mt_test<kCount>(r, c[0].F, c[1].F, c[2].F, c[3].F, c[4].F, c[5].F, c[6].F, c[7].F,  \
                  c[8].F, slot0 + k + J, best_t, best_slot, best_k, passed)
    MT_LANE(x, 0);
    MT_LANE(y, 1);
    MT_LANE(z, 2);
    MT_LANE(w, 3);
#undef MT_LANE
  }
}

// Where a warp is in its near-to-far walk.  List position p of the supers
// being walked is register p / 32 of lane p % 32 (its key) and sup[p] (its
// index, in the warp's shared slice).
struct Walker {
  unsigned list[kListRegs];
  int* sup;
  int n_list;     // positions filled since the last refill
  int scan;       // next super to slab-test when the list runs out
  int s_cur;      // super being walked, -1 for none
  int c0;         // first leaf (within s_cur) of the keyed 32-leaf round
  unsigned leaf_key;  // lane j: key of leaf c0 + j
};

struct Scene {
  const float *block_lo, *block_hi, *super_lo, *super_hi;
  int nb, ns, sf;
  int mf;             // supers per mega box
  const float* mega;  // (ceil(ns / mf), 6) lo and hi of each mega box, in shared memory
};

// Key the leaves c0 .. c0 + 31 of super s_cur.
__device__ __forceinline__ void key_leaves(Walker& w, const Scene& sc, const Ray& r,
                                           bool active, float best, int lane) {
  w.leaf_key = kNone;
  const int base = w.s_cur * sc.sf + w.c0;
  const int n = min(32, min(sc.sf - w.c0, sc.nb - base));
  for (int j = 0; j < n; ++j) {
    float entry = 0.0f;
    const int b = base + j;
    const bool pass =
        active && slab_at<false>(r, sc.block_lo + 3 * b, sc.block_hi + 3 * b, best, &entry);
    const unsigned key = warp_key(pass, entry);
    if (lane == j && key != kNone) w.leaf_key = (key & ~31u) | (unsigned)j;
  }
}

// The next leaf block the warp visits, nearest first, or -1 when no lane can
// enter any block left.  `best` is the lane's running best.
template <bool kCount>
__device__ int next_leaf(Walker& w, const Scene& sc, const Ray& r, bool active, float best,
                         int lane, unsigned long long& super_visits) {
  // Keys are entry bits with low bits replaced, never above the entry's own
  // bits: a key above every lane's best cannot be entered by any lane.
  const unsigned max_best = __reduce_max_sync(kFull, active ? __float_as_uint(best) : 0u);
  while (true) {
    if (w.s_cur >= 0) {
      while (true) {
        const unsigned key = __reduce_min_sync(kFull, w.leaf_key);
        if (key == kNone || (key & ~31u) > max_best) break;
        const int j = (int)(key & 31u);
        if (lane == j) w.leaf_key = kNone;
        const int b = w.s_cur * sc.sf + w.c0 + j;
        if (warp_enters(r, active, sc.block_lo + 3 * b, sc.block_hi + 3 * b, best)) return b;
      }
      w.c0 += 32;
      if (w.c0 < sc.sf && w.s_cur * sc.sf + w.c0 < sc.nb) {
        key_leaves(w, sc, r, active, best, lane);
        continue;
      }
      w.s_cur = -1;
    }
    unsigned mine = kNone;
#pragma unroll
    for (int i = 0; i < kListRegs; ++i) mine = min(mine, w.list[i]);
    const unsigned key = __reduce_min_sync(kFull, mine);
    if (key != kNone && (key & ~(unsigned)(kListCap - 1)) <= max_best) {
      const int p = (int)(key & (unsigned)(kListCap - 1));
#pragma unroll
      for (int i = 0; i < kListRegs; ++i) {
        if (i == p / 32 && lane == p % 32) w.list[i] = kNone;
      }
      const int s = w.sup[p];
      if (warp_enters(r, active, sc.super_lo + 3 * s, sc.super_hi + 3 * s, best)) {
        if (kCount) ++super_visits;
        w.s_cur = s;
        w.c0 = 0;
        key_leaves(w, sc, r, active, best, lane);
      }
      continue;
    }
    // Nothing listed can be entered: list the next supers the warp enters.
    if (w.scan >= sc.ns) return -1;
#pragma unroll
    for (int i = 0; i < kListRegs; ++i) w.list[i] = kNone;
    w.n_list = 0;
    __syncwarp();  // every lane has read sup[] before it is rewritten
    for (; w.scan < sc.ns && w.n_list < kListCap; ++w.scan) {
      float entry = 0.0f;
      const int s = w.scan;
      if (s % sc.mf == 0) {  // the first super of a mega box: skip them all if no lane enters it
        const float* m = sc.mega + 6 * (s / sc.mf);
        if (!__any_sync(kFull, active && slab_box<false>(r, m[0], m[1], m[2], m[3], m[4],
                                                           m[5], best, &entry))) {
          w.scan += sc.mf - 1;
          continue;
        }
      }
      const bool pass =
          active && slab_at<false>(r, sc.super_lo + 3 * s, sc.super_hi + 3 * s, best, &entry);
      const unsigned k = warp_key(pass, entry);
      if (k == kNone) continue;
      const int p = w.n_list++;
#pragma unroll
      for (int i = 0; i < kListRegs; ++i) {
        if (i == p / 32 && lane == p % 32) {
          w.list[i] = (k & ~(unsigned)(kListCap - 1)) | (unsigned)p;
        }
      }
      if (lane == 0) w.sup[p] = s;
    }
    __syncwarp();  // sup[] is written before it is read
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kWarps * 32)
raycast_culled_kernel(const float* __restrict__ origins,   // (R, 3)
                      const float* __restrict__ dirs,      // (R, 3)
                      const float* __restrict__ tri_data,  // (NB, 16, TB)
                      Scene sc,                            // (NB, 3) and (NS, 3) boxes
                      float* __restrict__ t_out,           // (R)
                      int* __restrict__ slot_out,          // (R)
                      unsigned long long* __restrict__ counts,  // (7), counting only
                      int n_rays, int tb, int vec, float t_init) {
  // Per warp: two panels of kPanelRows x tbp floats, then (after all warps'
  // panels) kListCap super indices.
  extern __shared__ __align__(16) float smem[];
  // The block's mega boxes: unions of mf consecutive supers (their NaN
  // padding dropped), so a warp skips a region with one slab test.
  __shared__ float mega[kMaxMegas * 6];
  const int n_mega = (sc.ns + sc.mf - 1) / sc.mf;
  for (int m = threadIdx.x; m < n_mega; m += blockDim.x) {
    float box[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) box[i] = __int_as_float(0x7fc00000);
    for (int s = m * sc.mf; s < min(sc.ns, (m + 1) * sc.mf); ++s) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        box[i] = fminf(box[i], __ldg(sc.super_lo + 3 * s + i));
        box[3 + i] = fmaxf(box[3 + i], __ldg(sc.super_hi + 3 * s + i));
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) mega[6 * m + i] = box[i];
  }
  __syncthreads();
  sc.mega = mega;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tbp = (tb + 3) & ~3;
  const int panel = kPanelRows * tbp;
  float* panels = smem + (size_t)warp * 2 * panel;
  const long long first = ((long long)blockIdx.x * kWarps + warp) * kGroup;
  if (first >= n_rays) return;  // the whole warp
  const long long ray = first + lane;
  const bool active = ray < n_rays;
  Ray r = {};
  if (active) {
    r.ox = origins[ray * 3 + 0];
    r.oy = origins[ray * 3 + 1];
    r.oz = origins[ray * 3 + 2];
    r.dx = dirs[ray * 3 + 0];
    r.dy = dirs[ray * 3 + 1];
    r.dz = dirs[ray * 3 + 2];
    r.ix = __fdiv_rn(1.0f, r.dx);
    r.iy = __fdiv_rn(1.0f, r.dy);
    r.iz = __fdiv_rn(1.0f, r.dz);
  }
  // Columns tb .. tbp - 1 of both panels stay NaN: det is NaN, never a hit.
  const int pad = tbp - tb;
  for (int i = lane; i < 2 * kPanelRows * pad; i += 32) {
    panels[(i / pad) * tbp + tb + i % pad] = __int_as_float(0x7fc00000);
  }

  Walker w;
#pragma unroll
  for (int i = 0; i < kListRegs; ++i) w.list[i] = kNone;
  w.sup = reinterpret_cast<int*>(smem + (size_t)kWarps * 2 * panel) + warp * kListCap;
  w.n_list = 0;
  w.scan = 0;
  w.s_cur = -1;
  w.c0 = 0;
  w.leaf_key = kNone;
  float best_t = t_init;
  float best_k = __fmul_rn(t_init, kSlack);
  int best_slot = -1;
  unsigned long long visits = 0, tests = 0, super_visits = 0;
  unsigned passed[4] = {0, 0, 0, 0};  // counting: tests past det, u, v and t
  const unsigned active_lanes = __popc(__ballot_sync(kFull, active));
  __syncwarp();

  int cur = next_leaf<kCount>(w, sc, r, active, best_t, lane, super_visits);
  if (cur >= 0) start_panel_copy(panels, tri_data, cur, tb, tbp, vec, lane);
  cp_async_commit();
  int buf = 0;
  while (cur >= 0) {
    // The next leaf, chosen with the bests before this panel's test, loads
    // while this panel is tested.
    int nxt = next_leaf<kCount>(w, sc, r, active, best_t, lane, super_visits);
    if (nxt >= 0) start_panel_copy(panels + (buf ^ 1) * panel, tri_data, nxt, tb, tbp, vec, lane);
    cp_async_commit();
    cp_async_wait<1>();  // cur's panel has landed
    __syncwarp();
    if (kCount) {
      ++visits;
      tests += (unsigned long long)active_lanes * tb;
    }
    if (active) {
      test_panel<kCount>(r, panels + buf * panel, tbp, cur * tb, best_t, best_slot, best_k,
                         passed);
    }
    __syncwarp();  // every lane is done with this panel before it is refilled
    if (nxt >= 0 && !warp_enters(r, active, sc.block_lo + 3 * nxt, sc.block_hi + 3 * nxt,
                                 best_t)) {
      // The test moved every lane's best before the prefetched block: drop it.
      cp_async_wait<0>();
      __syncwarp();
      nxt = next_leaf<kCount>(w, sc, r, active, best_t, lane, super_visits);
      if (nxt >= 0) start_panel_copy(panels + (buf ^ 1) * panel, tri_data, nxt, tb, tbp, vec, lane);
      cp_async_commit();
    }
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  if (active) {
    t_out[ray] = best_slot >= 0 ? best_t : INFINITY;
    slot_out[ray] = best_slot;
  }
  if (kCount) {
    unsigned long long warp_passed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) warp_passed[i] = __reduce_add_sync(kFull, passed[i]);
    if (lane == 0) {
      atomicAdd(counts + 0, visits);
      atomicAdd(counts + 1, tests);
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicAdd(counts + 2 + i, warp_passed[i]);
      atomicAdd(counts + 6, super_visits);
    }
  }
}

template <bool kCount>
int launch(const void* origins, const void* dirs, const void* tri_data, const void* block_lo,
           const void* block_hi, const void* super_lo, const void* super_hi, void* t_out,
           void* slot_out, void* counts, int n_rays, int nb, int ns, int sf, int tb,
           float t_init, void* stream) {
  if (n_rays <= 0 || tb <= 0 || sf <= 0 || nb <= 0 || ns <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tbp = (tb + 3) & ~3;
  const size_t smem = (size_t)kWarps * (2 * kPanelRows * tbp * sizeof(float) +
                                        kListCap * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raycast_culled_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = tb % 4 == 0 && (uintptr_t)tri_data % 16 == 0;
  const int fit = (ns + kMaxMegas - 1) / kMaxMegas;  // supers per box for kMaxMegas boxes
  const int mega_factor = fit > kMegaFactor ? fit : kMegaFactor;
  const Scene sc = {(const float*)block_lo, (const float*)block_hi, (const float*)super_lo,
                    (const float*)super_hi, nb, ns, sf,
                    mega_factor, nullptr};
  const long long warps = ((long long)n_rays + kGroup - 1) / kGroup;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  raycast_culled_kernel<kCount><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)tri_data, sc, (float*)t_out,
      (int*)slot_out, (unsigned long long*)counts, n_rays, tb, vec, t_init);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() right after the launch.
int raycast_culled_launch(const void* origins, const void* dirs,
                          const void* tri_data, const void* block_lo,
                          const void* block_hi, const void* super_lo,
                          const void* super_hi, void* t_out, void* slot_out,
                          int n_rays, int nb, int ns, int sf, int tb,
                          float t_init, void* stream) {
  return launch<false>(origins, dirs, tri_data, block_lo, block_hi, super_lo, super_hi, t_out,
                       slot_out, nullptr, n_rays, nb, ns, sf, tb, t_init, stream);
}

// The counting instantiation: the same result, and `counts` (7 zeroed
// uint64) gains the warp visits of leaf blocks, the tests of active lanes,
// the prescreen's survivors and the warp visits of supers.
int raycast_culled_count_launch(const void* origins, const void* dirs,
                                const void* tri_data, const void* block_lo,
                                const void* block_hi, const void* super_lo,
                                const void* super_hi, void* t_out, void* slot_out,
                                void* counts, int n_rays, int nb, int ns, int sf, int tb,
                                float t_init, void* stream) {
  return launch<true>(origins, dirs, tri_data, block_lo, block_hi, super_lo, super_hi, t_out,
                      slot_out, counts, n_rays, nb, ns, sf, tb, t_init, stream);
}

const char* raycast_culled_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
