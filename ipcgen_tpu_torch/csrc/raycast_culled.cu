// Two-level AABB-culled Moller-Trumbore raycast for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _raycast_kernel of
// ipcgen_tpu/ops/raycast_pallas.py (:41-115, launched at :138).  It computes
// the same function: for each ray, walk the super blocks in ascending order,
// slab-test each against the ray's running best t, inside a surviving super
// slab-test each of its leaf blocks, and run Moller-Trumbore against the TB
// triangles of every surviving leaf block.  The plain PyTorch version of the
// same function is raycast_culled_plain in ipcgen_tpu_torch/ops/raycast_culled.py.
//
// Layout here: one thread per ray, a CUDA block of kGroup = 256 consecutive
// rays in place of the TPU's 1024-ray tile (the plain version groups its rays
// by GROUP in ops/raycast_culled.py, the same number).  A block visits a super
// or leaf block when any of its rays passes the slab test (__syncthreads_or),
// so control flow stays uniform per CUDA block; a visited leaf block's
// (9, TB) panel (v0, e1, e2 components; 4.6 KB at TB = 128) is staged in
// shared memory and every thread runs Moller-Trumbore over its TB triangles.
// A ray's result does not depend on the group: a block is skipped only when
// none of the group's rays can enter its eps-padded AABB before its current
// best, and a ray that cannot enter it cannot hit a triangle in it.
//
// What bounds it on the card: about 40 fp32 operations and one IEEE divide per
// (ray, triangle) of a visited block, with the 9 coefficients read from shared
// memory as warp-wide broadcasts.  It is bound by fp32 instruction throughput
// (the products cannot be fused into FMAs, see below), not by device memory:
// each panel is read once per group of kGroup rays.  wgmma, TMA panel rings and
// persistent blocks are later work.
//
// Bit-exactness against the block-scan oracle (raycast_asset_xla in
// ops/raycast.py) and the plain version:
//  - every product, sum and difference is written with __fmul_rn, __fadd_rn
//    and __fsub_rn, which nvcc never contracts into FMAs, in the association
//    of moller_trumbore_components (ops/geometry.py); the source is also
//    built with -fmad=false (ops/_kernels.py);
//  - 1/det and 1/d are IEEE divides (__fdiv_rn): a zero direction component
//    gives +-inf as in torch;
//  - the slab test fails whenever one of its six slab distances is NaN (a
//    NaN-padded AABB, or (lo - o) * inf with o on the slab plane), as the
//    NaN-propagating torch.minimum/maximum/clamp make it fail;
//  - the running best starts at (t_init, -1), t_init = t_max or FLT_MAX, and a
//    hit must be strictly nearer: a hit at exactly t_max is dropped, and ties
//    go to the smallest packed slot because blocks and lanes are visited in
//    ascending order.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;       // rays per CUDA block, one per thread
constexpr int kPanelRows = 9;      // v0, e1, e2 components of tri_data rows 0..8
constexpr int kTriRows = 16;       // rows per tri_data block
constexpr float kMtEps = 1e-9f;    // determinant guard (MT_EPS)
constexpr float kBaryLo = -1e-7f;  // -BARY_EPS
constexpr float kBaryHi = (float)(1.0 + 1e-7);  // 1 + BARY_EPS, rounded once
constexpr float kTMin = 1e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// ray_aabb_hit of ops/geometry.py: does [0, best] of the ray enter (lo, hi)?
__device__ __forceinline__ bool slab_hit(const Ray& r, const float* lo,
                                         const float* hi, float best) {
  const float t1x = __fmul_rn(__fsub_rn(lo[0], r.ox), r.ix);
  const float t2x = __fmul_rn(__fsub_rn(hi[0], r.ox), r.ix);
  const float t1y = __fmul_rn(__fsub_rn(lo[1], r.oy), r.iy);
  const float t2y = __fmul_rn(__fsub_rn(hi[1], r.oy), r.iy);
  const float t1z = __fmul_rn(__fsub_rn(lo[2], r.oz), r.iz);
  const float t2z = __fmul_rn(__fsub_rn(hi[2], r.oz), r.iz);
  if (isnan(t1x) || isnan(t2x) || isnan(t1y) || isnan(t2y) || isnan(t1z) ||
      isnan(t2z)) {
    return false;
  }
  const float tmin =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax =
      fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return tmax >= fmaxf(tmin, 0.0f) && tmin < best;
}

// moller_trumbore_components of ops/geometry.py; +inf on a miss.
__device__ __forceinline__ float moller_trumbore(const Ray& r, const float* c,
                                                 int tb) {
  const float v0x = c[0], v0y = c[tb], v0z = c[2 * tb];
  const float e1x = c[3 * tb], e1y = c[4 * tb], e1z = c[5 * tb];
  const float e2x = c[6 * tb], e2y = c[7 * tb], e2z = c[8 * tb];
  const float px = __fsub_rn(__fmul_rn(r.dy, e2z), __fmul_rn(r.dz, e2y));
  const float py = __fsub_rn(__fmul_rn(r.dz, e2x), __fmul_rn(r.dx, e2z));
  const float pz = __fsub_rn(__fmul_rn(r.dx, e2y), __fmul_rn(r.dy, e2x));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)),
                              __fmul_rn(e1z, pz));
  const bool ok_det = fabsf(det) > kMtEps;
  const float inv_det = ok_det ? __fdiv_rn(1.0f, det) : 0.0f;
  const float tx = __fsub_rn(r.ox, v0x);
  const float ty = __fsub_rn(r.oy, v0y);
  const float tz = __fsub_rn(r.oz, v0z);
  const float u = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)), __fmul_rn(tz, pz)),
      inv_det);
  const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
  const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
  const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
  const float v = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r.dx, qx), __fmul_rn(r.dy, qy)),
                __fmul_rn(r.dz, qz)),
      inv_det);
  const float t = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)), __fmul_rn(e2z, qz)),
      inv_det);
  const bool hit = ok_det && u >= kBaryLo && v >= kBaryLo &&
                   __fadd_rn(u, v) <= kBaryHi && t > kTMin;
  return hit ? t : INFINITY;
}

__global__ void __launch_bounds__(kGroup)
raycast_culled_kernel(const float* __restrict__ origins,   // (R, 3)
                      const float* __restrict__ dirs,      // (R, 3)
                      const float* __restrict__ tri_data,  // (NB, 16, TB)
                      const float* __restrict__ block_lo,  // (NB, 3)
                      const float* __restrict__ block_hi,  // (NB, 3)
                      const float* __restrict__ super_lo,  // (NS, 3)
                      const float* __restrict__ super_hi,  // (NS, 3)
                      float* __restrict__ t_out,           // (R)
                      int* __restrict__ slot_out,          // (R)
                      int n_rays, int nb, int ns, int sf, int tb, float t_init) {
  extern __shared__ float panel[];  // kPanelRows * tb, row-major as tri_data
  const long long ray = (long long)blockIdx.x * kGroup + threadIdx.x;
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

  float best_t = t_init;
  int best_slot = -1;
  for (int s = 0; s < ns; ++s) {
    const bool hs = active && slab_hit(r, super_lo + 3 * s, super_hi + 3 * s, best_t);
    if (!__syncthreads_or(hs)) continue;
    for (int j = 0; j < sf; ++j) {
      const int b = s * sf + j;
      if (b >= nb) break;  // past the last block: NaN padding in the TPU layout
      const bool hb = active && slab_hit(r, block_lo + 3 * b, block_hi + 3 * b, best_t);
      // Also orders the previous panel's reads before this block's staging.
      if (!__syncthreads_or(hb)) continue;
      const float* src = tri_data + (size_t)b * kTriRows * tb;
      for (int i = threadIdx.x; i < kPanelRows * tb; i += kGroup) {
        panel[i] = src[i];
      }
      __syncthreads();
      if (active) {
        for (int k = 0; k < tb; ++k) {
          const float t = moller_trumbore(r, panel + k, tb);
          if (t < best_t) {
            best_t = t;
            best_slot = b * tb + k;
          }
        }
      }
    }
  }
  if (active) {
    t_out[ray] = best_slot >= 0 ? best_t : INFINITY;
    slot_out[ray] = best_slot;
  }
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
  if (n_rays <= 0 || tb <= 0 || sf <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kPanelRows * tb * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raycast_culled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rays + kGroup - 1) / kGroup;
  raycast_culled_kernel<<<blocks, kGroup, smem, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)tri_data,
      (const float*)block_lo, (const float*)block_hi, (const float*)super_lo,
      (const float*)super_hi, (float*)t_out, (int*)slot_out, n_rays, nb, ns,
      sf, tb, t_init);
  return (int)cudaGetLastError();
}

const char* raycast_culled_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
