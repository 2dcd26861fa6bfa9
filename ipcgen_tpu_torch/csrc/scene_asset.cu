// The scene asset's build (ops/scene_asset.py) on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds the asset in host numpy
// (ipcgen_tpu/ops/scene_asset.py build_scene_asset, :138-265), and so did the
// port (ops/scene_asset.py build_scene_arrays, which stays as the reference).
// On a 1.4 M-triangle room that build took 1.25-1.72 s of host CPU and
// uploaded about 151 MB from pageable memory, while the card sat idle.  Here
// the host uploads only the float32 vertices and int32 triangles (about 26 MB)
// and the card builds the arrays, bit for bit those of build_scene_arrays.
//
// Three steps, two launches from the host (ops/_kernels.py):
//
//   scene_codes_launch: centroid_kernel gathers each triangle's corners,
//     writes its centroid ((c0 + c1) + c2) / 3 (numpy's order for
//     corners.mean(axis=1)) and folds the centroids' per-axis minimum and
//     maximum into six ordered keys with one atomic a block; morton_kernel
//     turns each centroid into the 30-bit Morton code of
//     native/ipcgen_native.cc morton_order: (p - lo) * inv_extent, clamped to
//     [0, 1], times 1023, truncated.  lo, extent = max(hi - lo, 1e-9) and
//     inv_extent = 1 / extent are computed from the keys on the card, in the
//     float32 steps that utils/native.py takes in numpy, so nothing is read
//     back to the host.
//   torch.sort(codes, stable=True) between the two: ties keep their input
//     order, as std::stable_sort keeps it.
//   scene_pack_launch: pack_kernel, one CUDA block per leaf block of TB
//     triangles, lane = thread; each thread gathers its sorted triangle's
//     corners and writes its column of tri_data (rows 0-8: v0, e1, e2; rows
//     9-15 zero; coalesced across the warp), tri_index (-1 for a padded slot,
//     whose corners are kPadCoord), the unit normal cross(e1, e2) /
//     max(|.|, 1e-20) and tri_fin; the block then reduces its leaf AABB over
//     real triangles with warp shuffles, widens it by eps, and writes NaN boxes
//     for a block with no real triangle.  supers_kernel, one thread per (super
//     block, axis), takes the NaN-aware minimum and maximum of its
//     super_factor leaf boxes (np.nanmin / np.nanmax).
//
// Bit equality with numpy: every difference, product, sum, quotient and
// square root is rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn; the source is also built with -fmad=false); the
// norm sums its squares as numpy's linalg.norm does, (x x + y y) + z z; the
// constants 1e-9, 1e-5 and 1e-20 are the double literals rounded to float32,
// as numpy rounds Python floats.  Minima and maxima are exact.  A -0.0 that
// a minimum may return in place of +0.0 never reaches an output: the centroid
// bounds enter only through differences with other values and the extent,
// and every leaf bound is widened by eps > 0.
//
// What bounds it: bytes.  About 151 MB written a room (tri_data 100.7 MB,
// tri_fin 25.2, tri_normal 18.9, tri_index 6.3) plus the gathers (the
// triangles' 12 bytes and their corners' 36 a triangle, twice, and the
// centroids written and read once): about 250 MB, some 75 us at 3.35 TB/s.
// The writes are whole coalesced rows (tri_data's lanes are the block's
// threads; tri_fin is one 16-byte store a thread); the gathers are the
// Morton-sorted corners of neighbouring triangles, so a warp's corners mostly
// share cache lines in L2.  The two grid reductions are one shared-memory
// reduction and six atomics a block.
//
// The kernels launch on the caller's stream, never synchronise and allocate
// nothing.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodeThreads = 256;
constexpr int kCodeBlocksPerSm = 4;
constexpr int kMaxLeaf = 1024;  // triangles a leaf block, at most
// A padded triangle's corners (ops/scene_asset.py _PAD_COORD).
constexpr float kPadCoord = 1e7f;

__device__ __forceinline__ float f32_of(double x) { return static_cast<float>(x); }

// Float -> unsigned key whose unsigned order is the floats' order (NaN aside).
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Spread the low 10 bits of v so that bit i lands on bit 3 i.
__device__ __forceinline__ unsigned spread10(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// extent[k] = max(hi - lo, 1e-9) of the centroids' bounds (keys[0..2] the
// minima, keys[3..5] the maxima), as utils/native.py morton_order and
// build_scene_arrays compute it.
__device__ __forceinline__ void centroid_bounds(const unsigned* __restrict__ keys, float lo[3],
                                                float extent[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = key_float(keys[k]);
    extent[k] = fmaxf(__fsub_rn(key_float(keys[3 + k]), lo[k]), f32_of(1e-9));
  }
}

__device__ __forceinline__ void load_corners(const float* __restrict__ verts,
                                             const int* __restrict__ tris, long long t,
                                             float c[3][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const long long v = tris[3 * t + j];
#pragma unroll
    for (int k = 0; k < 3; ++k) c[j][k] = verts[3 * v + k];
  }
}

template <typename Op>
__device__ __forceinline__ float warp_reduce(float x, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Grid-stride over the n triangles: centroids (n, 3) and the six bound keys
// (keys[0..2] start at 0xffffffff, keys[3..5] at 0).
__global__ void __launch_bounds__(kCodeThreads)
centroid_kernel(const float* __restrict__ verts, const int* __restrict__ tris,
                float* __restrict__ centroids, unsigned* __restrict__ keys, int n) {
  const float kInf = __int_as_float(0x7f800000);
  float lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
  for (int i = blockIdx.x * kCodeThreads + threadIdx.x; i < n; i += gridDim.x * kCodeThreads) {
    float c[3][3];
    load_corners(verts, tris, i, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float m = __fdiv_rn(__fadd_rn(__fadd_rn(c[0][k], c[1][k]), c[2][k]), 3.0f);
      centroids[3 * (size_t)i + k] = m;
      lo[k] = fminf(lo[k], m);
      hi[k] = fmaxf(hi[k], m);
    }
  }
  __shared__ float part[6][kCodeThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = warp_reduce(lo[k], MinOp()), b = warp_reduce(hi[k], MaxOp());
    if (lane == 0) {
      part[k][warp] = a;
      part[3 + k][warp] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float x = part[k][0];
    for (int w = 1; w < kCodeThreads / 32; ++w) x = k < 3 ? fminf(x, part[k][w]) : fmaxf(x, part[k][w]);
    if (k < 3) {
      if (x < kInf) atomicMin(keys + k, ordered_key(x));
    } else if (x > -kInf) {
      atomicMax(keys + k, ordered_key(x));
    }
  }
}

// codes (n,) int32: the Morton code of each centroid on a 2^bits grid.
__global__ void __launch_bounds__(kCodeThreads)
morton_kernel(const float* __restrict__ centroids, const unsigned* __restrict__ keys,
              int* __restrict__ codes, int n, int bits) {
  float lo[3], extent[3], inv[3];
  centroid_bounds(keys, lo, extent);
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = __fdiv_rn(1.0f, extent[k]);
  const unsigned scale = (1u << bits) - 1u;
  const float fscale = static_cast<float>(scale);
  for (int i = blockIdx.x * kCodeThreads + threadIdx.x; i < n; i += gridDim.x * kCodeThreads) {
    unsigned q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float t = __fmul_rn(__fsub_rn(centroids[3 * (size_t)i + k], lo[k]), inv[k]);
      if (t < 0.f) t = 0.f;
      if (t > 1.f) t = 1.f;
      q[k] = min(static_cast<unsigned>(__fmul_rn(t, fscale)), scale);
    }
    codes[i] = static_cast<int>(spread10(q[0]) | (spread10(q[1]) << 1) | (spread10(q[2]) << 2));
  }
}

// One CUDA block (blockDim.x = TB rounded up to 32) per leaf block b.
__global__ void __launch_bounds__(kMaxLeaf)
pack_kernel(const float* __restrict__ verts, const int* __restrict__ tris,
            const long long* __restrict__ order, const unsigned* __restrict__ keys,
            float* __restrict__ tri_data, int* __restrict__ tri_index,
            float* __restrict__ tri_normal, float4* __restrict__ tri_fin,
            float* __restrict__ block_lo, float* __restrict__ block_hi, int n_tris, int tb) {
  const float kInf = __int_as_float(0x7f800000);
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long slot = (long long)b * tb + lane;
  const bool live = lane < tb;
  const bool real = live && slot < n_tris;
  float c[3][3];
  int idx = -1;
  if (real) {
    const long long t = order[slot];
    idx = static_cast<int>(t);
    load_corners(verts, tris, t, c);
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) c[j][k] = kPadCoord;
  }
  if (live) {
    float e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e1[k] = __fsub_rn(c[1][k], c[0][k]);
      e2[k] = __fsub_rn(c[2][k], c[0][k]);
    }
    float* col = tri_data + (size_t)b * 16 * tb + lane;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      col[(size_t)k * tb] = c[0][k];
      col[(size_t)(3 + k) * tb] = e1[k];
      col[(size_t)(6 + k) * tb] = e2[k];
    }
#pragma unroll
    for (int r = 9; r < 16; ++r) col[(size_t)r * tb] = 0.0f;
    // numpy's cross: a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0.
    const float n0 = __fsub_rn(__fmul_rn(e1[1], e2[2]), __fmul_rn(e1[2], e2[1]));
    const float n1 = __fsub_rn(__fmul_rn(e1[2], e2[0]), __fmul_rn(e1[0], e2[2]));
    const float n2 = __fsub_rn(__fmul_rn(e1[0], e2[1]), __fmul_rn(e1[1], e2[0]));
    const float norm = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(n0, n0), __fmul_rn(n1, n1)), __fmul_rn(n2, n2)));
    const float d = fmaxf(norm, f32_of(1e-20));
    const float u0 = __fdiv_rn(n0, d), u1 = __fdiv_rn(n1, d), u2 = __fdiv_rn(n2, d);
    tri_index[slot] = idx;
    tri_normal[3 * slot] = u0;
    tri_normal[3 * slot + 1] = u1;
    tri_normal[3 * slot + 2] = u2;
    tri_fin[slot] = make_float4(u0, u1, u2, __int_as_float(idx));
  }

  // The leaf AABB over real triangles only.
  __shared__ float part[6][kMaxLeaf / 32];
  const int warp = lane >> 5, wl = lane & 31, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = real ? fminf(fminf(c[0][k], c[1][k]), c[2][k]) : kInf;
    const float hi = real ? fmaxf(fmaxf(c[0][k], c[1][k]), c[2][k]) : -kInf;
    const float a = warp_reduce(lo, MinOp()), h = warp_reduce(hi, MaxOp());
    if (wl == 0) {
      part[k][warp] = a;
      part[3 + k][warp] = h;
    }
  }
  __syncthreads();
  if (lane < 6) {
    const int k = lane;
    float x = part[k][0];
    for (int w = 1; w < n_warps; ++w) x = k < 3 ? fminf(x, part[k][w]) : fmaxf(x, part[k][w]);
    const bool empty = (long long)b * tb >= n_tris;
    float lo3[3], extent[3];
    centroid_bounds(keys, lo3, extent);
    const float emax = fmaxf(fmaxf(extent[0], extent[1]), extent[2]);
    const float eps = __fmul_rn(f32_of(1e-5), fmaxf(emax, 1.0f));
    const float nan = __int_as_float(0x7fc00000);
    if (k < 3) {
      block_lo[3 * b + k] = empty ? nan : __fsub_rn(x, eps);
    } else {
      block_hi[3 * b + k - 3] = empty ? nan : __fadd_rn(x, eps);
    }
  }
}

// One thread per (super block, axis): the NaN-aware minimum and maximum of
// its leaf boxes; NaN where all of them are NaN.
__global__ void supers_kernel(const float* __restrict__ block_lo, const float* __restrict__ block_hi,
                              float* __restrict__ super_lo, float* __restrict__ super_hi, int nb,
                              int ns, int sf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * ns) return;
  const int s = i / 3, k = i % 3;
  const float nan = __int_as_float(0x7fc00000);
  float lo = nan, hi = nan;
  const int end = min(nb, (s + 1) * sf);
  for (int j = s * sf; j < end; ++j) {
    const float a = block_lo[3 * j + k], h = block_hi[3 * j + k];
    if (!isnan(a)) lo = isnan(lo) ? a : fminf(lo, a);
    if (!isnan(h)) hi = isnan(hi) ? h : fmaxf(hi, h);
  }
  super_lo[i] = lo;
  super_hi[i] = hi;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the first error.  verts (V, 3) float32, tris
// (n, 3) int32 with every index in [0, V); centroids (n, 3) float32 and keys
// (6,) uint32 scratch; codes (n,) int32 out.  1 <= bits <= 10.
int scene_codes_launch(const void* verts, const void* tris, void* centroids, void* keys,
                       void* codes, int n, int bits, int sms, void* stream) {
  if (n <= 0 || bits < 1 || bits > 10 || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(keys, 0xff, 3 * sizeof(unsigned), s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync((unsigned*)keys + 3, 0, 3 * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = min((n + kCodeThreads - 1) / kCodeThreads, kCodeBlocksPerSm * sms);
  centroid_kernel<<<blocks, kCodeThreads, 0, s>>>((const float*)verts, (const int*)tris,
                                                  (float*)centroids, (unsigned*)keys, n);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  morton_kernel<<<(n + kCodeThreads - 1) / kCodeThreads, kCodeThreads, 0, s>>>(
      (const float*)centroids, (const unsigned*)keys, (int*)codes, n, bits);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the first error.  order (n,) int64, a
// permutation of [0, n); keys from scene_codes_launch; tri_data (nb, 16, tb),
// tri_index (nb tb,), tri_normal (nb tb, 3), tri_fin (nb tb, 4) 16-byte
// aligned, block_lo / block_hi (nb, 3), super_lo / super_hi (ns, 3) out;
// nb tb >= n, ns sf >= nb, 1 <= tb <= 1024.
int scene_pack_launch(const void* verts, const void* tris, const void* order, const void* keys,
                      void* tri_data, void* tri_index, void* tri_normal, void* tri_fin,
                      void* block_lo, void* block_hi, void* super_lo, void* super_hi, int n,
                      int nb, int tb, int ns, int sf, void* stream) {
  if (n <= 0 || tb < 1 || tb > kMaxLeaf || nb <= 0 || (long long)nb * tb < n || sf <= 0 ||
      ns <= 0 || (long long)ns * sf < nb || (uintptr_t)tri_fin % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = (tb + 31) / 32 * 32;
  pack_kernel<<<nb, threads, 0, s>>>(
      (const float*)verts, (const int*)tris, (const long long*)order, (const unsigned*)keys,
      (float*)tri_data, (int*)tri_index, (float*)tri_normal, (float4*)tri_fin,
      (float*)block_lo, (float*)block_hi, n, tb);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  supers_kernel<<<(3 * ns + 255) / 256, 256, 0, s>>>((const float*)block_lo,
                                                      (const float*)block_hi, (float*)super_lo,
                                                      (float*)super_hi, nb, ns, sf);
  return (int)cudaGetLastError();
}

const char* scene_asset_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
