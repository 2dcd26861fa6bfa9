// Probe variants of the candidate-pair raycast for Hopper (sm_90a): where the
// time of a per-tile walk over leaf-block panels goes.
//
// Replaces the three Pallas TPU kernels of scripts/kernel_probe.py:
//   make_kernel (:119) / make_quad_kernel (:32), launched by call (:247)
//       -> probe_call_kernel<Mode>, one instance per probe mode;
//   make_grid_kernel (:342), launched by grid_call (:418)
//       -> probe_grid_kernel;
//   make_flat_kernel (:486), launched by flat_call (:555)
//       -> probe_flat_kernel.
// The plain PyTorch versions of the same functions are in
// ipcgen_tpu_torch/ops/raycast_probe.py.
//
// What they compute.  Rays come in tiles of kTile = 1024.  A tile walks a
// list of leaf blocks: call walks its candidate list ids[:counts] (every
// block when the tile overflowed), grid walks the first `cap` candidates
// (counts clamped by the caller), flat walks a flat list of (tile, block)
// pairs.  For each ray and each triangle of a walked block, the five Pluecker
// products of the port's float32 panel (ops/raycast_pairs.py build_trif,
// (NB, 10, 5*TB)) give three edge sides, t_num and t_den.  A candidate counts
// when the three side signs agree, t = t_num / t_den > 1e-6 and
// |t_den| > 1e-9 (flat: the same guards on the bit patterns, as
// kernel_probe.py:508-510).  The result is the smallest (t, slot) pair,
// slot = block * TB + lane, so ties in t go to the smallest packed slot; a
// miss returns t = t_init and slot -1 (kernel_probe.py:236-238).
//
// Modes of call (the mode argument; the order is MODES in raycast_probe.py):
//   full      the whole walk, each panel staged in shared memory in turn;
//   full4     the same with a 4-stage cp.async ring of panels;
//   recip(4)  t = t_num * r, r = rcp.approx(t_den) with one Newton step;
//   bf16      bf16 hi/lo panels (NB, 20, 5*TB), products as the 3-term split
//             f_hi*t_hi + f_hi*t_lo + f_lo*t_hi accumulated in fp32, 4 stages;
//   quad      4 panels per loop iteration, 2 stages;
//   dmaonly(4)   load floor: panels staged, each ray keeps the bit-min of one
//                coefficient (row r / 256 of its tile, lane r % TB); slot -1;
//   matmul, quadfloor   product floor: all five products, the bit-min of the
//                s0 column as t and of the other four columns as slot;
//   smallcarry4  loads only, one carried value per thread (coefficient 0 at
//                lane tid % TB) for its four rays; slot 0;
//   nodma     compute floor without loads: block 0's panel is staged once
//             and stands for every walked block (slots keep the walked ids).
//
// Layout on the card: 256 threads per CUDA block, four rays per thread (rays
// tid, tid + 256, tid + 512, tid + 768 of the tile), so each coefficient read
// from shared memory (a warp-wide broadcast) feeds four rays.  The per-tile
// running minimum that the TPU kept in scratch across sequential grid steps
// becomes a merge across CUDA blocks.
//
// call: a tile's walk of `trip` panels (its list, or all nb blocks when it
// overflowed) is cut into work items of at most kItemPanels (K) consecutive
// list positions: item i of a tile walks positions [i*K, min((i+1)*K, trip)),
// and a tile with trip 0 has none.  The wrapper scans the per-tile item
// counts on the device (item_offsets, (T+1,)).  The grid is persistent, as
// many blocks as are resident on the card at once; each takes the next item
// from a queue (one int32 counter, atomicAdd), finds its tile by binary
// search in item_offsets, loads the tile's 1024 rays, walks the item's panels
// through the mode's own staging (stages() x per_step() panels) and merges.
// One block per tile, as on the TPU, left a serial tail: a tile that
// overflowed walked its 1,536 panels alone, tens of milliseconds after the
// rest of the card had finished, and that tail set every mode's time.  Now
// no block walks more than K panels of one tile in one go, so the tail is at
// most one item.  Every mode's result is a minimum, so items merged by
// atomicMin give the same bits in any order: the result modes and nodma a
// 64-bit atomicMin on (t bits << 32) | slot of each hit (exact because only
// t > 0 can win; best_init / best_finalize write t_init / -1 for the
// misses); dmaonly(4) and smallcarry4 an int32 atomicMin on t's bits;
// matmul and quadfloor two, on t's and on the slot's (floor_init sets their
// start values, so the outputs keep the per-tile walk's constants).
//
// grid and flat are parallel over pairs: one CUDA block per (tile, candidate)
// step, or per chunk of kChunk consecutive pairs of the flat list, merged
// the same way as call's result modes.
//
// What bounds them on the card: per (ray, triangle) 25 fp32 FMAs (75 for
// bf16) and 25 shared-memory broadcast loads per four rays; a panel (25
// non-zero coefficient rows of 128 lanes, 12.8 KB) is read from device memory
// once per (tile, block) pair (call: once per item it belongs to, and no
// panel is in two items) and reused by 1024 rays, so they are bound by fp32
// instruction throughput, not by device memory.  wgmma for the products and
// TMA for the panels are later work.
// Build without --use_fast_math: the divide and the comparisons must be IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kTile = 1024;            // rays per tile
constexpr int kThreads = 256;          // threads per CUDA block
constexpr int kRays = kTile / kThreads;  // rays per thread
constexpr int kTB = 128;               // triangles (lanes) per leaf block
constexpr int kFeat = 10;              // ray feature rows: d(3), m(3), o(3), 1
constexpr int kCoef = 25;              // non-zero panel coefficients per lane
constexpr int kWidth = 5 * kTB;        // panel columns
constexpr int kPanelBytes = kCoef * kTB * 4;  // fp32 panel, or bf16 hi + lo
constexpr int kChunk = 8;              // flat pairs per CUDA block
constexpr int kItemPanels = 8;         // call: panels per work item (K)
constexpr int kEpsTBits = 0x358637BD;    // bits of 1e-6f
constexpr int kEpsDenBits = 0x3089705F;  // bits of 1e-9f
constexpr int kIntMax = 0x7FFFFFFF;

// probe_call_kernel's modes, in the order of MODES in ops/raycast_probe.py;
// kFlatGuards is flat's epilogue (bit-pattern guards), not a mode of call.
enum Mode {
  kFull, kFull4, kRecip, kRecip4, kBf16, kQuad, kDmaOnly, kDmaOnly4,
  kMatmul, kQuadFloor, kSmallCarry4, kNoDma, kFlatGuards
};

__host__ __device__ constexpr int stages(int m) {
  return (m == kFull4 || m == kRecip4 || m == kBf16 || m == kDmaOnly4 ||
          m == kSmallCarry4) ? 4
         : (m == kQuad || m == kQuadFloor) ? 2 : 1;
}
__host__ __device__ constexpr int per_step(int m) { return (m == kQuad || m == kQuadFloor) ? 4 : 1; }
__host__ __device__ constexpr bool product_floor(int m) { return m == kMatmul || m == kQuadFloor; }
// Modes whose per-ray result is a (t, slot) hit, merged as one 64-bit key.
__host__ __device__ constexpr bool packed_merge(int m) {
  return !(m == kDmaOnly || m == kDmaOnly4 || m == kSmallCarry4 || product_floor(m));
}
__host__ __device__ constexpr size_t smem_bytes(int m) {
  return (size_t)stages(m) * per_step(m) * kPanelBytes;
}

// Coefficient j of a lane -> (feature row, column group) of build_trif.
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying block b's 25 non-zero coefficient rows into dst,
// coefficient-major: coefficient j of lane k lands at dst[j * kTB + k].
__device__ __forceinline__ void start_panel_copy(float* dst, const float* trif, int b) {
  const float* src = trif + (size_t)b * kFeat * kWidth;
  constexpr int kChunks = kTB / 4;  // 16-byte chunks per coefficient row
  for (int i = threadIdx.x; i < kCoef * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i - j * kChunks;
    int row, grp;
    coef_source(j, &row, &grp);
    cp_async16(dst + j * kTB + c * 4, src + row * kWidth + grp * kTB + c * 4);
  }
}

// The same for bf16 panels (NB, 20, 5*TB): rows 0..9 hi, 10..19 lo; the hi
// coefficients land at dst[j * kTB + k], the lo ones kCoef * kTB further.
__device__ __forceinline__ void start_panel_copy(__nv_bfloat16* dst,
                                            const __nv_bfloat16* trif, int b) {
  const __nv_bfloat16* src = trif + (size_t)b * 2 * kFeat * kWidth;
  constexpr int kChunks = kTB / 8;
  for (int i = threadIdx.x; i < 2 * kCoef * kChunks; i += kThreads) {
    const int h = i / (kCoef * kChunks);
    const int r = i - h * kCoef * kChunks;
    const int j = r / kChunks, c = r - j * kChunks;
    int row, grp;
    coef_source(j, &row, &grp);
    cp_async16(dst + (h * kCoef + j) * kTB + c * 8,
               src + (h * kFeat + row) * kWidth + grp * kTB + c * 8);
  }
}

struct Prod {
  float s0, s1, s2, num, den;
};

// x: d(3), m(3), o(3) of one ray; c: its lane's 25 coefficients.  The FMA
// order is fixed (the plain version repeats it for the product floors).
__device__ __forceinline__ float dot6(const float* x, const float* c) {
  float a = __fmul_rn(x[0], c[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) a = __fmaf_rn(x[j], c[j], a);
  return a;
}

__device__ __forceinline__ Prod products(const float* x, const float* c) {
  Prod p;
  p.s0 = dot6(x, c);
  p.s1 = dot6(x, c + 6);
  p.s2 = dot6(x, c + 12);
  p.num = __fmaf_rn(x[8], c[20], __fmaf_rn(x[7], c[19], __fmaf_rn(x[6], c[18], c[21])));
  p.den = __fmaf_rn(x[2], c[24], __fmaf_rn(x[1], c[23], __fmul_rn(x[0], c[22])));
  return p;
}

// The bf16 3-term split: hi/lo features and hi/lo coefficients.
__device__ __forceinline__ float split_term(float acc, float xh, float xl, float ch,
                                            float cl) {
  acc = __fmaf_rn(xh, ch, acc);
  acc = __fmaf_rn(xh, cl, acc);
  return __fmaf_rn(xl, ch, acc);
}

__device__ __forceinline__ float split_dot(const float* xh, const float* xl,
                                           const float* ch, const float* cl, int n) {
  float a = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (j < n) a = split_term(a, xh[j], xl[j], ch[j], cl[j]);
  }
  return a;
}

__device__ __forceinline__ Prod products_split(const float* xh, const float* xl,
                                               const float* ch, const float* cl) {
  Prod p;
  p.s0 = split_dot(xh, xl, ch, cl, 6);
  p.s1 = split_dot(xh, xl, ch + 6, cl + 6, 6);
  p.s2 = split_dot(xh, xl, ch + 12, cl + 12, 6);
  p.num = split_term(split_dot(xh + 6, xl + 6, ch + 18, cl + 18, 3), 1.0f, 0.0f,
                     ch[21], cl[21]);
  p.den = split_dot(xh, xl, ch + 22, cl + 22, 3);
  return p;
}

// Fold one candidate into the ray's running best (key = t bits, slot).
template <int M>
__device__ __forceinline__ void consider(const Prod& p, int slot, int& bk, int& bs) {
  const int i0 = __float_as_int(p.s0), i1 = __float_as_int(p.s1);
  const int i2 = __float_as_int(p.s2);
  if (((i0 ^ i1) | (i0 ^ i2)) < 0) return;  // side signs disagree
  int key;
  if constexpr (M == kFlatGuards) {
    key = __float_as_int(__fdiv_rn(p.num, p.den));
    const int den_bits = __float_as_int(p.den) & kIntMax;
    if (!(key > kEpsTBits) || !(den_bits > kEpsDenBits)) return;
  } else {
    float t;
    if constexpr (M == kRecip || M == kRecip4) {
      float r;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p.den));
      r = r * (2.0f - p.den * r);  // one Newton step
      t = p.num * r;
    } else {
      t = __fdiv_rn(p.num, p.den);
    }
    if (!(t > 1e-6f) || !(fabsf(p.den) > 1e-9f)) return;
    key = __float_as_int(t);
  }
  if (key < bk || (key == bk && slot < bs)) {
    bk = key;
    bs = slot;
  }
}

// One walked panel (block b) against the thread's four rays.
template <int M, typename Panel>
__device__ __forceinline__ void walk_panel(const Panel* pn, int b,
                                           const float (&x)[kRays][9],
                                           int (&bk)[kRays], int (&bs)[kRays],
                                           int& carry) {
  const int lane = threadIdx.x % kTB;
  if constexpr (M == kDmaOnly || M == kDmaOnly4) {
#pragma unroll
    for (int i = 0; i < kRays; ++i) bk[i] = min(bk[i], __float_as_int(pn[i * kTB + lane]));
  } else if constexpr (M == kSmallCarry4) {
    carry = min(carry, __float_as_int(pn[lane]));
  } else if constexpr (M == kBf16) {
    float xh[kRays][9], xl[kRays][9];
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        xh[i][j] = __bfloat162float(__float2bfloat16_rn(x[i][j]));
        xl[i][j] = __bfloat162float(__float2bfloat16_rn(x[i][j] - xh[i][j]));
      }
    }
#pragma unroll 1
    for (int k = 0; k < kTB; ++k) {
      float ch[kCoef], cl[kCoef];
#pragma unroll
      for (int j = 0; j < kCoef; ++j) {
        ch[j] = __bfloat162float(pn[j * kTB + k]);
        cl[j] = __bfloat162float(pn[(kCoef + j) * kTB + k]);
      }
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        consider<M>(products_split(xh[i], xl[i], ch, cl), b * kTB + k, bk[i], bs[i]);
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < kTB; ++k) {
      float c[kCoef];
#pragma unroll
      for (int j = 0; j < kCoef; ++j) c[j] = pn[j * kTB + k];
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        const Prod p = products(x[i], c);
        if constexpr (product_floor(M)) {
          bk[i] = min(bk[i], __float_as_int(p.s0));
          bs[i] = min(bs[i], min(min(__float_as_int(p.s1), __float_as_int(p.s2)),
                                 min(__float_as_int(p.num), __float_as_int(p.den))));
        } else {
          consider<M>(p, b * kTB + k, bk[i], bs[i]);
        }
      }
    }
  }
}

__device__ __forceinline__ void load_rays(const float* f, int tile, float (&x)[kRays][9]) {
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    const float* fr = f + ((size_t)tile * kTile + threadIdx.x + i * kThreads) * kFeat;
#pragma unroll
    for (int j = 0; j < 9; ++j) x[i][j] = fr[j];
  }
}

// Merge a ray's (key, slot) into its 64-bit running minimum.
__device__ __forceinline__ void merge(unsigned long long* best, int key, int slot) {
  const unsigned long long packed =
      ((unsigned long long)(unsigned)key << 32) | (unsigned)slot;
  if (packed < *(volatile unsigned long long*)best) atomicMin(best, packed);
}

// Merge v into an int32 running minimum (a stale read is never below it).
__device__ __forceinline__ void min_into(int* dst, int v) {
  if (v < *(volatile int*)dst) atomicMin(dst, v);
}

__device__ __forceinline__ void flush(unsigned long long* best, int tile,
                                      const int (&bk)[kRays], const int (&bs)[kRays]) {
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    if (bs[i] >= 0) merge(best + (size_t)tile * kTile + threadIdx.x + i * kThreads, bk[i], bs[i]);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
probe_call_kernel(const float* __restrict__ f,       // (T*1024, 10)
                  const int* __restrict__ ids,       // (V, T)
                  const int* __restrict__ counts,    // (T)
                  const int* __restrict__ ovf,       // (T)
                  const void* __restrict__ trif_v,   // (NB, 10, 640) f32 | (NB, 20, 640) bf16
                  const int* __restrict__ item_offsets,  // (T+1) items of tile t: [o[t], o[t+1])
                  int* __restrict__ queue,           // (1), 0 at launch: the next item
                  unsigned long long* __restrict__ best,  // (T*1024), packed_merge(M) only
                  int* __restrict__ t_bits,          // (T*1024) t's bits, the floors' minimum
                  int* __restrict__ slot_out,        // (T*1024) product floors' slot minimum
                  int n_tiles, int vmax, int nb, float t_init) {
  using Panel = typename std::conditional<M == kBf16, __nv_bfloat16, float>::type;
  constexpr int S = stages(M), P = per_step(M);
  constexpr int kPanelElems = kPanelBytes / sizeof(Panel);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Panel* smem = reinterpret_cast<Panel*>(smem_raw);
  const Panel* trif = static_cast<const Panel*>(trif_v);
  __shared__ int taken[2];  // the item this block took, and its tile

  const int n_items = item_offsets[n_tiles];
  const int init_key = __float_as_int(t_init);
  if constexpr (M == kNoDma) {  // block 0's panel stands for every walked block
    start_panel_copy(smem, trif, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  for (;;) {
    if (threadIdx.x == 0) {
      const int item = atomicAdd(queue, 1);
      int lo = 0, hi = n_tiles - 1;  // the last tile whose items start at or before it
      while (item < n_items && lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (item_offsets[mid] <= item) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      taken[0] = item;
      taken[1] = lo;
    }
    __syncthreads();
    const int item = taken[0], tile = taken[1];
    __syncthreads();  // every thread has read them before the next item is taken
    if (item >= n_items) return;

    const bool all_blocks = ovf[tile] != 0;
    const int trip = all_blocks ? nb : min(counts[tile], vmax);
    const int first = (item - item_offsets[tile]) * kItemPanels;
    const int n = min(kItemPanels, trip - first);  // this item's panels, 1..K
    const int steps = (n + P - 1) / P;
    auto block_id = [&](int v) {  // v: position in the item
      const int pos = first + v;
      return all_blocks ? pos : ids[(size_t)pos * n_tiles + tile];
    };
    auto start_step_copies = [&](int q, int stage) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int v = q * P + j;
        if (v < n) start_panel_copy(smem + (stage * P + j) * kPanelElems, trif, block_id(v));
      }
    };

    float x[kRays][9];
    int bk[kRays], bs[kRays];
    int carry = init_key;
    load_rays(f, tile, x);
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      bk[i] = init_key;
      bs[i] = product_floor(M) ? kIntMax : -1;
    }

    if constexpr (M != kNoDma) {
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        if (s < steps) start_step_copies(s, s);
        cp_async_commit();
      }
    }
    for (int q = 0; q < steps; ++q) {
      if constexpr (M != kNoDma) {
        const int nq = q + S - 1;
        if (nq < steps) start_step_copies(nq, nq % S);
        cp_async_commit();
        cp_async_wait<S - 1>();  // step q's panels have landed
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int v = q * P + j;
        if (v >= n) break;
        const Panel* pn = M == kNoDma ? smem : smem + ((q % S) * P + j) * kPanelElems;
        walk_panel<M>(pn, block_id(v), x, bk, bs, carry);
      }
      if constexpr (M != kNoDma) __syncthreads();  // the stage may be refilled
    }

    if constexpr (packed_merge(M)) {
      flush(best, tile, bk, bs);
    } else {
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        const size_t r = (size_t)tile * kTile + threadIdx.x + i * kThreads;
        min_into(t_bits + r, M == kSmallCarry4 ? carry : bk[i]);
        if constexpr (product_floor(M)) min_into(slot_out + r, bs[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
probe_grid_kernel(const float* __restrict__ f,         // (T*1024, 10)
                  const int* __restrict__ ids_flat,    // (T*cap)
                  const int* __restrict__ counts,      // (T), <= cap
                  const float* __restrict__ trif,      // (NB, 10, 640)
                  unsigned long long* __restrict__ best,  // (T*1024)
                  int cap, float t_init) {
  __shared__ __align__(16) float panel[kCoef * kTB];
  const int tile = blockIdx.x / cap;
  const int v = blockIdx.x - tile * cap;
  if (v >= counts[tile]) return;  // a skipped grid step
  const int b = ids_flat[(size_t)tile * cap + v];
  start_panel_copy(panel, trif, b);
  cp_async_commit();
  float x[kRays][9];
  int bk[kRays], bs[kRays];
  int carry = 0;
  load_rays(f, tile, x);
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    bk[i] = __float_as_int(t_init);
    bs[i] = -1;
  }
  cp_async_wait<0>();
  __syncthreads();
  walk_panel<kFull>(panel, b, x, bk, bs, carry);
  flush(best, tile, bk, bs);
}

__global__ void __launch_bounds__(kThreads)
probe_flat_kernel(const float* __restrict__ f,            // (T*1024, 10)
                  const int* __restrict__ pair_tiles,     // (P), ascending
                  const int* __restrict__ pair_blocks,    // (P)
                  const float* __restrict__ trif,         // (NB, 10, 640)
                  unsigned long long* __restrict__ best,  // (T*1024)
                  int n_pairs, float t_init) {
  __shared__ __align__(16) float panels[2][kCoef * kTB];
  const int p0 = blockIdx.x * kChunk;
  const int p1 = min(p0 + kChunk, n_pairs);
  float x[kRays][9];
  int bk[kRays], bs[kRays];
  int carry = 0;
  int cur = -1;
  start_panel_copy(panels[0], trif, pair_blocks[p0]);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    if (p + 1 < p1) start_panel_copy(panels[(p + 1 - p0) & 1], trif, pair_blocks[p + 1]);
    cp_async_commit();
    cp_async_wait<1>();  // pair p's panel has landed
    __syncthreads();
    const int tile = pair_tiles[p];
    if (tile != cur) {  // a new tile: hand the last one's minimum on
      if (cur >= 0) flush(best, cur, bk, bs);
      load_rays(f, tile, x);
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        bk[i] = __float_as_int(t_init);
        bs[i] = -1;
      }
      cur = tile;
    }
    walk_panel<kFlatGuards>(panels[(p - p0) & 1], pair_blocks[p], x, bk, bs, carry);
    __syncthreads();  // the buffer may be refilled
  }
  if (cur >= 0) flush(best, cur, bk, bs);
}

__global__ void best_init(unsigned long long* best, int n, unsigned long long miss) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = miss;
}

__global__ void best_finalize(const unsigned long long* __restrict__ best,
                              float* __restrict__ t_out, int* __restrict__ slot_out,
                              int n, unsigned long long miss, float t_init) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long p = best[i];
  t_out[i] = p == miss ? t_init : __int_as_float((int)(p >> 32));
  slot_out[i] = p == miss ? -1 : (int)(p & 0xFFFFFFFFull);
}

// The floor modes' start: t's bits at t_init, and the slot each reports
// (dmaonly -1, smallcarry4 0, matmul and quadfloor the start of its minimum).
__global__ void floor_init(int* t_bits, int* slot, int n, int t_key, int slot_init) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  t_bits[i] = t_key;
  slot[i] = slot_init;
}

unsigned float_bits(float x) {
  unsigned bits;
  memcpy(&bits, &x, sizeof(bits));
  return bits;
}

// The running minimum's start: (t_init bits, slot 0xFFFFFFFF), above every hit.
unsigned long long miss_key(float t_init) {
  return ((unsigned long long)float_bits(t_init) << 32) | 0xFFFFFFFFull;
}

// best_init, then `main` (which launches the pair kernel), then best_finalize.
template <typename Main>
int launch_merged(void* best, void* t_out, void* slot_out, int n_tiles, float t_init,
                  cudaStream_t stream, Main main) {
  const int n = n_tiles * kTile;
  const unsigned long long miss = miss_key(t_init);
  best_init<<<(n + 255) / 256, 256, 0, stream>>>((unsigned long long*)best, n, miss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = main();
  if (err != cudaSuccess) return (int)err;
  best_finalize<<<(n + 255) / 256, 256, 0, stream>>>(
      (const unsigned long long*)best, (float*)t_out, (int*)slot_out, n, miss, t_init);
  return (int)cudaGetLastError();
}

// call: the outputs' (or best's) start values, then the persistent walk over
// the items, then (result modes and nodma) best_finalize.
template <int M>
int launch_call(const void* f, const void* ids, const void* counts, const void* ovf,
                const void* trif, const void* item_offsets, void* queue, void* best,
                void* t_out, void* slot_out, int n_tiles, int vmax, int nb, float t_init,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(probe_call_kernel<M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_call_kernel<M>,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  auto walk = [&]() {
    probe_call_kernel<M><<<sms * per_sm, kThreads, smem, stream>>>(
        (const float*)f, (const int*)ids, (const int*)counts, (const int*)ovf, trif,
        (const int*)item_offsets, (int*)queue, (unsigned long long*)best, (int*)t_out,
        (int*)slot_out, n_tiles, vmax, nb, t_init);
    return cudaGetLastError();
  };
  if constexpr (packed_merge(M)) {
    if (best == nullptr) return (int)cudaErrorInvalidValue;
    return launch_merged(best, t_out, slot_out, n_tiles, t_init, stream, walk);
  } else {
    const int n = n_tiles * kTile;
    const int slot_init = M == kSmallCarry4 ? 0 : product_floor(M) ? kIntMax : -1;
    floor_init<<<(n + 255) / 256, 256, 0, stream>>>((int*)t_out, (int*)slot_out, n,
                                                    (int)float_bits(t_init), slot_init);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)walk();
  }
}

}  // namespace

extern "C" {

// Each launch function runs on `stream` and returns cudaGetLastError() after
// its last launch (0 when every launch was accepted).
// call: item_offsets (T+1) int32 is the exclusive scan of each tile's item
// count, ceil(trip / kItemPanels); queue (1) int32 must be 0; best (T*1024)
// int64 is scratch for the result modes and nodma (null for the floors).
int raycast_probe_call_launch(const void* f, const void* ids, const void* counts,
                              const void* ovf, const void* trif, const void* item_offsets,
                              void* queue, void* best, void* t_out, void* slot_out,
                              int n_tiles, int vmax, int nb, int mode, float t_init,
                              void* stream) {
  if (n_tiles <= 0 || vmax <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define PROBE_CALL(M)                                                                   \
  case M:                                                                               \
    return launch_call<M>(f, ids, counts, ovf, trif, item_offsets, queue, best, t_out, \
                          slot_out, n_tiles, vmax, nb, t_init, s)
  switch (mode) {
    PROBE_CALL(kFull);
    PROBE_CALL(kFull4);
    PROBE_CALL(kRecip);
    PROBE_CALL(kRecip4);
    PROBE_CALL(kBf16);
    PROBE_CALL(kQuad);
    PROBE_CALL(kDmaOnly);
    PROBE_CALL(kDmaOnly4);
    PROBE_CALL(kMatmul);
    PROBE_CALL(kQuadFloor);
    PROBE_CALL(kSmallCarry4);
    PROBE_CALL(kNoDma);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CALL
}

int raycast_probe_grid_launch(const void* f, const void* ids_flat, const void* counts,
                              const void* trif, void* best, void* t_out, void* slot_out,
                              int n_tiles, int cap, float t_init, void* stream) {
  if (n_tiles <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return launch_merged(best, t_out, slot_out, n_tiles, t_init, s, [&]() {
    probe_grid_kernel<<<n_tiles * cap, kThreads, 0, s>>>(
        (const float*)f, (const int*)ids_flat, (const int*)counts, (const float*)trif,
        (unsigned long long*)best, cap, t_init);
    return cudaGetLastError();
  });
}

int raycast_probe_flat_launch(const void* f, const void* pair_tiles,
                              const void* pair_blocks, const void* trif, void* best,
                              void* t_out, void* slot_out, int n_tiles, int n_pairs,
                              float t_init, void* stream) {
  if (n_tiles <= 0 || n_pairs < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return launch_merged(best, t_out, slot_out, n_tiles, t_init, s, [&]() {
    if (n_pairs == 0) return cudaSuccess;
    probe_flat_kernel<<<(n_pairs + kChunk - 1) / kChunk, kThreads, 0, s>>>(
        (const float*)f, (const int*)pair_tiles, (const int*)pair_blocks,
        (const float*)trif, (unsigned long long*)best, n_pairs, t_init);
    return cudaGetLastError();
  });
}

const char* raycast_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
