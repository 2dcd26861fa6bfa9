"""The yardstick of the raycast kernels: the card's peaks, and the least
time any implementation of a nearest-hit raycast needs, from the
equations and the bytes alone (no block layout, no visit floors).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.
A card set below 700 W runs slower under load; the run reports its power
limit beside the share.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

TRIANGLE_BYTES = 36  # three float32 vertices, read once
RAY_IN_BYTES = 24  # float32 origin and direction, read once
RAY_OUT_BYTES = 8  # float32 t and int32 triangle, written once

# One Moller-Trumbore test, operation by operation:
#   e1 = v1 - v0, e2 = v2 - v0           6 (3 subtractions each)
#   p = d x e2                           9 (6 products, 3 differences)
#   det = e1 . p                         5 (3 products, 2 sums)
#   inv = 1 / det                        1
#   s = o - v0                           3
#   u = (s . p) * inv                    6 (5 for the dot, 1 product)
#   q = s x e1                           9
#   v = (d . q) * inv                    6
#   t = (e2 . q) * inv                   6
#   u >= 0, v >= 0, u + v <= 1, t > 0    4 compares and 1 sum
MT_FLOPS = 6 + 9 + 5 + 1 + 3 + 6 + 9 + 6 + 6 + 5


def raycast_floor_s(rays: int, triangles: int) -> dict:
    """The least seconds of a raycast of ``rays`` rays over ``triangles``
    triangles: the larger of its bytes over the bandwidth and of one test a
    ray over the float32 peak."""
    n_bytes = TRIANGLE_BYTES * triangles + (RAY_IN_BYTES + RAY_OUT_BYTES) * rays
    flops = MT_FLOPS * rays
    mem_s = n_bytes / PEAK_HBM_BYTES_PER_S
    ops_s = flops / PEAK_FP32_FLOPS
    return {"seconds": max(mem_s, ops_s), "bytes": n_bytes, "flops": flops,
            "bound_by": "memory" if mem_s >= ops_s else "operations"}
