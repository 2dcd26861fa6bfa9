#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipcgen_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure propagates and exits non-zero; nothing is caught):

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build the CUDA kernels from ``ipcgen_tpu_torch/csrc`` (one nvcc per
   source, all at once) and print the seconds each took;
3. the pair prepass kernel and the pair kernel against their plain PyTorch
   versions on the card, on a 159,744-triangle synthetic room: 256 k
   coherent scan rays, 256 k incoherent rays (ray-sorted, as raycast_asset's
   "auto" does for them) and, for the pair kernel, a set whose every subtile
   walks all blocks.  The prepass's offsets, blocks, group counts and union
   sizes must be identical, and its counting launch must give them too, with
   the stage counts of the plain three-level model (megas, groups of hit
   megas, blocks of hit groups; the last equal to what the plain lists
   imply), at least the tests of its per-ray floor; the pair kernel must
   give the same slot on >= 99.99 % of rays and
   t within 1e-5 relative.  Both times each;
4. the main path at real scale: a 638,976-triangle room and a 600 k-point
   S3DIS-format TLS room written from the same surfaces, then
   ``run_single_scene_simulation`` with the BLK2GO profile and again with
   the dense 32-line profile (20 requested waypoints; the planner densifies
   them to 40).  Each run must launch the kernel, give every frame points and
   write the labeled PLY; the labels of 100 k sampled points must equal a
   scipy cKDTree 1-NN into the TLS cloud on >= 99.9 %.  Then the run's own
   rays are rebuilt from its poses and seed and cast again exactly as the
   scan casts them (patch order, unsorted, 2048-ray tiles): that must give
   back every frame's points, and ten whole tiles of it (20,480 rays) must
   meet the raycast contract against the brute oracle
   on the card (hit masks agree >= 99 %, same triangle >= 99 %, hit-point
   error p99 <= 5 mm and max <= 5 cm), half of them from tiles that JAX's
   caps on its candidate lists overflow (the rays that took its walk-all
   fallback).  A ray over the 5 cm bound passes
   only if float64 on the original mesh shows it within the float32
   rounding bound of the kernel's edge test (``graze_bound``) of an edge of
   the nearer triangle, and such grazes stay under 0.1 % of the rays.  The
   prepass kernel and the pair kernel are also held against their plain
   versions on those same inputs of each run, and the ray-triangle tests the
   pair kernel runs must equal those of the exact lists: no subtile walks
   every block.
5. culled kernel against its plain version and the block-scan oracle, bit
   for bit in t and slot: 256 k dense-32 rays in beam order (as the culled
   scan casts them) on the 159,744-triangle room, the 8,192-ray cluttered
   room of tests/test_tpu_hardware.py:31-50 and the edge-case set
   (``utils.synthetic.culled_edge_cases``: ties across blocks, hits at
   t_max, origins on slab planes, zero direction components, |det| at
   1e-9, t a float step from another hit); both times.  Its counting
   instantiation must give the same bits and run at least the per-ray
   floor's tests (``raycast_culled.visit_floors``).
6. the main path a third time, as a user selects the culled kernel: the
   config tree ``PipelineConfig.from_dict`` with ``simulation.backend:
   pallas`` and the BLK2GO profile, through ``S3DISSimulator`` and
   ``run_auto_simulation`` on the same room.  It must launch the culled
   kernel and not the pair kernel, give every frame points, write the
   labeled PLY and pass the label check.  The run's own rays, cast again in
   beam order, must give back every frame exactly; 640 whole 32-ray warps
   (20,480 rays) of them must equal the oracle bit for bit in t, tri_id,
   points and normals, and the kernel its plain version bit for bit.  Every
   frame's point count must agree with the pair kernel's BLK2GO run (same
   seed, so the same waypoints and rays) within 1 %.  Over all the run's
   rays: the kernel's time, its counting instantiation (the same bits; warp
   visits, tests, tests past each prescreen stage), and the floors of a
   torch pass that culls with each ray's final t: each ray's own leaf
   blocks (the per-ray floor, which sets the bound), and the visits of 32-
   and 256-ray groups.
7. the kernel probe (``python -m ipcgen_tpu_torch.kernel_probe``, the port
   of ``scripts/kernel_probe.py``) on the 159,744-triangle room with its
   2.56 M patch-ordered dense-32 rays: every mode of ``call``, ``grid32``
   and ``flat`` through ``kernel_probe.run``, launched and timed with CUDA
   events, must launch all three probe kernels; ``call``'s schedule (work
   items of at most 8 panels, panels per tile) is logged and recorded.
   Each is held against its plain version on the first 64 tiles plus up to
   8 overflowed ones (result modes: same slot >= 99.99 %, t within 1e-5
   relative; floor modes: equal bits), recip within 1e-6 of full, and the
   result modes and ``flat``
   against the pair kernel on every ray (bf16: 99.9 % and t within the
   raycast contract's 5 mm, its split's rounding).  Runs after phase 5, on
   the same room.
8. raycast occupancy (``trajectory.occupancy_mode: raycast``):
   ``obstacle_mask`` on the planning grid of the main room through the pair
   kernel must equal the brute oracle's mask on >= 99.9 % of cells.  Runs
   inside phase 4, after the two pair runs.
9. the batch entry point (``phase_batch``): ``sim.simulator.main`` over a
   reconstruction directory of two rooms, the main room (``Area_1_office_1``)
   and ``synthetic_room(700_000, seed=1)`` (``Area_1_office_2``) with its own
   600 k TLS room, BLK2GO, 20 requested waypoints, the asynchronous export,
   both rooms' labels prewarmed (``prewarm_labels``).  Both rooms must
   succeed, each must claim its prewarm, the pair prepass and the walk must
   launch once a room (counts read after the last export drained), the
   labels of each must pass the cKDTree check, and a second ``main`` must
   skip both.  Each room's stage seconds and the rooms per hour are logged.
10. the preprocess stage (``phase_preprocess``): ``preprocess_room`` on a
   1,000,000-point synthetic room (the main room's surfaces, 2 mm noise,
   0.5 % far outliers) with a dense and an occluded ``sparse50`` variant,
   cold and warm; every injected outlier removed, the inlier mask within
   99.9 % of a float64 cKDTree k-NN's, the grid k-NN's 20-NN means within
   1.02x (mean) and 1.2x (p99) of the exact ones on 100 k points, and the
   normals' |dot| against a float64 eigh of the same neighbour sets at a
   median >= 0.9999.  The grid k-NN and the PCA are timed against their
   bounds.  This stage is torch ops: it launches no hand kernel.
11. the recon stage (``phase_recon``): ``recon.cli.reconstruct_room`` on the
   pickle of phase 10 (dense and sparse50; voxel 0.03, mise_iter 2, the
   evaluator's Chamfer and mesh quality on), cold then warm; every variant
   must reconstruct.  The splat and the marching are timed apart with CUDA
   events against their bounds; the card's splat of a 200 k-point subset is
   held to the CPU's (weights 1e-4 relative, SDF 1e-5 m where both weights
   pass, active cubes equal but where a corner's |sdf| < 1e-6); the dense
   mesh's area-uniform samples to the TLS cloud (outliers removed): mean < 2
   voxels, p95 < 4; the evaluator's Chamfer distance against a float64
   cKDTree on the same subsets within 1e-4 relative.  Torch ops, no hand
   kernel.
12. the scan of the reconstruction (``phase_recon_sim``): the JAX bench's
   headline workload, ``run_single_scene_simulation`` of the recon
   ``mesh_dense.ply`` with the dense 32-line profile, 20 waypoints and the
   preprocess room's labels.  The prepass and the walk must launch once
   each; labels against cKDTree >= 99.9 %; hit fraction > 0.9; scan points
   to the TLS cloud within 2 voxels (mean) and 4 (p95); the run's own rays
   to the raycast contract of phase 4, and both pair kernels against their
   plain versions on its inputs (``recon_dense32`` in the record).
13. bbox and eval (``phase_bbox_eval``): the S3DIS boxes of the preprocess
   room and the LiDAR-Net boxes of the recon scan (its class ids written as
   LiDAR-Net's), each equal to a float64 AABB of its points and inside the
   room; ``find_best_match`` of the recon scan against a LiDAR-Net layout
   holding phase 4's dense-32 scan of the true mesh; MMD (10 k), CD (5 k)
   and HD (3 k) against float64 on the same subsets (MMD 1e-6 absolute,
   CD and HD 1e-4 relative), each timed.

Every kernel's record carries its bound: the larger of the bytes it must
move over 3.35 TB/s and the fp32 operations these rays need: the FMA
kernels' tests of exact candidate lists over 67 TFLOP/s; the per-ray floors
of the prepass's slab tests (``prepass_floors``) and of the culled kernel's
tests, operations that cannot fuse, at one fp32 issue slot each (128 per SM
per clock at the maximum SM clock).  The prepass's row also carries
``bound_tile_ms``, the same slab tests when a tile's rays descend together
as the kernel's do, and ``bound_two_level_ms``, the two-level kernel's count
(every ray against every group, then the blocks of hit groups, at 33 slots
a test).
The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs ``torch.cuda.is_available()``.
"""

from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TRIANGLES_KERNEL_CHECK = 200_000  # -> 159,744 triangles
TRIANGLES_MAIN = 700_000  # -> 638,976 triangles
TLS_POINTS = 600_000
MAX_RANGE = 25.0
# The card's peaks (NVIDIA H100 SXM data sheet): fp32 outside the tensor
# cores, an FMA counted as two operations, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per ray-triangle test of the FMA kernels, at PEAK_FP32:
# 25 FMAs (csrc/raycast_pairs.cu, csrc/raycast_probe.cu), 75 for the probe's
# bf16 split.
FLOPS_PER_TEST = {"pairs": 50, "bf16": 150}
# Operations that cannot fuse take one fp32 issue slot each: 128 lanes per SM
# per clock at the card's maximum SM clock (fp32_issue_rate).  Per slab test
# of the pair prepass (csrc/raycast_pairs.cu slab_fast): 6 differences, 6
# products, 6 min / max per axis, 3 + 3 for the entry and exit chains and one
# compare, 25; the two-level kernel's form took 33 (6 NaN checks and 2 clamps
# more), which the two-level bound keeps so the two designs compare.  Per
# culled test (csrc/raycast_culled.cu mt_test, built with -fmad=false), the
# products, sums and differences by how far the prescreen lets it go: det, 14, on
# every test; past det, the origin offset and u's numerator, 8; past u, q
# and v's numerator, 14; past v, t's numerator, 5; past t, the three
# products by 1 / det and u + v, 4, and the IEEE divide: 10 SASS
# instructions on its fast path (MUFU.RCP, FCHK, five FFMAs, the branch to
# the slow path and its BSSY / BSYNC; `python -m
# ipcgen_tpu_torch.culled_compare --sass DIR` writes the SASS of
# __fdiv_rn(1.0f, x) built as the culled source is).
FP32_LANES_PER_SM = 128
SLAB_OPS = 25
SLAB_OPS_TWO_LEVEL = 33
CULLED_STAGE_OPS = {"tests": 14, "past_det": 8, "past_u": 14, "past_v": 5, "divides": 4}
DIVIDE_SASS = 10
PROBE_SUBSET_TILES = 64
PROBE_SUBSET_OVERFLOWED = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@functools.lru_cache(maxsize=None)
def fp32_issue_rate() -> float:
    """Unfused fp32 operations per second: 128 lanes per SM per clock, at
    the card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * mhz * 1e6


def bound(n_bytes: int, flops: float, rate: float = PEAK_FP32) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``rate`` (the fp32 peak, or
    fp32_issue_rate() for operations that cannot fuse)."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flops / rate * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=int(n_bytes), flops=float(flops), ops_per_s=rate)


def culled_ops_per_test(counts: dict) -> float:
    """Mean fp32 issue slots per culled test, from the counting kernel's
    stage counts (CULLED_STAGE_OPS, the divide at DIVIDE_SASS)."""
    ops = sum(n * counts[k] for k, n in CULLED_STAGE_OPS.items())
    return (ops + DIVIDE_SASS * counts["divides"]) / max(counts["tests"], 1)


def culled_bound(n_bytes: int, floors: dict, counts: dict) -> dict:
    """The culled kernel's bound: the per-ray floor's tests, each at the
    mean cost of the kernel's own tests on these rays (the same mix of
    prescreen exits), in fp32 issue slots."""
    res = bound(n_bytes, floors["per_ray_tests"] * culled_ops_per_test(counts),
                fp32_issue_rate())
    res["ops_per_test"] = culled_ops_per_test(counts)
    return res


def exact_list_tests(o, d, asset, t_max: float, tile: int) -> int:
    """Ray-triangle tests of exact per-tile candidate lists for these rays
    (the probe's 1024-ray tiles): the plain exact prepass, one subtile a
    tile."""
    import torch

    from ipcgen_tpu_torch.ops.raycast_pairs import exact_prepass_plain

    pad = (-o.shape[0]) % tile
    if pad:  # as prepare_pairs pads: the last ray repeated
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    _, blocks, _, _ = exact_prepass_plain(o, d, asset.block_lo, asset.block_hi,
                                          t_max=t_max, group=8, tile=tile, n_sub=1)
    return blocks.numel() * tile * asset.tri_data.shape[2]


# ---------------------------------------------------------------------------
# Ray sets
# ---------------------------------------------------------------------------
def room_poses(n: int, seed: int) -> np.ndarray:
    from ipcgen_tpu_torch.trajectory import Waypoint
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch

    rng = np.random.default_rng(seed)
    return waypoints_to_pose_batch([
        Waypoint(*rng.uniform([1.0, 1.0], [5.0, 4.0]), 1.0,
                 rng.uniform(0, 2 * np.pi))
        for _ in range(n)
    ])


# ---------------------------------------------------------------------------
# Kernel against its plain version
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(p: dict, label: str, kernel_reps: int = 5,
                    plain_reps: int = 1) -> dict:
    """Run the kernel and the plain version on the same inputs; check the
    stated tolerance and time both."""
    import torch

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_pairs import raycast_pairs_plain

    args = (p["f"], p["trif"], p["offsets"], p["blocks"], p["t_init"], p["sub"])
    t_k, s_k = _kernels.raycast_pairs_cuda(*args)
    t_p, s_p = raycast_pairs_plain(*args)
    torch.cuda.synchronize()
    same = (s_k == s_p)
    same_frac = float(same.float().mean())
    hit = same & (s_k >= 0)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-12))[hit]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    max_abs = float((t_k - t_p).abs()[hit].max()) if hit.any() else 0.0
    ms = time_ms(lambda: _kernels.raycast_pairs_cuda(*args), kernel_reps)
    plain_ms = time_ms(lambda: raycast_pairs_plain(*args), plain_reps)
    n_rays = p["f"].shape[0]
    log(f"[kernel] {label}: rays {n_rays} subtiles {p['offsets'].numel() - 1} "
        f"pairs {p['blocks'].numel()} | same slot "
        f"{same_frac:.6f} max rel t err {max_rel:.3e} | kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms")
    require(same_frac >= 0.9999, f"{label}: same slot on {same_frac:.6f} < 0.9999")
    require(max_rel <= 1e-5, f"{label}: t rel err {max_rel:.3e} > 1e-5")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
                same_slot=same_frac, rays=n_rays)


def prepass_vs_plain(p: dict, asset, label: str, kernel_reps: int = 5) -> dict:
    """The prepass kernel and its plain version on the rays ``prepare_pairs``
    gave it: offsets, blocks, group counts and union sizes identical, both
    times.  The counting launch must give the same outputs and the stage
    counts of the plain three-level model (``prepass_model``), and its
    stage-2 tests must equal those the plain lists imply (the blocks of each
    tile's groups).  The bound: the per-ray floor's slab tests
    (``prepass_floors``: every mega, the groups of the megas each ray enters,
    the blocks of the groups it enters) at SLAB_OPS.  Beside it, the same
    count for the kernel's own sets of a tile's rays (``bound_tile_ms``) and
    the two-level count (every ray against every group, then the blocks of
    hit groups) at SLAB_OPS_TWO_LEVEL, the earlier two-level kernel's bound
    (``bound_two_level_ms``)."""
    import torch

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_pairs import (
        exact_prepass_plain,
        group_boxes,
        prepass_floors,
        prepass_model,
    )

    tile = p["tile"]
    kw = dict(t_max=p["t_init"], group=p["group"], tile=tile, n_sub=tile // p["sub"])
    o, d = p["origins"], p["dirs"]
    boxes = (asset.block_lo, asset.block_hi, *group_boxes(asset.block_lo, asset.block_hi,
                                                          p["group"]))

    def kernel():
        return _kernels.raycast_pairs_prepass_cuda(o, d, *boxes, p["group"], p["t_init"],
                                                   kw["n_sub"])

    got = kernel()
    want = exact_prepass_plain(o, d, asset.block_lo, asset.block_hi, **kw)
    counted = _kernels.raycast_pairs_prepass_count_cuda(o, d, *boxes, p["group"],
                                                        p["t_init"], kw["n_sub"])
    model = prepass_model(o, d, asset.block_lo, asset.block_hi, **kw)[4]
    floors = prepass_floors(o, d, asset.block_lo, asset.block_hi, t_max=p["t_init"],
                            group=p["group"], tile=tile)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(g, w))
            for name, g, w in zip(("offsets", "blocks", "groups", "union"), got, want)}
    same["counting_launch"] = all(torch.equal(g, w) for g, w in zip(counted[:4], want))
    stage = counted[4]
    ms = time_ms(kernel, kernel_reps)
    plain_ms = time_ms(lambda: exact_prepass_plain(o, d, asset.block_lo, asset.block_hi,
                                                   **kw), 1)
    n_tiles = o.shape[0] // tile
    ng = boxes[2].shape[0]
    require(asset.num_blocks % p["group"] == 0, "the bound counts whole groups")
    implied_block_tests = int(want[2].sum()) * p["group"] * tile
    slab_tests = stage["mega_tests"] + stage["group_tests"] + stage["block_tests"]
    two_level = n_tiles * ng * tile + implied_block_tests
    n_bytes = nbytes(o, d, *boxes, *got)
    res = dict(rays=int(o.shape[0]), tiles=n_tiles, pairs=int(got[1].numel()),
               plain_pairs=int(want[1].numel()), identical=same, ms=ms,
               plain_ms=plain_ms, slab_tests=slab_tests, stage_tests=stage,
               floor_tests=floors, two_level_slab_tests=two_level)
    res.update(bound(n_bytes, floors["per_ray_tests"] * SLAB_OPS, fp32_issue_rate()))
    res["bound_tile_ms"] = bound(n_bytes, slab_tests * SLAB_OPS,
                                 fp32_issue_rate())["bound_ms"]
    res["bound_two_level_ms"] = bound(n_bytes, two_level * SLAB_OPS_TWO_LEVEL,
                                      fp32_issue_rate())["bound_ms"]
    log(f"[prepass] {label}: {json.dumps(res)}")
    require(all(same.values()), f"{label}: prepass kernel differs from its plain version")
    require(stage == model, f"{label}: the kernel's stage counts {stage} differ from the "
                            f"plain three-level model's {model}")
    require(stage["block_tests"] == implied_block_tests,
            f"{label}: stage-2 tests {stage['block_tests']} differ from the "
            f"{implied_block_tests} the plain lists imply")
    require(slab_tests >= floors["tile_tests"] >= floors["subtile_tests"]
            >= floors["warp32_tests"] >= floors["per_ray_tests"] > 0,
            f"{label}: the kernel's tests {slab_tests} and the floors {floors} are out of order")
    return res


def phase_kernel_check(device, asset) -> dict:
    import torch

    from ipcgen_tpu_torch.models.lidar_intrinsics import Indoor8LineLidarIntrinsics
    from ipcgen_tpu_torch.ops.raycast_pairs import expand_walk_all, prepare_pairs
    from ipcgen_tpu_torch.sim.scan import scan_rays

    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    o, d, _ = scan_rays(Indoor8LineLidarIntrinsics.create_dense_32line(),
                        room_poses(2, seed=1), None, device)
    p = prepare_pairs(o, d, *comps, t_max=MAX_RANGE)
    prepass = {"coherent_256k": prepass_vs_plain(p, asset, "coherent 256k")}
    out = {"coherent_256k": kernel_vs_plain(p, "coherent 256k")}
    g = torch.Generator(device=device).manual_seed(2)
    n = 256_000
    oi = torch.rand((n, 3), generator=g, device=device) \
        * torch.tensor([5.0, 4.0, 1.9], device=device) \
        + torch.tensor([0.5, 0.5, 0.3], device=device)
    di = torch.randn((n, 3), generator=g, device=device)
    di = di / di.norm(dim=1, keepdim=True)
    p = prepare_pairs(oi, di, *comps, t_max=MAX_RANGE, sort_rays=True)
    prepass["incoherent_256k"] = prepass_vs_plain(p, asset, "incoherent 256k (sorted)")
    out["incoherent_256k"] = kernel_vs_plain(p, "incoherent 256k (sorted)", plain_reps=1)
    p = prepare_pairs(o[:8192], d[:8192], *comps, t_max=MAX_RANGE)
    # Every subtile walks every block: expand_walk_all lists them all.
    p["offsets"], p["blocks"] = expand_walk_all(
        p["offsets"], p["blocks"],
        torch.ones(p["offsets"].numel() - 1, dtype=torch.int32, device=device),
        asset.num_blocks)
    require(p["blocks"].numel() == (p["offsets"].numel() - 1) * asset.num_blocks,
            "the forced walk-all list does not list every block")
    out["walk_all_8k"] = kernel_vs_plain(p, "forced walk-all 8k",
                                         kernel_reps=2, plain_reps=1)
    return out, prepass


# ---------------------------------------------------------------------------
# Culled kernel against its plain version and the oracle
# ---------------------------------------------------------------------------
def culled_vs_plain(asset, o, d, t_max: float, label: str, oracle: bool = True,
                    kernel_reps: int = 5) -> dict:
    """The culled kernel, its plain version and (``oracle``) the block-scan
    oracle on the same rays: t and slot bit for bit, and both times.  The
    counting instantiation must give the same bits and at least the per-ray
    floor's tests, which set the bound."""
    import torch

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast import raycast_brute_components
    from ipcgen_tpu_torch.ops.raycast_culled import (
        raycast_culled_plain,
        t_init_for,
        visit_floors,
    )

    o, d = o.contiguous(), d.contiguous()
    args = (o, d, asset.tri_data, asset.block_lo, asset.block_hi,
            asset.super_lo, asset.super_hi, asset.super_factor, t_init_for(t_max))
    t_k, s_k = _kernels.raycast_culled_cuda(*args)
    stats = {}
    t_p, s_p = raycast_culled_plain(*args, stats=stats)
    t_c, s_c, counts = _kernels.raycast_culled_count_cuda(*args)
    torch.cuda.synchronize()
    pairs = [("plain", t_p, s_p), ("counting kernel", t_c, s_c)]
    if oracle:
        pairs.append(("oracle", *raycast_brute_components(
            o, d, asset.tri_data, t_max, max_elems=1 << 24)))
    res = dict(rays=int(o.shape[0]), hit=float((s_k >= 0).float().mean()))
    for name, t_x, s_x in pairs:
        res[f"{name}_slot_mismatch"] = int((s_k != s_x).sum())
        res[f"{name}_t_mismatch"] = int((t_k != t_x).sum())
    both = (s_k >= 0) & (s_p >= 0)
    res["max_abs_err"] = float((t_k - t_p).abs()[both].max()) if both.any() else 0.0
    res["ms"] = time_ms(lambda: _kernels.raycast_culled_cuda(*args), kernel_reps)
    res["plain_ms"] = time_ms(lambda: raycast_culled_plain(*args), 1)
    floors = visit_floors(o, d, asset.block_lo, asset.block_hi, asset.super_lo,
                          asset.super_hi, asset.super_factor, asset.tri_data.shape[2],
                          torch.where(s_k >= 0, t_k, torch.full_like(t_k, args[-1])))
    res.update(counts=counts, floors=floors, plain_block_visits=stats["block_visits"])
    res.update(culled_bound(nbytes(*args[:7]) + 8 * o.shape[0], floors, counts))
    log(f"[culled] {label}: {res}")
    for name, _, _ in pairs:
        require(res[f"{name}_slot_mismatch"] == 0 and res[f"{name}_t_mismatch"] == 0,
                f"{label}: culled kernel differs from the {name}: {res}")
    require(counts["tests"] >= floors["per_ray_tests"],
            f"{label}: the kernel ran fewer tests than the per-ray floor: {res}")
    return res


def phase_culled_kernel_check(device, asset) -> dict:
    import torch

    from ipcgen_tpu_torch.models.lidar_intrinsics import Indoor8LineLidarIntrinsics
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.sim.scan import scan_rays
    from ipcgen_tpu_torch.utils.synthetic import culled_edge_cases, hardware_scene

    o, d, _ = scan_rays(Indoor8LineLidarIntrinsics.create_dense_32line(),
                        room_poses(2, seed=1), None, device, backend="culled")
    out = {"dense32_beam_256k": culled_vs_plain(
        asset, o, d, MAX_RANGE, "dense-32 256k beam order")}
    verts, tris, origins, dirs = hardware_scene(8192)
    room = build_scene_asset(verts, tris, device=device)
    out["cluttered_8k"] = culled_vs_plain(
        room, torch.from_numpy(origins).to(device), torch.from_numpy(dirs).to(device),
        20.0, "cluttered room 8k (t_max 20)")
    verts, tris, origins, dirs, kw, t_max = culled_edge_cases()
    edge = build_scene_asset(verts, tris, device=device, **kw)
    out["edge_cases"] = culled_vs_plain(
        edge, torch.from_numpy(origins).to(device), torch.from_numpy(dirs).to(device),
        t_max, f"edge cases ({len(origins)} rays, t_max {t_max})")
    return out


# ---------------------------------------------------------------------------
# The kernel probe (ipcgen_tpu_torch.kernel_probe) and its three kernels
# ---------------------------------------------------------------------------
def timed_once(fn):
    """(result, ms) of one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def probe_tolerance(name: str, against: str):
    """The limits a probe result must meet ({"same_slot": least share,
    "max_rel" or "max_abs": largest t error where the slots agree}), or None
    for bit equality.  Against its plain version: the same products summed
    in another order.  Against the pair kernel: the same, except the bf16
    split, whose products err by about 2^-16 of their terms (the JAX
    probe's own rounding; up to 1e-3 relative in t where t_den is small):
    it is held to the raycast contract's 5 mm, as a maximum."""
    from ipcgen_tpu_torch.ops.raycast_probe import FLOOR_MODES

    if against == "plain" and name in FLOOR_MODES:
        return None
    if against == "pairs" and name == "bf16":
        return {"same_slot": 0.999, "max_abs": 0.005}
    return {"same_slot": 0.9999, "max_rel": 1e-5}


def check_agreement(label: str, got: dict, tol) -> None:
    if tol is None:
        require(got["bits_equal"], f"{label}: not equal bit for bit: {got}")
        return
    ok = all(got[k] >= v if k == "same_slot" else got[k] <= v for k, v in tol.items())
    require(ok, f"{label}: {got} outside {tol}")


def phase_probe(device, asset) -> dict:
    """The probe's main path (``kernel_probe.run``, every mode of call,
    grid32 and flat at 2.56 M rays), then each kernel against its plain
    version on a subset of tiles and the result modes against the pair
    kernel on all rays."""
    import torch

    from ipcgen_tpu_torch import kernel_probe
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops import raycast_probe as rp
    from ipcgen_tpu_torch.ops.raycast_pairs import raycast_pairs_components

    names = list(rp.MODES) + ["grid32", "flat"]
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    run = kernel_probe.run(names, device, asset=asset)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    results = run["results"]
    sched = run["schedule"]
    log(f"[probe] {run['rays']} rays, {run['tiles']} tiles ({run['overflow_tiles']} "
        f"overflowed), {run['blocks']} blocks; main path {time.time() - t0:.1f} s, "
        f"launches {launches}")
    log(f"[probe] call's schedule: {sched['walked_panels']} panels walked in "
        f"{sched['items']} items of at most {sched['item_panels']} panels; panels per "
        f"tile {json.dumps(sched['panels_per_tile'])}; {sched['overflow_tiles']} tiles "
        f"overflowed")
    for name in names:
        r = results[name]
        log(f"[probe] {name:11s}: {r['ms']:9.3f} ms, {r['pairs']} pairs, hit {r['hit']:.4f}")
    for k in ("raycast_probe_call", "raycast_probe_grid", "raycast_probe_flat"):
        require(launches[k] > 0, f"the probe did not launch {k}: {launches}")

    base, flat = run["inputs"], run["flat_inputs"]
    n_tiles, nb = base["n_tiles"], base["nb"]
    over = base["ovf"].nonzero().flatten()[:PROBE_SUBSET_OVERFLOWED]
    tiles = torch.unique(torch.cat([torch.arange(PROBE_SUBSET_TILES, device=device), over]))
    rows = (tiles[:, None] * 1024 + torch.arange(1024, device=device)).reshape(-1)
    f_sub = base["f"][rows].contiguous()
    sub = (f_sub, base["ids"][:, tiles].contiguous(), base["counts"][tiles].contiguous(),
           base["ovf"][tiles].contiguous())
    checks = {}
    for mode in rp.MODES:
        trif = base["trif_bf16"] if mode == "bf16" else base["trif"]
        t_k, s_k = results[mode]["out"]
        plain, plain_ms = timed_once(lambda: rp.probe_call_plain(*sub, trif, mode))
        got = rp.agreement(t_k[rows], s_k[rows], *plain)
        check_agreement(f"probe {mode} vs plain", got, probe_tolerance(mode, "plain"))
        checks[mode] = dict(got, plain_ms=plain_ms)
    for mode in ("recip", "recip4"):  # the same products: only 1/t_den differs
        got = rp.agreement(*results[mode]["out"], *results["full"]["out"])
        check_agreement(f"probe {mode} vs full", got, {"same_slot": 0.9999, "max_rel": 1e-6})
        checks[mode]["vs_full"] = got
    ids_flat, counts_c = rp.grid_ids(base["ids"], base["counts"], 32)
    plain, plain_ms = timed_once(lambda: rp.probe_grid_plain(
        f_sub, ids_flat.view(n_tiles, 32)[tiles].reshape(-1).contiguous(),
        counts_c[tiles].contiguous(), base["trif"], 32))
    got = rp.agreement(*(x[rows] for x in results["grid32"]["out"]), *plain)
    check_agreement("probe grid32 vs plain", got, probe_tolerance("grid32", "plain"))
    checks["grid32"] = dict(got, plain_ms=plain_ms)
    sub_pairs = rp.flat_pairs(flat["ids"][:, tiles], flat["counts"][tiles],
                              flat["ovf"][tiles], nb)
    plain, plain_ms = timed_once(lambda: rp.probe_flat_plain(
        f_sub, *sub_pairs, len(tiles), flat["trif"]))
    got = rp.agreement(*(x[rows] for x in results["flat"]["out"]), *plain)
    check_agreement("probe flat vs plain", got, probe_tolerance("flat", "plain"))
    checks["flat"] = dict(got, plain_ms=plain_ms)

    # The result modes and flat against the pair kernel, on every ray.
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    t_ref, s_ref = raycast_pairs_components(run["origins"], run["dirs"], *comps,
                                            t_max=base["t_init"], sort_rays=False)
    for name in rp.RESULT_MODES + ("flat",):
        got = rp.agreement(*results[name]["out"], t_ref, s_ref)
        check_agreement(f"probe {name} vs the pair kernel", got, probe_tolerance(name, "pairs"))
        checks[name]["vs_pair_kernel"] = got
    for name, c in checks.items():
        log(f"[probe] {name}: {json.dumps(c)}")

    # Bounds: the work these rays need (exact lists, nothing overflowed).
    exact = exact_list_tests(run["origins"], run["dirs"], asset, base["t_init"], 1024)
    out_bytes = 8 * run["rays"]
    bounds = {
        "call": bound(nbytes(base["f"], base["ids"], base["counts"], base["ovf"],
                             base["trif"]) + out_bytes, exact * FLOPS_PER_TEST["pairs"]),
        "grid": bound(nbytes(base["f"], ids_flat, counts_c, base["trif"]) + out_bytes,
                      int(counts_c.sum()) * 1024 * 128 * FLOPS_PER_TEST["pairs"]),
        "flat": bound(nbytes(flat["f"], flat["pair_tiles"], flat["pair_blocks"],
                             flat["trif"]) + out_bytes, exact * FLOPS_PER_TEST["pairs"]),
    }
    walked_tests = results["full"]["pairs"] * 1024 * 128
    log(f"[probe] exact-list tests {exact:.4e}, walked by call {walked_tests:.4e}; "
        f"bounds {json.dumps(bounds)}")
    return dict(launches=launches, results={n: {k: v for k, v in r.items() if k != "out"}
                                            for n, r in results.items()},
                checks=checks, bounds=bounds, exact_list_tests=exact,
                subset_tiles=int(len(tiles)), subset_overflowed=int(len(over)),
                rays=run["rays"], tiles=n_tiles, schedule=sched)


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------
def check_labels(ply_path: Path, data_root: Path, n_sample: int = 100_000,
                 room: str = "office_1") -> float:
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch.io.ply import read_labeled_ply
    from ipcgen_tpu_torch.semantic.annotations import S3DISAnnotationLoader

    points, _colors, sem, ins = read_labeled_ply(ply_path)
    loader = S3DISAnnotationLoader(str(data_root), verbose=False)
    ref_pts, ref_sem, ref_ins = loader.create_labeled_pointcloud_with_instances(
        loader.load_room_annotations("Area_1", room))
    rng = np.random.default_rng(0)
    pick = rng.choice(len(points), size=min(n_sample, len(points)), replace=False)
    _, nn = cKDTree(np.asarray(ref_pts, np.float64)).query(
        np.asarray(points[pick], np.float64))
    agree = (np.asarray(sem[pick]) == np.asarray(ref_sem[nn])) & \
        (np.asarray(ins[pick]) == np.asarray(ref_ins[nn]))
    return float(agree.mean())


GRAZE_ROUNDOFFS = 4  # unit roundoffs of the edge test's terms
MAX_GRAZE_FRAC = 1e-3


def graze_bound(o, d, tri, center):
    """Float64 clearance of each ray from the nearest edge line of its
    triangle, and the float32 rounding bound of the kernel's edge test there.

    o, d (n, 3) rays; tri (n, 3, 3) triangle vertices; center (3,) the point
    the kernel's Pluecker panels and ray features are centred on.  The edge
    test for p -> q is d.(p x q) + (q - p).(o x d) in centred float32
    coordinates: its rounding error is a few unit roundoffs of
    |p||q| + (|p| + |q|)|o x d| (the cross products and the rounded vertices
    and edge), and dividing by |d x (q - p)| turns a side value into the
    distance between the ray and the edge line.
    """
    eps = float(np.finfo(np.float32).eps)
    o = np.asarray(o, np.float64) - center
    d = np.asarray(d, np.float64)
    tri = np.asarray(tri, np.float64) - center
    m = np.cross(o, d)
    clear = np.full(len(o), np.inf)
    bound = np.zeros(len(o))
    for i, j in ((0, 1), (1, 2), (2, 0)):
        p, q = tri[:, i], tri[:, j]
        scale = np.linalg.norm(np.cross(d, q - p), axis=1)
        side = np.einsum("ij,ij->i", d, np.cross(p, q)) + np.einsum("ij,ij->i", q - p, m)
        dist = np.abs(side) / np.maximum(scale, 1e-300)
        pn, qn = np.linalg.norm(p, axis=1), np.linalg.norm(q, axis=1)
        err = GRAZE_ROUNDOFFS * eps * (pn * qn + (pn + qn) * np.linalg.norm(m, axis=1))
        nearest = dist < clear
        clear = np.where(nearest, dist, clear)
        bound = np.where(nearest, err / np.maximum(scale, 1e-300), bound)
    return clear, bound


def check_own_rays(asset, intr, sc, tri_xyz, seed: int, device, n_tiles: int = 10):
    """Rebuild the run's rays and cast them as the scan does; check that this
    gives back the run's frames, then hold ``n_tiles`` whole tiles of it to
    the raycast contract against the brute oracle, half of them from tiles
    that JAX's caps overflow.  ``tri_xyz`` (n, 3, 3) holds the mesh's
    triangles by original id.  Returns the contract figures and the pair
    kernel's inputs for those rays."""
    import torch

    from ipcgen_tpu_torch.ops.raycast import raycast_asset
    from ipcgen_tpu_torch.ops.raycast_pairs import _nanmax, _nanmin, prepare_pairs
    from ipcgen_tpu_torch.sim.scan import scan_rays

    max_range = float(intr.max_range)
    # The simulator's generator is seeded with the run's seed and first
    # draws the sensor pattern, so these are the rays the run cast.
    o, d, keep = scan_rays(intr, sc.scan_poses,
                           torch.Generator(device=device).manual_seed(seed), device)
    p = prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                      t_max=max_range)
    # The scan's own call (sim/scan.py _scan_core).
    rk = raycast_asset(o, d, asset, t_max=max_range, sort_rays=False)
    w = len(sc.frames)
    mask = (rk.hit if keep is None else rk.hit & keep).view(w, -1).cpu().numpy()
    pts = rk.points.view(w, -1, 3).cpu().numpy()
    frame_err = 0.0
    for i, frame in enumerate(sc.frames):
        mine = pts[i][mask[i]]
        require(len(mine) == len(frame.points),
                f"frame {i}: {len(mine)} points cast again, {len(frame.points)} in the run")
        if len(mine):
            frame_err = max(frame_err, float(np.abs(mine - frame.points).max()))
    require(frame_err <= 1e-5, f"frames not reproduced: max point error {frame_err} m")

    # Whole tiles of the scan's tiling; half from tiles that JAX's caps
    # overflow (its walk-all fallback's rays).
    tile = p["tile"]
    n_full = o.shape[0] // tile
    over_cap = p["overflow"][:n_full].cpu().numpy()
    rng = np.random.default_rng(4)
    ovf, lst = np.flatnonzero(over_cap), np.flatnonzero(~over_cap)
    k_ovf = min(len(ovf), n_tiles // 2)
    tiles = np.sort(np.concatenate([rng.choice(ovf, k_ovf, replace=False),
                                    rng.choice(lst, n_tiles - k_ovf, replace=False)]))
    idx = torch.from_numpy((tiles[:, None] * tile + np.arange(tile)).reshape(-1)).to(device)
    ro = raycast_asset(o[idx], d[idx], asset, backend="brute", t_max=max_range)
    hk, ho = rk.hit[idx].cpu().numpy(), ro.hit.cpu().numpy()
    both = hk & ho
    tk, to = rk.tri_id[idx].cpu().numpy(), ro.tri_id.cpu().numpy()
    same = both & (tk == to)
    pk, po = rk.points[idx].cpu().numpy(), ro.points.cpu().numpy()
    pe = np.linalg.norm(pk[both] - po[both], axis=1)
    # Rays over the 5 cm bound: is each a graze of the nearer triangle's edge?
    over = np.flatnonzero(both)[pe > 0.05]
    nearer = np.where(rk.t[idx].cpu().numpy()[over] < ro.t.cpu().numpy()[over],
                      tk[over], to[over])
    center = ((_nanmin(asset.block_lo, 0) + _nanmax(asset.block_hi, 0)) * 0.5).cpu().numpy()
    sel = idx.cpu().numpy()[over]
    clear, bound = graze_bound(o[sel].cpu().numpy(), d[sel].cpu().numpy(),
                               tri_xyz[nearer], center.astype(np.float64))
    grazes = [dict(ray=int(r), err_mm=float(e * 1e3), clearance_um=float(c * 1e6),
                   bound_um=float(b * 1e6))
              for r, e, c, b in zip(sel, pe[pe > 0.05], clear, bound)]
    pe_rest = pe[pe <= 0.05]
    res = dict(config=f"unsorted, {tile}-ray tiles, group {p['group']}, gmax "
                      f"{p['gmax']}, vmax {p['vmax']}",
               tiles=len(tiles), over_cap_tiles=int(k_ovf),
               over_cap_frac=float(over_cap.mean()), rays=int(idx.numel()),
               frames_max_err_m=frame_err,
               hit_agree=float((hk == ho).mean()),
               same_tri=float(same.sum() / max(both.sum(), 1)),
               p99_mm=float(np.percentile(pe, 99) * 1e3) if len(pe) else 0.0,
               max_mm=float(pe.max() * 1e3) if len(pe) else 0.0,
               max_mm_without_grazes=float(pe_rest.max() * 1e3) if len(pe_rest) else 0.0,
               grazes=grazes)
    require(res["hit_agree"] >= 0.99, f"hit agreement {res}")
    require(res["same_tri"] >= 0.99, f"same triangle {res}")
    require(res["p99_mm"] <= 5.0, f"point error p99 {res}")
    require(bool(np.all(clear <= bound)), f"a ray over 5 cm is not an edge graze: {res}")
    require(len(over) <= MAX_GRAZE_FRAC * idx.numel(), f"too many edge grazes: {res}")
    return res, p


def phase_main_path(device, work: Path, card: str):
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator, run_single_scene_simulation
    from ipcgen_tpu_torch.utils.device import sync
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room, write_s3dis_room

    t0 = time.time()
    v, t = synthetic_room(TRIANGLES_MAIN)
    mesh_path = work / "mesh_dense.ply"
    TriMesh(vertices=v, triangles=t).save(mesh_path)
    data_root = work / "s3dis"
    n_tls = write_s3dis_room(data_root / "Area_1" / "office_1", TLS_POINTS)
    log(f"[main] room {len(t)} triangles, TLS {n_tls} points, written in "
        f"{time.time() - t0:.1f} s")
    asset = build_scene_asset(v, t, device=device)  # for the oracle check
    tri_xyz = v[t]  # triangles by original id, for the graze bound
    runs = {}
    for profile in ("blk2go", "dense32"):
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        t0 = time.time()
        sc = run_single_scene_simulation(
            str(mesh_path), scene_name=f"synth_{profile}", num_waypoints=20,
            output_base_dir=str(work / "out"), use_blk2go=profile == "blk2go",
            use_dense_lidar=profile == "dense32", s3dis_data_root=str(data_root),
            area="Area_1", room="office_1", seed=0, device=device,
        )
        sync(device)
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
        n_frames = len(sc.frames)
        n_points = [len(f.points) for f in sc.frames]
        intr = S3DISSimulator({}, use_blk2go=profile == "blk2go",
                              use_dense_lidar=profile == "dense32",
                              device=device).lidar_config
        rays = n_frames * intr.get_total_points_per_scan()
        log(f"[main] {profile}: {n_frames} frames, {rays} rays, "
            f"{sum(n_points)} points, {wall:.2f} s wall, launches {launches}")
        require(launches["raycast_pairs"] > 0 and launches["raycast_pairs_prepass"] > 0
                and launches["raycast_culled"] == 0,
                f"{profile}: the pair prepass and pair kernels alone must run: {launches}")
        require(n_frames > 0 and min(n_points) > 0, f"{profile}: empty frame")
        ply = work / "out" / f"synth_{profile}" / "combined_pointcloud_with_label.ply"
        require(ply.is_file(), f"{profile}: labeled PLY missing")
        label_agree = check_labels(ply, data_root)
        log(f"[main] {profile}: labels agree with cKDTree 1-NN on {label_agree:.5f}")
        require(label_agree >= 0.999, f"{profile}: label agreement {label_agree}")
        stages = {k: round(float(v), 4) for k, v in sorted(sc.profile.items())}
        log(f"[main] {profile}: stage seconds on {card}: {json.dumps(stages)}")
        contract, pairs = check_own_rays(asset, intr, sc, tri_xyz, seed=0,
                                         device=device)
        log(f"[main] {profile}: the run's rays cast again reproduce its frames; "
            f"raycast contract vs oracle {contract}")
        at_shape, prepass = pair_kernels_at_shape(asset, pairs, profile, rays, "main")
        del pairs
        runs[profile] = dict(launches=launches, wall_s=wall, rays=rays,
                             frames=n_frames, points=n_points, stages=stages,
                             kernel=at_shape, prepass=prepass)
    occupancy = check_occupancy(asset, v, t)
    culled = phase_culled_main_path(device, work, card, mesh_path, data_root,
                                    asset, runs["blk2go"])
    del asset
    batch = phase_batch(device, work, card, mesh_path, data_root)
    return runs, culled, occupancy, batch


def pair_kernels_at_shape(asset, pairs: dict, profile: str, rays: int, tag: str):
    """The prepass and the pair kernel against their plain versions on a
    run's own inputs, with the pair kernel's bound from the exact lists'
    tests; the tests it runs must equal those."""
    prepass = prepass_vs_plain(pairs, asset, f"{profile} main-path inputs ({rays} rays)",
                               kernel_reps=3)
    at_shape = kernel_vs_plain(pairs, f"{profile} main-path inputs ({rays} rays)",
                               kernel_reps=3, plain_reps=1)
    # The work the pair kernel needs for these rays (the plain version's
    # exact lists) beside what it runs (the kernel prepass's lists).
    per_pair = pairs["sub"] * asset.tri_data.shape[2]
    at_shape["exact_list_tests"] = prepass["plain_pairs"] * per_pair
    at_shape["tests_run"] = int(pairs["blocks"].numel()) * per_pair
    at_shape.update(bound(
        nbytes(*(pairs[k] for k in ("f", "trif", "offsets", "blocks")))
        + 8 * pairs["f"].shape[0],
        at_shape["exact_list_tests"] * FLOPS_PER_TEST["pairs"]))
    log(f"[{tag}] {profile}: pair kernel {at_shape['ms']:.3f} ms, bound "
        f"{at_shape['bound_ms']:.3f} ms ({at_shape['bound_by']}), exact-list tests "
        f"{at_shape['exact_list_tests']:.4e}, tests run {at_shape['tests_run']:.4e}; "
        f"prepass {prepass['ms']:.3f} ms, bound {prepass['bound_ms']:.3f} ms "
        f"({prepass['bound_by']})")
    require(at_shape["tests_run"] == at_shape["exact_list_tests"],
            f"{profile}: the pair kernel's tests differ from the exact lists'")
    return at_shape, prepass


def check_occupancy(asset, v, t) -> dict:
    """The raycast occupancy of the planner's grid (``occupancy_mode:
    raycast``): obstacle_mask on the card through the pair kernel against
    the brute oracle's mask."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.containers.scene import RoomBounds
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.occupancy import obstacle_mask
    from ipcgen_tpu_torch.trajectory import AutoTrajectoryGenerator

    gen = AutoTrajectoryGenerator(robot_radius=0.15)  # the simulator's planner
    b = RoomBounds.from_mesh(TriMesh(vertices=v, triangles=t)).to_dict()
    xs = np.arange(b["x_min"], b["x_max"], gen.grid_resolution)
    ys = np.arange(b["y_min"], b["y_max"], gen.grid_resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    cells = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, gen.robot_height)], axis=1)
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    occ = obstacle_mask(asset, cells, gen.robot_radius)
    seconds = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    want = obstacle_mask(asset, cells, gen.robot_radius, backend="brute")
    res = dict(cells=len(cells), rays=len(cells) * 26, occupied=int(occ.sum()),
               agree=float((occ == want).mean()), seconds=seconds,
               pair_launches=launches["raycast_pairs"])
    log(f"[occupancy] planning grid of the main room vs the brute oracle: {res}")
    require(launches["raycast_pairs"] > 0, f"occupancy did not run the pair kernel: {launches}")
    require(0 < res["occupied"] < len(cells), f"occupancy: {res}")
    require(res["agree"] >= 0.999, f"occupancy agreement {res}")
    return res


def phase_culled_main_path(device, work: Path, card: str, mesh_path: Path,
                           data_root: Path, asset, pair_run: dict,
                           n_groups: int = 640) -> dict:
    """The BLK2GO run again, with the culled kernel selected through the
    config tree, and its checks."""
    import torch

    from ipcgen_tpu_torch.config import PipelineConfig
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast import raycast_asset
    from ipcgen_tpu_torch.ops.raycast_culled import GROUP, t_init_for, visit_floors
    from ipcgen_tpu_torch.sim.scan import scan_rays
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator
    from ipcgen_tpu_torch.utils.device import sync

    # What create_simulator_from_config does after loading the YAML (the
    # card's host has no yaml).
    tree = PipelineConfig.from_dict({
        "simulation": {"backend": "pallas", "use_blk2go": True, "seed": 0},
        "data": {"data_root": str(data_root), "area_name": "Area_1",
                 "room_name": "office_1"},
    })
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    sim = S3DISSimulator(tree.simulator_config(), use_blk2go=tree.simulation.use_blk2go,
                         use_dense_lidar=tree.simulation.use_dense_lidar, device=device)
    out_dir = work / "out" / "synth_culled"
    sc = sim.run_auto_simulation(str(mesh_path), num_waypoints=20,
                                 output_dir=out_dir, scene_name="synth_culled")
    sync(device)
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    intr = sim.lidar_config
    n_points = [len(f.points) for f in sc.frames]
    rays = len(sc.frames) * intr.get_total_points_per_scan()
    stages = {k: round(float(v), 4) for k, v in sorted(sc.profile.items())}
    rate = rays / (stages["dispatch"] + stages["scan_exec"])
    log(f"[culled-main] backend {sim.backend}: {len(sc.frames)} frames, {rays} rays, "
        f"{sum(n_points)} points, {wall:.2f} s wall, launches {launches}")
    log(f"[culled-main] stage seconds on {card}: {json.dumps(stages)}; "
        f"{rate:.0f} rays/s over dispatch + scan_exec")
    require(sim.backend == "culled", f"config backend pallas gave {sim.backend}")
    require(launches["raycast_culled"] >= 1 and launches["raycast_pairs"] == 0
            and launches["raycast_culled_count"] == 0, f"culled run launches {launches}")
    require(len(sc.frames) > 0 and min(n_points) > 0, "culled run: empty frame")
    ply = out_dir / "combined_pointcloud_with_label.ply"
    require(ply.is_file(), "culled run: labeled PLY missing")
    label_agree = check_labels(ply, data_root)
    log(f"[culled-main] labels agree with cKDTree 1-NN on {label_agree:.5f}")
    require(label_agree >= 0.999, f"culled run: label agreement {label_agree}")

    # The same seed and planner: the pair run scanned the same rays.
    want = pair_run["points"]
    frame_dev = max(abs(a - b) / b for a, b in zip(n_points, want))
    total_dev = abs(sum(n_points) - sum(want)) / sum(want)
    log(f"[culled-main] vs the pair kernel's BLK2GO run: {sum(n_points)} vs "
        f"{sum(want)} points, max frame deviation {frame_dev:.2e}, total {total_dev:.2e}")
    require(len(n_points) == len(want) and frame_dev <= 0.01 and total_dev <= 0.01,
            f"culled vs pair run: {n_points} vs {want}")

    # The run's own rays, cast again as the culled scan casts them.
    o, d, keep = scan_rays(intr, sc.scan_poses,
                           torch.Generator(device=device).manual_seed(0), device,
                           backend="culled")
    max_range = float(intr.max_range)
    rk = raycast_asset(o, d, asset, backend="culled", t_max=max_range)
    w = len(sc.frames)
    mask = (rk.hit if keep is None else rk.hit & keep).view(w, -1).cpu().numpy()
    pts = rk.points.view(w, -1, 3).cpu().numpy()
    for i, frame in enumerate(sc.frames):
        require(np.array_equal(pts[i][mask[i]], frame.points),
                f"culled run: frame {i} not reproduced")
    log(f"[culled-main] the run's {o.shape[0]} rays cast again reproduce all "
        f"{w} frames exactly")

    # Whole groups of the kernel's tiling, against the oracle bit for bit.
    rng = np.random.default_rng(4)
    groups = np.sort(rng.choice(o.shape[0] // GROUP, n_groups, replace=False))
    idx = torch.from_numpy((groups[:, None] * GROUP + np.arange(GROUP)).reshape(-1)).to(device)
    ro = raycast_asset(o[idx], d[idx], asset, backend="brute", t_max=max_range)
    diff = {name: int((getattr(rk, name)[idx] != getattr(ro, name)).sum())
            for name in ("t", "tri_id", "hit", "points", "normals")}
    log(f"[culled-main] {idx.numel()} rays ({n_groups} groups) vs the oracle: "
        f"elements that differ {diff}, hit {float(ro.hit.float().mean()):.4f}")
    require(not any(diff.values()), f"culled run vs oracle: {diff}")
    subset = culled_vs_plain(asset, o[idx], d[idx], max_range,
                             f"culled main-path inputs ({idx.numel()} of "
                             f"{o.shape[0]} rays; plain version on this subset)",
                             oracle=False, kernel_reps=5)
    # All the run's rays: the time, the counting instantiation's visits and
    # tests against the floors, and the bound from the per-ray floor.
    full = (o, d, asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo,
            asset.super_hi, asset.super_factor, t_init_for(max_range))
    full_ms = time_ms(lambda: _kernels.raycast_culled_cuda(*full), 3)
    t_k, s_k = _kernels.raycast_culled_cuda(*full)
    t_c, s_c, counts = _kernels.raycast_culled_count_cuda(*full)
    require(torch.equal(t_c, t_k) and torch.equal(s_c, s_k),
            "culled run: the counting kernel differs from the kernel")
    t0 = time.time()
    floors = visit_floors(o, d, asset.block_lo, asset.block_hi, asset.super_lo,
                          asset.super_hi, asset.super_factor, asset.tri_data.shape[2],
                          torch.where(s_k >= 0, t_k, torch.full_like(t_k, full[-1])))
    full_bound = culled_bound(nbytes(*full[:7]) + 8 * o.shape[0], floors, counts)
    log(f"[culled-main] culled kernel over all {o.shape[0]} rays of the run: "
        f"{full_ms:.3f} ms; bound {full_bound['bound_ms']:.3f} ms ({full_bound['bound_by']}, "
        f"{full_bound['flops']:.4e} fp32 issue slots at {full_bound['ops_per_s']:.4e} /s: the "
        f"per-ray floor's tests at {full_bound['ops_per_test']:.2f} each); kernel counts "
        f"{counts}; floors {floors} (counted in "
        f"{time.time() - t0:.1f} s)")
    require(counts["tests"] >= floors["per_ray_tests"],
            f"culled run: fewer tests than the per-ray floor: {counts} {floors}")
    return dict(launches=launches, wall_s=wall, rays=rays, frames=w, stages=stages,
                rays_per_s=rate, label_agree=label_agree, oracle_rays=int(idx.numel()),
                kernel=subset, full_scan_rays=int(o.shape[0]), full_scan_ms=full_ms,
                full_scan_counts=counts, full_scan_floors=floors,
                full_scan_bound=full_bound)


# ---------------------------------------------------------------------------
# The batch entry point (sim.simulator.main)
# ---------------------------------------------------------------------------
def phase_batch(device, work: Path, card: str, mesh_path: Path, data_root: Path) -> dict:
    """``sim.simulator.main`` over a reconstruction directory of two rooms,
    with both rooms' labels prewarmed and the asynchronous export; then
    again, when both rooms must be skipped."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.containers.sim_scene import claim_prewarmed_labels, prewarm_labels
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.sim.simulator import main as batch_main
    from ipcgen_tpu_torch.utils.device import sync
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room, write_s3dis_room

    t0 = time.time()
    recon = work / "recon"
    rooms = {"Area_1_office_1": "office_1", "Area_1_office_2": "office_2"}
    for scene in rooms:
        (recon / scene).mkdir(parents=True)
    shutil.copyfile(mesh_path, recon / "Area_1_office_1" / "mesh_dense.ply")
    v, t = synthetic_room(TRIANGLES_MAIN, seed=1)
    TriMesh(vertices=v, triangles=t).save(recon / "Area_1_office_2" / "mesh_dense.ply")
    n_tls = write_s3dis_room(data_root / "Area_1" / "office_2", TLS_POINTS, seed=1)
    log(f"[batch] second room {len(t)} triangles (seed 1), TLS {n_tls} points, written "
        f"in {time.time() - t0:.1f} s")

    out = work / "batch_out"
    kw = dict(num_waypoints=20, output_base_dir=str(out), use_blk2go=True,
              s3dis_data_root=str(data_root), async_export=True, device=device)
    prewarmed = {room: prewarm_labels(str(data_root), "Area_1", room, device=device)
                 for room in rooms.values()}
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    res = batch_main(str(recon), **kw)  # returns after the last export drained
    sync(device)
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    done = [name for name, _ in res["successful"]]
    log(f"[batch] {len(done)} done, {len(res['failed'])} failed {res['failed']}, "
        f"{wall:.2f} s wall, main's total {res['total_time']:.2f} s, launches {launches}")
    require(done == list(rooms) and not res["failed"], f"batch: {res}")
    n = len(rooms)
    require(launches["raycast_pairs"] == n and launches["raycast_pairs_prepass"] == n
            and launches["raycast_culled"] == 0,
            f"batch: one pair prepass and one walk a room expected: {launches}")
    per_room = {}
    for name, sc in res["successful"]:
        room = rooms[name]
        require(sc.label_prefetch is prewarmed[room], f"batch: {name} did not claim its prewarm")
        require(claim_prewarmed_labels(str(data_root), "Area_1", room, device=device) is None,
                f"batch: {name}'s prewarm is still registered")
        ply = out / name / "combined_pointcloud_with_label.ply"
        require(ply.is_file(), f"batch: {name} labeled PLY missing")
        agree = check_labels(ply, data_root, room=room)
        stages = {k: round(float(x), 4) for k, x in sorted(sc.profile.items())}
        log(f"[batch] {name}: {len(sc.frames)} frames, {sc.get_total_points()} points, labels "
            f"agree with cKDTree 1-NN on {agree:.5f}; prewarm claimed; stage seconds on "
            f"{card}: {json.dumps(stages)}")
        require(agree >= 0.999, f"batch: {name} label agreement {agree}")
        per_room[name] = dict(frames=len(sc.frames), points=sc.get_total_points(),
                              label_agree=agree, stages=stages)
    again = batch_main(str(recon), **kw)
    require(sorted(again["skipped"]) == list(rooms) and not again["successful"]
            and not again["failed"], f"batch rerun did not skip both rooms: {again}")
    rooms_per_hour = n / res["total_time"] * 3600
    log(f"[batch] rerun skipped {again['skipped']}; {res['total_time'] / n:.3f} s a room, "
        f"{rooms_per_hour:.1f} rooms/hour on {card}")
    return dict(wall_s=wall, total_time_s=res["total_time"], s_per_room=res["total_time"] / n,
                rooms_per_hour=rooms_per_hour, launches=launches, rooms=per_room)


# ---------------------------------------------------------------------------
# The preprocess stage
# ---------------------------------------------------------------------------
PRE_POINTS = 1_000_000
PRE_SAMPLE = 100_000
PRE_VARIANTS = [{"name": "dense", "keep_ratio": 1.0, "occlusion": False},
                {"name": "sparse50", "keep_ratio": 0.5, "occlusion": True}]


def phase_preprocess(device, work: Path, card: str) -> dict:
    """``preprocess_room`` on a 1 M-point synthetic S3DIS room (2 mm noise,
    0.5 % far outliers) with a dense and an occluded sparse50 variant, held
    to a float64 reference on the host; the grid k-NN and the PCA timed
    against their bounds.  No hand kernel runs here: the stage is torch ops."""
    import torch
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch.ops import grid_nn, normals as nrm, outliers
    from ipcgen_tpu_torch.preprocess.loader import DEFAULT_PREPROCESSING, S3DISLoader, \
        preprocess_room
    from ipcgen_tpu_torch.utils.synthetic import OUTLIER_RGB, write_s3dis_room

    t0 = time.time()
    root = work / "pre_s3dis"
    n = write_s3dis_room(root / "Area_1" / "office_1", PRE_POINTS, seed=0, noise_std=0.002,
                         outlier_frac=0.005)
    log(f"[preprocess] room of {n} points (2 mm noise, 0.5 % far outliers) written in "
        f"{time.time() - t0:.1f} s")
    cfg = {"preprocessing": dict(DEFAULT_PREPROCESSING)}
    runs = []
    for turn in ("cold", "warm"):
        t0 = time.time()
        room = preprocess_room(str(root), "Area_1", "office_1", cfg,
                               output_dir=str(work / "pre_out"),
                               sparsity_experiments=PRE_VARIANTS, seed=0, device=device)
        wall = time.time() - t0
        sizes = {k: len(x["points"]) for k, x in room["variants"].items()}
        log(f"[preprocess] {turn}: {len(room['points'])} points kept, variants {sizes}, "
            f"{wall:.3f} s wall; spans on {card}: {json.dumps(room['spans'])}")
        runs.append(dict(turn=turn, wall_s=wall, preprocess_time=room["preprocess_time"],
                         spans=room["spans"], variants=sizes))
    require(sizes["sparse50"] > nrm.GRID_MIN_N,
            f"sparse50 left {sizes['sparse50']} points: not on the grid path")
    for name, var in room["variants"].items():
        nv = var["normals"]
        require(nv.shape == var["points"].shape and np.isfinite(nv).all()
                and np.allclose(np.linalg.norm(nv, axis=1), 1.0, atol=1e-3),
                f"preprocess: {name} normals not unit")

    points, colors, _ = S3DISLoader(str(root)).load_room_data("Area_1", "office_1")
    is_out = np.all(np.round(colors * 255) == OUTLIER_RGB, axis=1)
    pts32 = points.astype(np.float32)
    p = cfg["preprocessing"]
    nb, k_join, cap = p["outlier_nb_neighbors"], max(p["outlier_nb_neighbors"] + 1,
                                                    p["normal_max_nn"]), 48
    mask, normals = outliers.remove_outliers_and_estimate_normals(pts32, device=device)
    require(np.array_equal(points[mask], room["points"]),
            "preprocess_room kept other points than the fused op")
    require(not mask[is_out].any(), f"{int(mask[is_out].sum())} of {int(is_out.sum())} "
                                    "injected outliers kept")
    out_color = np.all(np.round(room["variants"]["dense"]["colors"] * 255) == OUTLIER_RGB,
                       axis=1)
    require(not out_color.any(), "an outlier's colour is in the dense variant")

    # The float64 reference: exact k-NN means and the same threshold rule.
    t0 = time.time()
    d_ref, _ = cKDTree(points).query(points, k=nb + 1, workers=-1)
    mean_ref = d_ref[:, 1:].mean(axis=1)
    mask_ref = mean_ref <= mean_ref.mean() + p["outlier_std_ratio"] * mean_ref.std()
    mask_agree = float((mask == mask_ref).mean())
    ref_s = time.time() - t0

    # The grid k-NN of the fused join, timed, and its means on a sample.
    pts_dev = torch.from_numpy(pts32).to(device)
    torch.cuda.synchronize()
    t0 = time.time()
    idx_d, d2_d = grid_nn.knn_grid(pts_dev, pts32, k=k_join, device_arrays=True,
                                   device=device)
    torch.cuda.synchronize()
    knn_wall = time.time() - t0
    cell = grid_nn._choose_cell_size(pts32, max(cap, k_join))
    _, grid = grid_nn._grid_tensors(pts32, cell, device)
    core_ms = time_ms(lambda: grid_nn._grid_knn_core(pts_dev, *grid, cap, k_join, 4096), 3)
    # Two bounds: the candidates' gather (every query reads 8 x cap slots of
    # 12 B), and each input read once and each output written once
    # (queries, bucket-sorted refs, starts; int64 ids and float32 d2).
    gather_bytes = n * 8 * cap * 12
    knn_bound = bound(gather_bytes, 0.0)
    knn_io_bound = bound(n * 12 * 2 + grid[1].numel() * 4 + n * k_join * 12, 0.0)
    rng = np.random.default_rng(0)
    sample = rng.choice(n, PRE_SAMPLE, replace=False)
    d2_s = d2_d[torch.from_numpy(sample).to(device)].cpu().numpy()
    grid_mean = np.sqrt(d2_s[:, 1:nb + 1]).mean(axis=1)
    fin = np.isfinite(grid_mean)
    ratio = grid_mean[fin] / np.maximum(mean_ref[sample][fin], 1e-12)

    # PCA: the fused op's normals against a float64 eigh of the same sets.
    mean_d = torch.sqrt(d2_d[:, 1:nb + 1]).mean(dim=1)
    _, threshold = outliers._threshold_mask(mean_d.cpu().numpy(), p["outlier_std_ratio"])
    thr = torch.tensor(np.float32(threshold), device=device)
    pca_ms = time_ms(lambda: outliers._fused_normals(pts_dev, idx_d, d2_d, mean_d, thr,
                                                     p["normal_max_nn"],
                                                     p["normal_search_radius"]), 3)
    max_nn, r = p["normal_max_nn"], p["normal_search_radius"]
    # Inputs once (points, the first max_nn ids and d2 of each row, the
    # means), normals out; about 30 flops a neighbour (centring, masks, the
    # six covariance products and sums).
    pca_bound = bound(n * 12 + n * max_nn * (8 + 4) + n * 4 + n * 12,
                      n * max_nn * 30.0, PEAK_FP32)
    inl = sample[mask[sample]]
    sel = torch.from_numpy(inl).to(device)
    idx_s = idx_d[sel, :max_nn].cpu().numpy()
    valid = (d2_d[sel, :max_nn] <= r * r).cpu().numpy() & mask[idx_s]
    nbh = points[idx_s]
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(axis=1), 1.0)
    c = (nbh - ((nbh * w).sum(axis=1) / cnt)[:, None, :]) * w
    vals, vecs = np.linalg.eigh(np.einsum("nki,nkj->nij", c, c) / cnt[:, :, None])
    full = np.zeros((n, 3), np.float32)
    full[mask] = normals
    dot = np.abs(np.sum(full[inl].astype(np.float64) * vecs[:, :, 0], axis=1))
    res = dict(points=n, injected_outliers=int(is_out.sum()), kept=int(mask.sum()),
               mask_agree=mask_agree, reference_s=ref_s,
               knn_ratio_mean=float(ratio.mean()), knn_ratio_p99=float(np.percentile(ratio, 99)),
               knn_finite=float(fin.mean()), normals_dot_median=float(np.median(dot)),
               normals_dot_p01=float(np.percentile(dot, 1)), normals_sample=int(len(inl)),
               knn_grid_wall_s=knn_wall, knn_core_ms=core_ms, knn_cell_m=float(cell),
               knn_gather_bound_ms=knn_bound["bound_ms"], knn_gather_bytes=gather_bytes,
               knn_io_bound_ms=knn_io_bound["bound_ms"],
               pca_ms=pca_ms, pca_bound_ms=pca_bound["bound_ms"],
               pca_bound_by=pca_bound["bound_by"], runs=runs, card=card)
    log(f"[preprocess] {json.dumps(res)}")
    log(f"[preprocess] grid k-NN (k {k_join}, cap {cap}, {n} queries): core {core_ms:.3f} ms "
        f"against its gather bound {knn_bound['bound_ms']:.3f} ms ({gather_bytes / 1e9:.2f} GB "
        f"at 3.35 TB/s), {core_ms / knn_bound['bound_ms']:.1f}x (inputs and outputs once: "
        f"{knn_io_bound['bound_ms']:.3f} ms); with the host grid build {knn_wall:.3f} s; "
        f"PCA {pca_ms:.3f} ms against {pca_bound['bound_ms']:.3f} ms "
        f"({pca_bound['bound_by']}); on {card}")
    require(mask_agree >= 0.999, f"preprocess: inlier mask agrees {mask_agree} < 0.999")
    require(res["knn_ratio_mean"] < 1.02 and res["knn_ratio_p99"] < 1.2,
            f"preprocess: grid k-NN means off the exact ones: {res}")
    require(res["normals_dot_median"] >= 0.9999, f"preprocess: normals {res}")
    return res


# ---------------------------------------------------------------------------
# The recon stage, the recon mesh's scan, bbox and eval
# ---------------------------------------------------------------------------
RECON_VOXEL = 0.03  # nksr.voxel_size of configs/s3dis_config.yaml
RECON_CONFIG = {"nksr": {"voxel_size": RECON_VOXEL, "mise_iter": 2},
                "evaluation": {"compute_chamfer": True, "compute_mesh_quality": True},
                "visualization": {"save_visualizations": False}}
RECON_HOLD_POINTS = 200_000
MESH_SAMPLES = 200_000
# fp32 operations of one splat contribution (ops/sdf.py _fuse): the voxel
# centre (3 adds, 3 products, 3 adds), its offset from the point (3), the
# plane distance (3 products, 2 sums), |d|^2 (3, 2), the scale (1), the
# exponential (1), the weighted distance (1) and the two sums into the grid.
SPLAT_OPS = 28
# Per cube of the grid, classifying its 8 corners (a weight compare, a sign
# compare and three ands or ors each); per active cube, 6 tets of 6 edge
# interpolations (a difference, a divide, a clamp, 3 products, 3 sums).
CLASSIFY_OPS, ACTIVE_OPS = 40, 6 * 6 * 10


def tls_tree_of(work: Path):
    """A cKDTree of the preprocess room's dense variant: its TLS points with
    the outliers removed."""
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch.preprocess.loader import load_preprocessed_data

    room = load_preprocessed_data(str(work / "pre_out" / "Area_1_office_1_preprocessed.pkl"))
    return cKDTree(np.asarray(room["variants"]["dense"]["points"], np.float64))


def tls_stats(points: np.ndarray, tls_tree, n: int, seed: int) -> dict:
    """Distances from ``n`` of ``points`` (a seeded choice) to the TLS cloud."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(points), min(n, len(points)), replace=False)
    d, _ = tls_tree.query(np.asarray(points[pick], np.float64), workers=-1)
    return dict(mean_m=float(d.mean()), p95_m=float(np.percentile(d, 95)),
                max_m=float(d.max()), samples=int(len(pick)))


def phase_recon(device, work: Path, card: str, tls_tree) -> dict:
    """``recon.cli.reconstruct_room`` on the preprocess room's pickle (dense
    and sparse50), cold then warm; the splat and the marching timed apart
    against their bounds; the card's splat held to the CPU's on a 200 k
    subset; the dense mesh to the TLS cloud; the evaluator's Chamfer
    distance to a float64 cKDTree on the same subsets."""
    import torch
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.ops import marching, sdf
    from ipcgen_tpu_torch.ops.metrics import chamfer_distance_mean
    from ipcgen_tpu_torch.ops.sampling import sample_points_on_mesh, \
        sample_points_poisson_disk
    from ipcgen_tpu_torch.preprocess.loader import load_preprocessed_data
    from ipcgen_tpu_torch.recon.cli import reconstruct_room
    from ipcgen_tpu_torch.utils.device import sync

    pkl = work / "pre_out" / "Area_1_office_1_preprocessed.pkl"
    out_dir = work / "recon_out"
    runs = []
    for turn in ("cold", "warm"):
        spans = {}
        t0 = time.time()
        res = reconstruct_room(str(pkl), RECON_CONFIG, str(out_dir), span_sink=spans,
                               device=device)
        sync(device)
        wall = time.time() - t0
        variants = {}
        for name, r in res.items():
            require("error" not in r, f"recon {turn}: {name} failed: {r}")
            st, q = r["reconstruction_stats"], r["quality_metrics"]
            variants[name] = dict(points=st["input_points"], faces=st["output_faces"],
                                  vertices=st["output_vertices"],
                                  seconds=st["reconstruction_time"], spans=st["spans"],
                                  chamfer_m=q["chamfer_distance"],
                                  watertight=q["is_watertight"], area_m2=q["surface_area"],
                                  device=st["device_used"])
            log(f"[recon] {turn} {name}: {json.dumps(variants[name])} on {card}")
            require(st["output_faces"] > 10_000 and card.split(",")[0] in st["device_used"],
                    f"recon {turn}: {name}: {st}")
        log(f"[recon] {turn}: {wall:.3f} s wall; stage spans "
            f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}")
        runs.append(dict(turn=turn, wall_s=wall, stage_spans=spans, variants=variants))

    room = load_preprocessed_data(str(pkl))
    dense = room["variants"]["dense"]
    pts = np.asarray(dense["points"], np.float32)
    nrm = np.asarray(dense["normals"], np.float32)
    n = len(pts)

    # The splat and the marching apart, at the dense variant's shapes.
    grid = sdf.fuse_point_normal_sdf(pts, nrm, voxel_size=RECON_VOXEL, device=device)
    nrm_unit = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    args = (torch.from_numpy(pts).to(device), torch.from_numpy(nrm_unit).to(device),
            torch.from_numpy(grid.origin).to(device), RECON_VOXEL, grid.shape, 2)
    splat_ms = time_ms(lambda: sdf._fuse(*args), 3)
    cells = int(np.prod(grid.shape))
    contributions = n * 125
    splat_bound = bound(n * 24 + 2 * cells * 4, contributions * SPLAT_OPS)
    soup, _ = marching.marching_tetrahedra(grid)
    active = int(marching._classify_cubes(grid.sdf, grid.valid()).sum())
    march_ms = time_ms(lambda: marching.marching_tetrahedra(grid), 3)
    march_bound = bound(2 * cells * 4 + len(soup) * 40,
                        cells * CLASSIFY_OPS + active * ACTIVE_OPS)
    shape = grid.shape
    del grid, args
    timing = dict(points=n, grid=list(shape), cells=cells,
                  contributions=contributions, splat_ms=splat_ms,
                  splat_bound_ms=splat_bound["bound_ms"], splat_bound_by=splat_bound["bound_by"],
                  active_cubes=active, soup_triangles=int(len(soup)), march_ms=march_ms,
                  march_bound_ms=march_bound["bound_ms"], march_bound_by=march_bound["bound_by"])
    log(f"[recon] splat ({n} points x 125 offsets into a {'x'.join(map(str, timing['grid']))} "
        f"grid): {splat_ms:.3f} ms against {splat_bound['bound_ms']:.4f} ms "
        f"({splat_bound['bound_by']}: {SPLAT_OPS} fp32 operations a contribution at 67 TFLOP/s, "
        f"or {splat_bound['bytes'] / 1e6:.1f} MB at 3.35 TB/s), "
        f"{splat_ms / splat_bound['bound_ms']:.0f}x; marching ({active} active cubes, "
        f"{len(soup)} triangles, the soup copied to the host): {march_ms:.3f} ms against "
        f"{march_bound['bound_ms']:.4f} ms ({march_bound['bound_by']}), "
        f"{march_ms / march_bound['bound_ms']:.0f}x; on {card}")

    # The card's splat against the CPU's on a subset: float atomics sum in
    # another order, so within tolerance.
    sel = np.sort(np.random.default_rng(0).choice(n, RECON_HOLD_POINTS, replace=False))
    g_card = sdf.fuse_point_normal_sdf(pts[sel], nrm[sel], voxel_size=RECON_VOXEL,
                                       device=device)
    g_cpu = sdf.fuse_point_normal_sdf(pts[sel], nrm[sel], voxel_size=RECON_VOXEL,
                                      device="cpu")
    wg, wc = g_card.weight.cpu().numpy(), g_cpu.weight.numpy()
    sg, sc_ = g_card.sdf.cpu().numpy(), g_cpu.sdf.numpy()
    w_rel = float((np.abs(wg - wc) / np.maximum(wc, 1e-3)).max())
    both = (wg > 1e-3) & (wc > 1e-3)
    sdf_err = float(np.abs(sg - sc_)[both].max())
    act_g = marching._classify_cubes(g_card.sdf, g_card.valid()).cpu().numpy()
    act_c = marching._classify_cubes(g_cpu.sdf, g_cpu.valid()).numpy()
    tie = np.minimum(np.abs(sg), np.abs(sc_)) < 1e-6
    x, y, z = tie.shape
    tie_cube = np.zeros_like(act_c)
    for dx, dy, dz in marching._CORNERS:
        tie_cube |= tie[dx:x - 1 + dx, dy:y - 1 + dy, dz:z - 1 + dz]
    differ = act_g != act_c
    hold = dict(points=RECON_HOLD_POINTS, weight_rel_err=w_rel, sdf_abs_err_m=sdf_err,
                active_cubes=int(act_c.sum()), cubes_differ=int(differ.sum()),
                cubes_differ_not_tie=int((differ & ~tie_cube).sum()))
    log(f"[recon] splat on the card vs the CPU ({RECON_HOLD_POINTS} points): {json.dumps(hold)}")
    require(w_rel <= 1e-4 and sdf_err <= 1e-5 and hold["cubes_differ_not_tie"] == 0,
            f"recon: the card's splat differs from the CPU's: {hold}")
    del g_card, g_cpu

    # The dense mesh against the TLS cloud, and the evaluator's Chamfer.
    mesh = TriMesh.load(out_dir / "Area_1_office_1" / "mesh_dense.ply")
    samples = sample_points_on_mesh(mesh, MESH_SAMPLES, device=device)
    mesh_tls = tls_stats(samples, tls_tree, MESH_SAMPLES, seed=1)
    log(f"[recon] dense mesh ({mesh.num_triangles} faces), {MESH_SAMPLES} area-uniform "
        f"samples to the TLS cloud: {json.dumps(mesh_tls)}")
    require(mesh_tls["mean_m"] < 2 * RECON_VOXEL and mesh_tls["p95_m"] < 4 * RECON_VOXEL,
            f"recon: the mesh is off the TLS cloud: {mesh_tls}")
    n_sample = min(len(dense["points"]), 100_000)  # the evaluator's max_eval_points
    sampled = sample_points_poisson_disk(mesh, n_sample, device=device)
    ref = np.asarray(dense["points"])
    ref = ref[np.random.default_rng(0).choice(len(ref), n_sample, replace=False)]
    again = chamfer_distance_mean(ref, sampled, max_points=n_sample, device=device)
    a64 = ref.astype(np.float32).astype(np.float64)
    b64 = sampled.astype(np.float64)
    cd64 = (cKDTree(b64).query(a64, workers=-1)[0].mean()
            + cKDTree(a64).query(b64, workers=-1)[0].mean()) / 2
    reported = runs[-1]["variants"]["dense"]["chamfer_m"]
    chamfer = dict(reported_m=reported, again_m=again, float64_m=float(cd64),
                   rel_err=abs(reported - cd64) / cd64, samples=n_sample)
    log(f"[recon] evaluator Chamfer vs float64 cKDTree on the same subsets: "
        f"{json.dumps(chamfer)}")
    require(abs(again - reported) <= 1e-6 * reported,
            f"recon: the evaluator's subsets are not reproduced: {chamfer}")
    require(chamfer["rel_err"] <= 1e-4, f"recon: Chamfer off float64: {chamfer}")
    return dict(runs=runs, timing=timing, splat_hold=hold, mesh_tls=mesh_tls,
                chamfer=chamfer, card=card)


def phase_recon_sim(device, work: Path, card: str, tls_tree) -> dict:
    """The JAX bench's headline workload on the port: the sim stage over the
    reconstructed ``mesh_dense.ply`` with the dense 32-line profile, 20
    waypoints, labels from the preprocess room, the pair kernels; held to
    the raycast contract against the oracle and to the TLS cloud."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator, run_single_scene_simulation
    from ipcgen_tpu_torch.utils.device import sync

    mesh_path = work / "recon_out" / "Area_1_office_1" / "mesh_dense.ply"
    data_root = work / "pre_s3dis"
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    sc = run_single_scene_simulation(
        str(mesh_path), scene_name="recon_dense32", num_waypoints=20,
        output_base_dir=str(work / "recon_sim"), use_blk2go=False, use_dense_lidar=True,
        s3dis_data_root=str(data_root), area="Area_1", room="office_1", seed=0,
        device=device)
    sync(device)
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    mesh = TriMesh.load(mesh_path)
    v, t = mesh.vertices.astype(np.float32), mesh.triangles.astype(np.int32)
    intr = S3DISSimulator({}, use_dense_lidar=True, device=device).lidar_config
    rays = len(sc.frames) * intr.get_total_points_per_scan()
    n_points = [len(f.points) for f in sc.frames]
    stages = {k: round(float(x), 4) for k, x in sorted(sc.profile.items())}
    rate = rays / (stages["dispatch"] + stages["scan_exec"])
    log(f"[recon-sim] recon mesh {len(t)} faces, dense-32: {len(sc.frames)} frames, {rays} "
        f"rays, {sum(n_points)} points, {wall:.2f} s wall, launches {launches}; stage "
        f"seconds on {card}: {json.dumps(stages)}; {rate:.0f} rays/s over dispatch + "
        f"scan_exec")
    require(launches["raycast_pairs"] == 1 and launches["raycast_pairs_prepass"] == 1
            and launches["raycast_culled"] == 0,
            f"recon-sim: one prepass and one walk launch expected: {launches}")
    require(len(sc.frames) > 0 and min(n_points) > 0, "recon-sim: empty frame")
    ply = work / "recon_sim" / "recon_dense32" / "combined_pointcloud_with_label.ply"
    require(ply.is_file(), "recon-sim: labeled PLY missing")
    label_agree = check_labels(ply, data_root)
    log(f"[recon-sim] labels agree with cKDTree 1-NN on {label_agree:.5f}")
    require(label_agree >= 0.999, f"recon-sim: label agreement {label_agree}")
    hit_frac = sum(n_points) / rays
    scan = np.concatenate([f.points for f in sc.frames])
    scan_tls = tls_stats(scan, tls_tree, 100_000, seed=2)
    log(f"[recon-sim] hit fraction {hit_frac:.4f}; scan points to the TLS cloud "
        f"{json.dumps(scan_tls)}")
    require(hit_frac > 0.9, f"recon-sim: hit fraction {hit_frac}")
    require(scan_tls["mean_m"] < 2 * RECON_VOXEL and scan_tls["p95_m"] < 4 * RECON_VOXEL,
            f"recon-sim: the scan is off the TLS cloud: {scan_tls}")

    asset = build_scene_asset(v, t, device=device)
    contract, pairs = check_own_rays(asset, intr, sc, v[t], seed=0, device=device)
    log(f"[recon-sim] the run's rays cast again reproduce its frames; raycast contract vs "
        f"oracle {contract}")
    at_shape, prepass = pair_kernels_at_shape(asset, pairs, "recon_dense32", rays,
                                              "recon-sim")
    return dict(launches=launches, wall_s=wall, rays=rays, frames=len(sc.frames),
                points=n_points, stages=stages, rays_per_s=rate, faces=int(len(t)),
                hit_fraction=hit_frac, scan_tls=scan_tls, label_agree=label_agree,
                contract=contract, kernel=at_shape, prepass=prepass)


# S3DIS class ids of the simulated labels -> LiDAR-Net ids, by class name.
def lidar_net_ids(sem: np.ndarray) -> np.ndarray:
    from ipcgen_tpu_torch.bbox.detection import LIDAR_NET_SEMANTIC_MAPPING
    from ipcgen_tpu_torch.semantic.annotations import S3DIS_CLASS_IDS

    out = np.zeros_like(sem)
    for name, ln_id in LIDAR_NET_SEMANTIC_MAPPING.items():
        if name in S3DIS_CLASS_IDS:
            out[sem == S3DIS_CLASS_IDS[name]] = ln_id
    return out


def check_box(box: dict, pts64: np.ndarray, device, label: str) -> None:
    """A box must equal the float64 AABB of its points after the outlier
    removal, and lie inside the room."""
    from ipcgen_tpu_torch.ops.outliers import remove_statistical_outliers
    from ipcgen_tpu_torch.utils.synthetic import ROOM_SIZE

    if len(pts64) >= 20:
        mask, _ = remove_statistical_outliers(pts64, nb_neighbors=20, std_ratio=2.0,
                                              device=device)
        pts64 = pts64[mask]
    require(np.array_equal(box["min_coords"], pts64.min(axis=0))
            and np.array_equal(box["max_coords"], pts64.max(axis=0))
            and box["point_count"] == len(pts64), f"{label}: box differs from float64: {box}")
    require(np.all(box["min_coords"] >= -0.05)
            and np.all(box["max_coords"] <= np.asarray(ROOM_SIZE) + 0.05),
            f"{label}: box outside the room: {box}")


def phase_bbox_eval(device, work: Path, card: str) -> dict:
    """The bbox stage on the preprocess room's annotations and on the recon
    scan's labeled PLY (its S3DIS class ids written as LiDAR-Net ids), then
    ``find_best_match`` of the recon scan against a LiDAR-Net layout holding
    the dense-32 scan of the true mesh (``phase_main_path``): the downstream
    fidelity metric.  MMD, CD and HD held to float64 on the same subsets."""
    import torch
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch.bbox.detection import LiDARNetBBoxVisualizer, S3DISBBoxVisualizer
    from ipcgen_tpu_torch.eval.evaluate import analyze_point_cloud, find_best_match, \
        load_point_cloud
    from ipcgen_tpu_torch.io.ply import read_labeled_ply, write_labeled_ply
    from ipcgen_tpu_torch.ops import metrics

    room_dir = work / "pre_s3dis" / "Area_1" / "office_1"
    t0 = time.time()
    boxes = S3DISBBoxVisualizer(results_root=str(work / "bbox_out" / "s3dis"),
                                device=device).visualize_room_bboxes(room_dir)
    s3dis_s = time.time() - t0
    require(boxes, "bbox: no S3DIS box")
    for b in boxes:
        pts = np.loadtxt(room_dir / "Annotations" / b["file_name"], ndmin=2)[:, :3]
        check_box(b, pts, device, f"S3DIS {b['file_name']}")

    scan_ply = work / "recon_sim" / "recon_dense32" / "combined_pointcloud_with_label.ply"
    pts, colors, sem, ins = read_labeled_ply(scan_ply)
    ln_ply = work / "ln_scan" / "Area_1_office_1.ply"
    ln_ply.parent.mkdir(parents=True)
    write_labeled_ply(ln_ply, pts, colors, lidar_net_ids(sem), ins)
    t0 = time.time()
    ln_vis = LiDARNetBBoxVisualizer(results_root=str(work / "bbox_out" / "lidar_net"),
                                    device=device)
    ln_boxes = ln_vis.process_room_instances(ln_ply)
    ln_s = time.time() - t0
    require(ln_boxes, "bbox: no LiDAR-Net box")
    ln_sem = lidar_net_ids(sem)
    for b in ln_boxes:
        sel = (ln_sem == b["semantic_id"]) & (ins == b["instance_id"])
        check_box(b, pts[sel].astype(np.float64), device,
                  f"LiDAR-Net {b['object_name']} {b['instance_id']}")
    log(f"[bbox] {len(boxes)} S3DIS boxes in {s3dis_s:.2f} s, {len(ln_boxes)} LiDAR-Net boxes "
        f"from the recon scan in {ln_s:.2f} s; each equal to a float64 AABB of its points "
        f"and inside the room")

    # The downstream fidelity metric: the recon scan against the scan of
    # the true mesh, as a LiDAR-Net scene.
    true_dir = work / "lidar_net" / "synth_dense32"
    true_dir.mkdir(parents=True)
    shutil.copyfile(work / "out" / "synth_dense32" / "combined_pointcloud_with_label.ply",
                    true_dir / "synth_dense32.ply")
    t0 = time.time()
    match = find_best_match(str(scan_ply), str(work / "lidar_net"), device=device)
    match_s = time.time() - t0
    require(match is not None and match["lidar_net_scene"] == "synth_dense32",
            f"eval: no match: {match}")
    log(f"[eval] find_best_match in {match_s:.2f} s: "
        f"{json.dumps({k: v for k, v in match.items() if not isinstance(v, str)})}")

    x = analyze_point_cloud(load_point_cloud(str(scan_ply)), "S3DIS")["normalized_points"]
    y = analyze_point_cloud(load_point_cloud(str(true_dir / "synth_dense32.ply")),
                            "LiDAR-Net")["normalized_points"]
    held = {}
    for name, n in (("mmd", 10_000), ("cd", 5000), ("hd", 3000)):
        rng = np.random.default_rng(7)
        xs, ys = (metrics.sample_points(c, n, rng).astype(np.float32) for c in (x, y))
        xd, yd = (torch.from_numpy(c).to(device) for c in (xs, ys))
        x64, y64 = xs.astype(np.float64), ys.astype(np.float64)
        if name == "mmd":
            got = metrics.compute_mmd(x, y, n, rng=np.random.default_rng(7), device=device)
            ms = time_ms(lambda: metrics._mmd_core(xd, yd, 1.0), 3)

            def kmean(a, b):
                return sum(np.exp(-((a[i:i + 500, None, :] - b[None]) ** 2).sum(-1)).sum()
                           for i in range(0, len(a), 500)) / (len(a) * len(b))
            want = kmean(x64, x64) + kmean(y64, y64) - 2 * kmean(x64, y64)
            err, ok = abs(got - want), abs(got - want) <= 1e-6
        else:
            fn = metrics.compute_chamfer_distance if name == "cd" else \
                metrics.compute_hausdorff_distance
            got = fn(x, y, n, rng=np.random.default_rng(7), device=device)
            ms = time_ms(lambda: (metrics._directed_min_dists(xd, yd).sum()
                                  + metrics._directed_min_dists(yd, xd).sum()), 5)
            d_xy = cKDTree(y64).query(x64, workers=-1)[0]
            d_yx = cKDTree(x64).query(y64, workers=-1)[0]
            want = d_xy.mean() + d_yx.mean() if name == "cd" else max(d_xy.max(), d_yx.max())
            err = abs(got - want) / want
            ok = err <= 1e-4
        pairs = len(xs) * len(ys) * (3 if name == "mmd" else 2)
        held[name] = dict(points=n, value=got, float64=float(want), err=float(err), ms=ms,
                          pairs=pairs)
        log(f"[eval] {name} ({n} points): {got:.8f} vs float64 {want:.8f} "
            f"({'abs' if name == 'mmd' else 'rel'} err {err:.3e}); {ms:.3f} ms on {card}")
        require(ok, f"eval: {name} off float64: {held[name]}")
    return dict(s3dis_boxes=len(boxes), lidar_net_boxes=len(ln_boxes), s3dis_box_s=s3dis_s,
                lidar_net_box_s=ln_s, match={k: v for k, v in match.items()
                                             if not isinstance(v, str)},
                match_s=match_s, metrics=held)


def main() -> int:
    import torch

    import ipcgen_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.utils.device import card_line

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    nvcc = subprocess.run([_kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc}")
    log(f"[env] card: {card}")

    t0 = time.time()
    _kernels.build()
    log(f"[build] {len(_kernels.SOURCES)} sources ({len(_kernels.KERNELS)} kernels) built "
        f"(one nvcc each, in parallel) and loaded in {time.time() - t0:.2f} s; seconds per source "
        f"{json.dumps({k: round(v, 2) for k, v in _kernels.BUILD_SECONDS.items()})}")

    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    v, t = synthetic_room(TRIANGLES_KERNEL_CHECK)
    asset = build_scene_asset(v, t, device=device)
    log(f"[kernel] room: {len(t)} triangles, {asset.num_blocks} blocks")
    checks, prepass_checks = phase_kernel_check(device, asset)
    culled_checks = phase_culled_kernel_check(device, asset)
    probe = phase_probe(device, asset)
    del asset
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        runs, culled, occupancy, batch = phase_main_path(device, work, card)
        preprocess = phase_preprocess(device, work, card)
        tls_tree = tls_tree_of(work)
        recon = phase_recon(device, work, card, tls_tree)
        runs["recon_dense32"] = phase_recon_sim(device, work, card, tls_tree)
        bbox_eval = phase_bbox_eval(device, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[summary] batch {json.dumps({k: v for k, v in batch.items() if k != 'rooms'})}; "
        f"preprocess warm spans {json.dumps(preprocess['runs'][-1]['spans'])}")
    log(f"[summary] recon warm {json.dumps(recon['runs'][-1]['variants'])}; splat and "
        f"marching {json.dumps(recon['timing'])}")
    rs = runs["recon_dense32"]
    log(f"[summary] recon mesh scan: {rs['faces']} faces, {rs['rays']} rays, "
        f"{rs['rays_per_s']:.0f} rays/s, stages {json.dumps(rs['stages'])}; bbox and eval "
        f"{json.dumps(bbox_eval)}")

    # Every main-path run: the two pair runs of phase_main_path and the
    # scan of the recon mesh.
    launches = sum(r["launches"]["raycast_pairs"] for r in runs.values())
    prepass_launches = sum(r["launches"]["raycast_pairs_prepass"] for r in runs.values())
    at_shape = runs["blk2go"]["kernel"]  # the default profile
    prepass = runs["blk2go"]["prepass"]
    yardstick = {"library_ms": None}  # no PyTorch call computes a nearest hit
    bound_keys = ("bound_ms", "bound_by")
    record = {"kernels": [{
        "name": "raycast_pairs_kernel",
        "route": "cuda",
        "source": "ipcgen_tpu_torch/csrc/raycast_pairs.cu",
        "replaces": "ipcgen_tpu/ops/raycast_mxu.py:619",
        "also_replaces": "ipcgen_tpu/ops/raycast_mxu.py:470",
        "launches": launches,
        "max_abs_err": max(*(r["kernel"]["max_abs_err"] for r in runs.values()),
                           *(c["max_abs_err"] for c in checks.values())),
        "ms": at_shape["ms"],
        "plain_ms": at_shape["plain_ms"],
        **{k: at_shape[k] for k in bound_keys}, **yardstick,
        "main_path_inputs": {
            k: {"rays": r["kernel"]["rays"], "ms": r["kernel"]["ms"],
                "plain_ms": r["kernel"]["plain_ms"], "bound_ms": r["kernel"]["bound_ms"],
                "tests_run": r["kernel"]["tests_run"],
                "exact_list_tests": r["kernel"]["exact_list_tests"]}
            for k, r in runs.items()},
        "occupancy": occupancy,
    }, {
        "name": "pairs_prepass_kernel",
        "route": "cuda",
        "source": "ipcgen_tpu_torch/csrc/raycast_pairs.cu",
        "replaces": "ipcgen_tpu/ops/raycast_mxu.py:297",
        "replaces_note": "not a Pallas kernel (XLA candidate_blocks)",
        "launches": prepass_launches,
        "max_abs_err": 0.0,
        "ms": prepass["ms"],
        "plain_ms": prepass["plain_ms"],
        **{k: prepass[k] for k in bound_keys}, **yardstick,
        "bound_set_by": "per-ray floor slab tests (prepass_floors: every mega, the groups "
                        "of the megas each ray enters, the blocks of the groups it enters) "
                        f"x {SLAB_OPS} fp32 issue slots a test (slab_fast)",
        "fp32_issue_slots_per_s": prepass["ops_per_s"],
        "bound_tile_ms": prepass["bound_tile_ms"],
        "bound_two_level_ms": prepass["bound_two_level_ms"],
        "floor_tests": prepass["floor_tests"],
        "stage_tests": prepass["stage_tests"],
        "main_path_inputs": {
            k: {key: r["prepass"][key] for key in
                ("rays", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tile_ms",
                 "bound_two_level_ms", "slab_tests", "stage_tests", "floor_tests",
                 "two_level_slab_tests", "pairs")}
            for k, r in runs.items()},
        "kernel_check_inputs": {
            k: {key: c[key] for key in ("rays", "ms", "plain_ms", "bound_ms", "bound_tile_ms",
                                        "bound_two_level_ms", "stage_tests", "floor_tests",
                                        "pairs")}
            for k, c in prepass_checks.items()},
    }, {
        "name": "raycast_culled_kernel",
        "route": "cuda",
        "source": "ipcgen_tpu_torch/csrc/raycast_culled.cu",
        "replaces": "ipcgen_tpu/ops/raycast_pallas.py:41",
        "launches": culled["launches"]["raycast_culled"],
        "max_abs_err": max(culled["kernel"]["max_abs_err"],
                           *(c["max_abs_err"] for c in culled_checks.values())),
        # The main path's own call: all the culled run's rays.
        "ms": culled["full_scan_ms"],
        "plain_ms": culled["kernel"]["plain_ms"],
        "plain_ms_rays": culled["kernel"]["rays"],
        **{k: culled["full_scan_bound"][k] for k in bound_keys}, **yardstick,
        "rays": culled["full_scan_rays"],
        "bound_set_by": "per-ray floor tests x the kernel's mean fp32 issue slots per test "
                        f"({culled['full_scan_bound']['ops_per_test']:.2f}, divide "
                        f"{DIVIDE_SASS})",
        "fp32_issue_slots_per_s": culled["full_scan_bound"]["ops_per_s"],
        "visits": culled["full_scan_counts"]["visits"],
        "tests": culled["full_scan_counts"]["tests"],
        **{k: culled["full_scan_counts"][k] for k in
           ("past_det", "past_u", "past_v", "divides")},
        "super_visits": culled["full_scan_counts"]["super_visits"],
        "per_ray_floor_tests": culled["full_scan_floors"]["per_ray_tests"],
        "warp_floor_visits": culled["full_scan_floors"]["warp_visits"],
        "group256_floor_visits": culled["full_scan_floors"]["group256_visits"],
        "main_path_inputs": {
            "blk2go_culled_subset": {k: culled["kernel"][k] for k in
                                     ("rays", "ms", "plain_ms", "bound_ms", "counts",
                                      "floors")}},
        "kernel_check_inputs": {
            k: {key: c[key] for key in ("rays", "ms", "plain_ms", "bound_ms", "counts",
                                        "floors")}
            for k, c in culled_checks.items()},
    }]}
    from ipcgen_tpu_torch.ops.raycast_probe import MODES, RESULT_MODES

    res, chk = probe["results"], probe["checks"]
    for name, source_line, launch_key, result_names in (
            ("probe_call_kernel", "scripts/kernel_probe.py:119", "raycast_probe_call", MODES),
            ("probe_grid_kernel", "scripts/kernel_probe.py:342", "raycast_probe_grid",
             ("grid32",)),
            ("probe_flat_kernel", "scripts/kernel_probe.py:486", "raycast_probe_flat",
             ("flat",))):
        head = result_names[0]  # call: its "full" mode
        entry = {
            "name": name, "route": "cuda",
            "source": "ipcgen_tpu_torch/csrc/raycast_probe.cu",
            "replaces": source_line,
            "launches": probe["launches"][launch_key],
            "max_abs_err": max(chk[n]["max_abs"] for n in result_names
                               if n in RESULT_MODES + ("grid32", "flat", "nodma")),
            "ms": res[head]["ms"],
            "plain_ms": chk[head]["plain_ms"],
            **{k: probe["bounds"][launch_key.rsplit("_", 1)[1]][k] for k in bound_keys},
            **yardstick,
            "rays": probe["rays"],
            "plain_subset_tiles": probe["subset_tiles"],
            "modes": {n: {"ms": res[n]["ms"], "plain_ms": chk[n]["plain_ms"],
                          "pairs": res[n]["pairs"]} for n in result_names},
        }
        if name == "probe_call_kernel":
            entry["also_replaces"] = "scripts/kernel_probe.py:32"
            entry["schedule"] = probe["schedule"]
        record["kernels"].append(entry)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
