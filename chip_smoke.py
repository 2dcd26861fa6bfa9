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
   S3DIS-format TLS room written from the same surfaces, then what
   ``run_single_scene_simulation`` runs, with the pair kernel selected
   through the config (``raycast_engine.backend: mxu``; ``run_scene``), with
   the BLK2GO profile and again with the dense 32-line profile (20
   requested waypoints; the planner densifies them to 40).  Each run must
   launch the pair kernels, give every frame points and
   write the labeled PLY; the labels of 100 k sampled points must equal a
   scipy cKDTree 1-NN into the TLS cloud on >= 99.9 %.  Then the run's own
   rays are rebuilt from its poses and seed and cast again exactly as the
   scan casts them (patch order, unsorted, 2048-ray tiles): that must give
   back every frame's points, and ten whole tiles of it (20,480 rays) must
   meet the raycast contract against the brute oracle
   on the card (hit masks agree >= 99 %, same triangle >= 99 %, hit-point
   error p99 <= 5 mm and max <= 5 cm), half of them from tiles that JAX's
   caps on its candidate lists overflow (the rays that took its walk-all
   fallback).  A ray over the 5 cm bound, or hit on one side only, passes
   only where float64 Moller-Trumbore (closed) on the asset's own v0, e1,
   e2 of the two triangles sides with the pair kernel (``f64_sides_with``),
   and such rays stay under 0.1 % of the rays.  The prepass kernel and the
   pair kernel are also held against their plain versions on those same
   inputs of each run (the walk's counting launch gives the same bits and
   the share of its tests that float64 decided), and the ray-triangle
   tests the pair kernel runs must equal those of the exact lists: no
   subtile walks every block.
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
   raycast contract's 5 mm, its split's rounding).  The probe keeps the JAX
   walk's open edge test in float32, so a ray whose slots differ counts as
   agreeing where one of the two triangles has a side within the pair
   walk's float32 band (``in_pair_band``) and float64 sides with the pair
   kernel, at most 0.1 % of the rays; besides, the raw share on the same
   slot must be >= 99.9 % and every ray hit by one and not the other must
   be so settled.  Runs after phase 5, on the same room.
8. raycast occupancy (``trajectory.occupancy_mode: raycast``):
   ``obstacle_mask`` on the planning grid of the main room through the pair
   kernel must equal the brute oracle's mask on >= 99.9 % of cells.  Runs
   inside phase 4, after the two pair runs.
9. the batch entry point (``phase_batch``): ``sim.simulator.main`` over a
   reconstruction directory of two rooms, the main room (``Area_1_office_1``)
   and ``synthetic_room(700_000, seed=1)`` (``Area_1_office_2``) with its own
   600 k TLS room, BLK2GO, 20 requested waypoints, the asynchronous export,
   both rooms' labels prewarmed (``prewarm_labels``).  Both rooms must
   succeed, each must claim its prewarm, one scan a room must launch the
   kernel "auto" selects (counts read after the last export drained), the
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
   headline workload, the sim stage (``run_scene``, backend ``mxu``) of the
   recon ``mesh_dense.ply`` with the dense 32-line profile, 20 waypoints and
   the preprocess room's labels.  The prepass and the walk must launch once
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
14. the culled kernel on the dense 32-line main-room run (``backend:
   pallas``, inside phase 6's step): one launch, every frame within 1 % of
   the pair kernel's dense-32 run, stage seconds and rays per second.
15. the pipeline driver (``phase_pipeline``): ``run_pipeline.run`` over two
   S3DIS-layout rooms from ``bench_pipeline.synth_room`` (600 k shell points
   each) with the shipped config's values (voxel 0.03, BLK2GO, 20
   waypoints), figures off, and each room's TLS cloud as a LiDAR-Net scene
   for the eval stage: all five stages done for both rooms, one scan a room
   on the kernel "auto" selects (``auto_launches``), a second call that
   skips every stage, each
   labeled PLY walked by the release gate's reference reader; stage seconds
   and rooms per hour.
16. the release gate (``phase_release_gate``): ``release_gate_lroom.run_gate``
   on tests/fixtures/golden_room_l, two passes, its parity checks, cold and
   steady seconds; one scan a pass on the kernel "auto" selects.
17. the multi-device paths (``phase_multidevice``): an NCCL group of one rank
   through a ``FileStore``; ``scan_waypoints_sharded`` of the main room
   (BLK2GO, 20 waypoints) on the pair and the culled kernel, equal to
   ``scan_waypoints`` bit for bit; the triangle-sharded raycast of all its
   rays with S = 2 and 4 shard-local launches combined in this process
   (``parallel.shard``'s pieces), the culled kernel's equal bit for bit to
   the unsharded kernel, the pair kernel's held to the raycast contract
   against the unsharded pair run (over 5 cm on at most 0.1 % of the rays)
   and against the brute oracle (``pair_shards_vs_oracle``: the ten tiles
   ``check_own_rays`` draws plus every ray whose shard hit is over 5 cm
   from the unsharded run's or on one side only; a ray over 5 cm from the
   oracle or hit on one side only passes where float64 sides with the
   shards (``f64_sides_with``), at most 0.1 %);
   ``run_scenes_device_parallel`` on [cuda:0, cuda:0] over phase 9's two
   rooms, their clouds equal byte for byte to the sequential ``main``'s;
   ``sharded_grid_nn`` of scan points into the TLS cloud equal to the
   one-card 1-NN; the dry run (``parallel.dryrun``) at world size 1.
18. the port's bench (``phase_bench``): ``bench.run`` at the JAX bench's
   sizes (box, incoherent unsorted and sorted, open scene, recon mesh,
   BLK2GO x 80, each on both kernels; the CPU baseline in a child process):
   its line parses and fits 1,900 characters, every workload has both
   kernels' figures with min <= median <= max, each pair call launched one
   prepass and one walk and each culled call one culled kernel, the two
   kernels' hit masks agree >= 99 % and hit points p99 <= 5 mm where they
   cast the same rays, the recon mesh has faces, the CPU baseline ran; on
   20,480 sampled open-scene rays the culled kernel's misses equal the
   brute oracle's, and each ray where the pair kernel's differ is one where
   float64 sides with the pair kernel; so is each of the open scene's
   2.56 M rays and of the 2.56 M incoherent rays whose pair hit is over
   5 cm from the culled kernel's or on one side only, and off the oracle's
   triangle (``pairs_vs_culled_adjudicated``).
19. the label-transfer probe (``phase_label_probe``): 2.56 M queries x
   630 k references, every piece of the grid 1-NN and of ``LabelGrid``
   timed; the instrumented 1-NN equal to the library call on every row, its
   distances on 100 k sampled queries equal to a float64 cKDTree's within
   1e-6 m, ``LabelGrid`` at the library's distances.
20. the exact 1-NN kernel (``phase_nn_exact``, ``csrc/nn_exact.cu``) at the
   label residue's shapes, 20,000 and 48,000 queries (the BLK2GO and dense
   32-line rooms' residue rows) against 1,300,000 references: indices equal
   to its plain version's on every row, both timed with CUDA events (the
   kernel warm, the L2 flushed before each launch), the bound
   ``NN_OPS_PER_PAIR`` issue slots a pair; and the kernel alone at 500,000
   x 2,600,000 (a room at S3DIS's density, where a fifth of the hits would
   reach the residue).
21. the scene asset's build (``phase_scene_asset``) and the label
   prefetch's build on the card (``phase_label_build``) at the benchmark's
   office (1.4 M triangles; 1.3 M TLS points): the colour join's indices
   and matches, the label grid's ``h0``, tables, counts and slot ids bit for
   bit the numpy build's, and 200,000 queries' indices from the card's grid
   equal to the host-built grid's; the join (from its device keys and from
   the host arrays) and the grid build (from the host array, the upload
   included) timed warm with CUDA events against the bytes they must move
   over 3.35 TB/s; each build's peak device memory and what its result
   holds.

Each phase's seconds are logged.  The launch checks of the batch, the
pipeline, the release gate and the room-parallel driver follow the kernel
that "auto" selects (``auto_launches``).

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
Every sim-stage call passes ``save_visualizations=False``: the card's host
has no matplotlib, and a figure asked for there raises.
The second-to-last line is the kernels' JSON record (each kernel's
``launches`` summed over the paths that ran it, ``launches_by_path`` each
path's own count; the bench's paths are ``bench_<workload>_<kernel>``;
``nn_exact_kernel`` also gives each sim path's residue rows, the launches
of its own check phase as ``check_calls``, and the rows where it differed
from its plain version there as ``rows_off``; the scene asset's two
launches, checked by ``phase_scene_asset`` at the benchmark's 1.4 M-triangle
office against the plain version and the numpy build bit for bit, close
it), the last line ``{"ok": true, "device": {...}}``.  Needs
``torch.cuda.is_available()``.
"""

from __future__ import annotations

import contextlib
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
# the slow path and its BSSY / BSYNC: the SASS of __fdiv_rn(1.0f, x) built
# as the culled source is).
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


def kernel_vs_plain(p: dict, label: str, kernel_reps: int = 5) -> dict:
    """Run the kernel and the plain version on the same inputs; check the
    stated tolerance and time both."""
    import torch

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_pairs import raycast_pairs_plain

    t_k, s_k = _kernels.raycast_pairs_cuda(p)
    n_f64 = torch.zeros(1, dtype=torch.int64, device=p["f"].device)
    t_c, s_c = _kernels.raycast_pairs_cuda(p, f64_count=n_f64)
    # The plain version takes seconds: its one checked call is also timed.
    (t_p, s_p), plain_ms = timed_once(lambda: raycast_pairs_plain(p))
    counted_same = bool(torch.equal(t_c, t_k) and torch.equal(s_c, s_k))
    tests = int(p["blocks"].numel()) * p["sub"] * (p["trif"].shape[2] // 5)
    f64_tests = int(n_f64)
    same = (s_k == s_p)
    same_frac = float(same.float().mean())
    hit = same & (s_k >= 0)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-12))[hit]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    max_abs = float((t_k - t_p).abs()[hit].max()) if hit.any() else 0.0
    ms = time_ms(lambda: _kernels.raycast_pairs_cuda(p), kernel_reps)
    n_rays = p["f"].shape[0]
    log(f"[kernel] {label}: rays {n_rays} subtiles {p['offsets'].numel() - 1} "
        f"pairs {p['blocks'].numel()} | same slot "
        f"{same_frac:.6f} max rel t err {max_rel:.3e} | kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms | float64 edge decisions {f64_tests} of {tests} "
        f"tests ({f64_tests / max(tests, 1):.3e})")
    require(same_frac >= 0.9999, f"{label}: same slot on {same_frac:.6f} < 0.9999")
    require(max_rel <= 1e-5, f"{label}: t rel err {max_rel:.3e} > 1e-5")
    require(counted_same, f"{label}: the counting launch differs from the walk")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
                same_slot=same_frac, rays=n_rays, f64_tests=f64_tests, walk_tests=tests,
                f64_share=f64_tests / max(tests, 1))


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
    out["incoherent_256k"] = kernel_vs_plain(p, "incoherent 256k (sorted)")
    p = prepare_pairs(o[:8192], d[:8192], *comps, t_max=MAX_RANGE)
    # Every subtile walks every block: expand_walk_all lists them all.
    p["offsets"], p["blocks"] = expand_walk_all(
        p["offsets"], p["blocks"],
        torch.ones(p["offsets"].numel() - 1, dtype=torch.int32, device=device),
        asset.num_blocks)
    require(p["blocks"].numel() == (p["offsets"].numel() - 1) * asset.num_blocks,
            "the forced walk-all list does not list every block")
    out["walk_all_8k"] = kernel_vs_plain(p, "forced walk-all 8k", kernel_reps=2)
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


# The probe against the pair kernel, beside probe_tolerance's limits (which
# hold once the rays float64 settles for the pair kernel count as agreeing):
# the least raw share of rays on the same slot.
PROBE_RAW_SAME_SLOT = 0.999


def in_pair_band(p: dict, rays, slots):
    """(n,) bool: has the pair walk's float32 test of rows ``rays`` of ``p``
    (``prepare_pairs``' dict) against packed ``slots`` (-1: no triangle,
    False) a side within ``side_band`` of 0 on den's side, so that float64
    decides it?  The five products are summed here in another order than
    the walk's, which moves them by far less than the band."""
    import torch

    from ipcgen_tpu_torch.ops.raycast_pairs import ray_band_terms, side_band

    tb = p["trif"].shape[2] // 5
    s = slots.clamp(min=0).long()
    b = s // tb
    cols = (s % tb)[:, None] + tb * torch.arange(5, device=s.device)  # (n, 5)
    f = p["f"][rays]
    g = torch.einsum("nk,njk->nj", f, p["trif"][b[:, None], :, cols])  # (n, 5)
    sign = torch.where(torch.signbit(g[:, 4]), -1.0, 1.0)[:, None]
    lo = (g[:, 0:3] * sign).amin(dim=1)
    band = side_band(p["radius"][b], *ray_band_terms(f))
    return (slots >= 0) & (lo >= -band) & (lo <= band)


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
    from ipcgen_tpu_torch.ops.raycast_pairs import intersect_pairs, prepare_pairs

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

    # The result modes and flat against the pair kernel, on every ray, as
    # raycast_pairs_components casts them unsorted.
    p = prepare_pairs(run["origins"], run["dirs"], asset.tri_data, asset.block_lo,
                      asset.block_hi, t_max=base["t_init"])
    t_ref, s_ref = (x[:p["n"]] for x in intersect_pairs(p))
    # The probe keeps the JAX walk's open edge test in float32; the pair
    # kernel's is closed, and float64 decides within the float32 band.  A ray
    # where their slots differ is settled for the pair kernel only where one
    # of the two triangles has a side within the band (the pair kernel's
    # float64 took that decision) and float64 sides with the pair kernel.
    # The raw share and the settled count are held too, and every ray hit by
    # one and not the other must be settled, so a probe that drops hits
    # cannot pass.
    index = asset.tri_index
    ids_ref = torch.where(s_ref >= 0, index[s_ref.clamp(min=0).long()], -1)
    for name in rp.RESULT_MODES + ("flat",):
        t_q, s_q = results[name]["out"]
        got = rp.agreement(t_q, s_q, t_ref, s_ref)
        n = s_q.numel()
        differ = torch.nonzero(s_q != s_ref).flatten()
        band = (in_pair_band(p, differ, s_ref[differ])
                | in_pair_band(p, differ, s_q[differ])).cpu().numpy()
        ids_q = torch.where(s_q >= 0, index[s_q.clamp(min=0).long()], -1)
        sides = f64_sides_with(run["origins"][differ].cpu().numpy(),
                               run["dirs"][differ].cpu().numpy(), asset,
                               ids_ref[differ].cpu().numpy(), ids_q[differ].cpu().numpy(),
                               base["t_init"])
        settled = band & sides
        hit_q, hit_ref = (s_q[differ] >= 0).cpu().numpy(), (s_ref[differ] >= 0).cpu().numpy()
        got.update(same_slot_raw=got["same_slot"], slots_differ=int(differ.numel()),
                   in_band=int(band.sum()), f64_sides_with_pair_kernel=int(sides.sum()),
                   settled=int(settled.sum()),
                   same_slot=(n - differ.numel() + int(settled.sum())) / n,
                   hit_share_diff=float((s_q >= 0).float().mean()
                                        - (s_ref >= 0).float().mean()),
                   probe_miss_pair_hit=int((~hit_q & hit_ref).sum()),
                   pair_miss_probe_hit=int((hit_q & ~hit_ref).sum()),
                   hit_differ_unsettled=int(((hit_q != hit_ref) & ~settled).sum()))
        label = f"probe {name} vs the pair kernel"
        check_agreement(label, got, probe_tolerance(name, "pairs"))
        require(got["same_slot_raw"] >= PROBE_RAW_SAME_SLOT,
                f"{label}: raw same slot {got['same_slot_raw']} < {PROBE_RAW_SAME_SLOT}")
        require(got["settled"] <= MAX_GRAZE_FRAC * n,
                f"{label}: {got['settled']} settled rays, over {MAX_GRAZE_FRAC} of {n}")
        require(got["hit_differ_unsettled"] == 0,
                f"{label}: a ray hit by one and not the other that float64 does not "
                f"settle for the pair kernel: {got}")
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


MAX_GRAZE_FRAC = 1e-3  # rays a check may adjudicate, of the rays it holds


def tri_rows(asset, tri_ids: np.ndarray) -> np.ndarray:
    """(n, 9) float64 v0, e1, e2 of the asset's own float32 ``tri_data``
    for original triangle ids (-1: zeros)."""
    from ipcgen_tpu_torch.ops.reference_f64 import asset_rows

    rows, index = asset_rows(asset.tri_data, asset.tri_index)
    slot_of = np.full(max(int(index.max()) + 1, 1), -1)
    slot_of[index[index >= 0]] = np.flatnonzero(index >= 0)
    out = np.zeros((len(tri_ids), 9))
    ok = tri_ids >= 0
    out[ok] = rows[slot_of[tri_ids[ok]]]
    return out


def f64_sides_with(o, d, asset, tri_k: np.ndarray, tri_o: np.ndarray, t_max: float):
    """For rays where the pair kernel's triangle ``tri_k`` and the oracle's
    ``tri_o`` (original ids, -1 a miss) disagree: does float64
    Moller-Trumbore (closed) on the asset's own v0, e1, e2 side with the
    kernel?  It does when the kernel's triangle is hit and the oracle's is
    not nearer (the oracle erred inside its float32 band, or the two tie on
    a shared edge), or the kernel missed and the oracle's triangle is not
    hit.  Where a barycentric lies within EXACT_MARGIN of 0, or the two t
    within EXACT_MARGIN relative, rational arithmetic decides that ray
    (``closed_exact``): float64 Moller-Trumbore is not watertight on an
    edge.  Both references are ``ops/reference_f64.py``'s.  (n,) bool."""
    from ipcgen_tpu_torch.ops.reference_f64 import EXACT_MARGIN, closed_exact, closed_mt64

    rows_k, rows_o = tri_rows(asset, tri_k), tri_rows(asset, tri_o)
    hk, tk, nk = closed_mt64(o, d, rows_k, t_max)
    ho, to, no = closed_mt64(o, d, rows_o, t_max)
    hk &= tri_k >= 0
    ho &= tri_o >= 0
    out = np.where(tri_k >= 0, hk & (~ho | (tk <= to)), ~ho)
    with np.errstate(invalid="ignore"):
        tie = hk & ho & (np.abs(tk - to) <= EXACT_MARGIN * np.maximum(tk, to))
    for i in np.flatnonzero(((nk & (tri_k >= 0)) | (no & (tri_o >= 0)) | tie)):
        ek, ok_t = closed_exact(o[i], d[i], rows_k[i], t_max) if tri_k[i] >= 0 else (False, None)
        eo, oo_t = closed_exact(o[i], d[i], rows_o[i], t_max) if tri_o[i] >= 0 else (False, None)
        out[i] = (ek and (not eo or ok_t <= oo_t)) if tri_k[i] >= 0 else not eo
    return out


def contract_tiles(p: dict, n_rays: int, n_tiles: int, device):
    """``n_tiles`` whole tiles of ``prepare_pairs``' tiling of ``n_rays``
    rays, half from tiles that JAX's caps overflow (its walk-all fallback's
    rays): (ray indices on ``device``, tiles, overflowed tiles drawn, the
    overflow flags of every whole tile)."""
    import torch

    tile = p["tile"]
    over_cap = p["overflow"][:n_rays // tile].cpu().numpy()
    rng = np.random.default_rng(4)
    ovf, lst = np.flatnonzero(over_cap), np.flatnonzero(~over_cap)
    k_ovf = min(len(ovf), n_tiles // 2)
    tiles = np.sort(np.concatenate([rng.choice(ovf, k_ovf, replace=False),
                                    rng.choice(lst, n_tiles - k_ovf, replace=False)]))
    idx = torch.from_numpy((tiles[:, None] * tile + np.arange(tile)).reshape(-1)).to(device)
    return idx, tiles, k_ovf, over_cap


def check_own_rays(asset, intr, sc, seed: int, device, n_tiles: int = 10):
    """Rebuild the run's rays and cast them as the scan does; check that this
    gives back the run's frames, then hold ``n_tiles`` whole tiles of it to
    the raycast contract against the brute oracle, half of them from tiles
    that JAX's caps overflow; each ray over 5 cm from the oracle or hit on
    one side only must be one where float64 sides with the pair kernel
    (``f64_sides_with``).  Returns the contract figures and the pair
    kernel's inputs for those rays."""
    import torch

    from ipcgen_tpu_torch.ops.raycast import raycast_asset
    from ipcgen_tpu_torch.ops.raycast_pairs import prepare_pairs
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

    idx, tiles, k_ovf, over_cap = contract_tiles(p, o.shape[0], n_tiles, device)
    tile = p["tile"]
    ro = raycast_asset(o[idx], d[idx], asset, backend="brute", t_max=max_range)
    hk, ho = rk.hit[idx].cpu().numpy(), ro.hit.cpu().numpy()
    both = hk & ho
    tk, to = rk.tri_id[idx].cpu().numpy(), ro.tri_id.cpu().numpy()
    same = both & (tk == to)
    pk, po = rk.points[idx].cpu().numpy(), ro.points.cpu().numpy()
    pe = np.linalg.norm(pk[both] - po[both], axis=1)
    # Rays over the 5 cm bound or hit on one side only: float64 adjudicates.
    differ = np.flatnonzero(hk != ho)
    over = np.concatenate([np.flatnonzero(both)[pe > 0.05], differ])
    sel = idx.cpu().numpy()[over]
    sides = f64_sides_with(o[sel].cpu().numpy(), d[sel].cpu().numpy(), asset,
                           np.where(hk[over], tk[over], -1), np.where(ho[over], to[over], -1),
                           max_range)
    adjudicated = [dict(ray=int(r), kernel_tri=int(a), oracle_tri=int(b),
                        f64_sides_with_kernel=bool(w))
                   for r, a, b, w in zip(sel, np.where(hk[over], tk[over], -1),
                                         np.where(ho[over], to[over], -1), sides)]
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
               max_mm_without_adjudicated=float(pe_rest.max() * 1e3) if len(pe_rest)
               else 0.0,
               over_5cm=int((pe > 0.05).sum()), hit_differ=int(len(differ)),
               adjudicated=adjudicated)
    require(res["hit_agree"] >= 0.99, f"hit agreement {res}")
    require(res["same_tri"] >= 0.99, f"same triangle {res}")
    require(res["p99_mm"] <= 5.0, f"point error p99 {res}")
    require(bool(np.all(sides)), f"a ray off the oracle where float64 does not side with "
                                 f"the pair kernel: {res}")
    require(len(over) <= MAX_GRAZE_FRAC * idx.numel(), f"too many rays off the oracle: {res}")
    return res, p


def run_scene(mesh_path: Path, scene_name: str, out_base: Path, backend: str,
              data_root: Path, *, use_blk2go: bool, device, room: str = "office_1"):
    """What ``run_single_scene_simulation`` runs (BLK2GO or dense 32-line, 20
    requested waypoints, seed 0, figures off), with the config's
    ``raycast_engine.backend`` set to ``backend`` (a JAX name): the same
    config dict, simulator and auto-trajectory run."""
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    config = {
        "raycast_engine": {"use_gpu": True, "backend": backend},
        "trajectory": {"robot_height": 1.0},
        "enable_mesh_visualization": False,
        "s3dis_data_root": str(data_root),
        "area": "Area_1",
        "room": room,
        "seed": 0,
        "lidar": {"horizontal_res": None},
    }
    sim = S3DISSimulator(config, use_dense_lidar=not use_blk2go, use_blk2go=use_blk2go,
                         device=device)
    return sim.run_auto_simulation(str(mesh_path), num_waypoints=20,
                                   output_dir=Path(out_base) / scene_name,
                                   scene_name=scene_name, save_visualizations=False)


def auto_launches(n: int) -> dict:
    """The launches of ``n`` scans on the "auto" backend
    (``ops.raycast_backends.port_backend``): a prepass and a walk a scan on
    the pair kernel, one culled launch on the culled kernel."""
    from ipcgen_tpu_torch.ops.raycast_backends import port_backend

    pairs = port_backend("auto") == "pairs"
    return {"raycast_pairs": n * pairs, "raycast_pairs_prepass": n * pairs,
            "raycast_culled": n * (not pairs)}


def launched(launches: dict, want: dict) -> bool:
    return all(launches[k] == v for k, v in want.items())


def phase_main_path(device, work: Path, card: str):
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator
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
    runs = {}
    for profile in ("blk2go", "dense32"):
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        t0 = time.time()
        sc = run_scene(mesh_path, f"synth_{profile}", work / "out", "mxu", data_root,
                       use_blk2go=profile == "blk2go", device=device)
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
        contract, pairs = check_own_rays(asset, intr, sc, seed=0, device=device)
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
    culled["dense32"] = culled_dense32_run(device, work, card, mesh_path, data_root,
                                           runs["dense32"])
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
                               kernel_reps=3)
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
                                 output_dir=out_dir, scene_name="synth_culled",
                                 save_visualizations=False)
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


def culled_dense32_run(device, work: Path, card: str, mesh_path: Path, data_root: Path,
                       pair_run: dict) -> dict:
    """The dense 32-line run of the main room on the culled kernel
    (``backend: pallas``): one launch, every frame within 1 % of the pair
    kernel's run of the same rays, its stage seconds beside that run's."""
    from ipcgen_tpu_torch.config import PipelineConfig
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator
    from ipcgen_tpu_torch.utils.device import sync

    tree = PipelineConfig.from_dict({
        "simulation": {"backend": "pallas", "use_blk2go": False, "use_dense_lidar": True,
                       "seed": 0},
        "data": {"data_root": str(data_root), "area_name": "Area_1",
                 "room_name": "office_1"},
    })
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    sim = S3DISSimulator(tree.simulator_config(), use_blk2go=False, use_dense_lidar=True,
                         device=device)
    sc = sim.run_auto_simulation(str(mesh_path), num_waypoints=20,
                                 output_dir=work / "out" / "synth_culled_dense32",
                                 scene_name="synth_culled_dense32", save_visualizations=False)
    sync(device)
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    n_points = [len(f.points) for f in sc.frames]
    rays = len(sc.frames) * sim.lidar_config.get_total_points_per_scan()
    stages = {k: round(float(v), 4) for k, v in sorted(sc.profile.items())}
    rate = rays / (stages["dispatch"] + stages["scan_exec"])
    want = pair_run["points"]
    frame_dev = max(abs(a - b) / b for a, b in zip(n_points, want))
    log(f"[culled-dense32] {len(sc.frames)} frames, {rays} rays, {sum(n_points)} points "
        f"(pair run {sum(want)}, max frame deviation {frame_dev:.2e}), {wall:.2f} s wall, "
        f"launches {launches}; stage seconds on {card}: {json.dumps(stages)}; "
        f"{rate:.0f} rays/s over dispatch + scan_exec")
    require(launches["raycast_culled"] == 1 and launches["raycast_pairs"] == 0,
            f"culled dense-32 launches {launches}")
    require(len(n_points) == len(want) and frame_dev <= 0.01,
            f"culled dense-32 vs the pair run: {n_points} vs {want}")
    return dict(launches=launches, wall_s=wall, rays=rays, points=n_points, stages=stages,
                rays_per_s=rate)


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
              s3dis_data_root=str(data_root), async_export=True,
              save_visualizations=False, device=device)
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
    require(launched(launches, auto_launches(n)),
            f"batch: {auto_launches(n)} expected (the auto backend, a scan a room): "
            f"{launches}")
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
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator
    from ipcgen_tpu_torch.utils.device import sync

    mesh_path = work / "recon_out" / "Area_1_office_1" / "mesh_dense.ply"
    data_root = work / "pre_s3dis"
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    t0 = time.time()
    sc = run_scene(mesh_path, "recon_dense32", work / "recon_sim", "mxu", data_root,
                   use_blk2go=False, device=device)
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
    contract, pairs = check_own_rays(asset, intr, sc, seed=0, device=device)
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

# ---------------------------------------------------------------------------
# The pipeline driver, the release gate, the multi-device paths
# ---------------------------------------------------------------------------
PIPELINE_ROOMS = ("office_1", "office_2")
# The function each stage of run_pipeline.run calls, by module and name
# (run imports them at call time, so a wrapper set here is the one it calls).
PIPELINE_STAGE_CALLS = (
    ("preprocess", "ipcgen_tpu_torch.preprocess.loader", "preprocess_room"),
    ("recon", "ipcgen_tpu_torch.recon.cli", "reconstruct_room"),
    ("sim", "ipcgen_tpu_torch.sim.simulator", "run_single_scene_simulation"),
    ("bbox", "ipcgen_tpu_torch.bbox.detection", "S3DISBBoxVisualizer.visualize_room_bboxes"),
    ("eval", "ipcgen_tpu_torch.eval.evaluate", "find_best_match"),
)


@contextlib.contextmanager
def stage_seconds(device, sink: dict):
    """Append the seconds of every call of a pipeline stage's function to
    ``sink[stage]`` (each call ends with a barrier on ``device``)."""
    import importlib

    from ipcgen_tpu_torch.utils.device import sync

    saved = []
    for stage, module, name in PIPELINE_STAGE_CALLS:
        owner = importlib.import_module(module)
        if "." in name:
            cls, name = name.split(".")
            owner = getattr(owner, cls)
        fn = getattr(owner, name)

        def timed(*args, _fn=fn, _stage=stage, **kwargs):
            t0 = time.time()
            try:
                return _fn(*args, **kwargs)
            finally:
                sync(device)
                sink.setdefault(_stage, []).append(time.time() - t0)

        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield sink
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_pipeline(device, work: Path, card: str) -> dict:
    """``run_pipeline.run`` over two rooms in S3DIS layout made by
    ``bench_pipeline.synth_room`` (600 k shell points each), with the shipped
    config's values (``PipelineConfig``'s defaults: voxel 0.03, BLK2GO, 20
    waypoints) and the figures off; each room's TLS cloud is also a LiDAR-Net
    scene for the eval stage.  All five stages must be done for both rooms,
    with one prepass and one walk launch a room; a second call must skip
    every stage; each labeled PLY must pass the reference byte walk."""
    import os

    from ipcgen_tpu_torch.bench_pipeline import synth_room
    from ipcgen_tpu_torch.config import PipelineConfig
    from ipcgen_tpu_torch.io.ply import write_labeled_ply
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.release_gate_lroom import reference_read_labeled_ply
    from ipcgen_tpu_torch.run_pipeline import STAGES, run
    from ipcgen_tpu_torch.containers.sim_scene import _load_room_txt_pointcloud
    from ipcgen_tpu_torch.utils.device import sync

    root = work / "pipeline"
    rng = np.random.default_rng(0)
    t0 = time.time()
    sizes = {room: synth_room(root / "data", "Area_1", room, rng) for room in PIPELINE_ROOMS}
    for room in PIPELINE_ROOMS:
        cloud, _ = _load_room_txt_pointcloud(str(root / "data" / "Area_1" / room / f"{room}.txt"))
        cloud = cloud[::6].astype(np.float32)
        n = len(cloud)
        write_labeled_ply(root / "sim" / f"tls_{room}" / f"tls_{room}.ply", cloud,
                          np.full((n, 3), 128, np.uint8), np.zeros(n, np.uint16),
                          np.zeros(n, np.uint16))
    log(f"[pipeline] two synthetic rooms ({sizes}) written in {time.time() - t0:.1f} s "
        f"(host of {card})")
    cfg = PipelineConfig()
    cfg.data.data_root = str(root / "data")
    cfg.data.output_root = str(root / "outputs")
    cfg.data.area_name = "Area_1"
    cfg.data.room_name = None  # every room of the area
    cfg.simulation.output_base_dir = str(root / "sim")
    cfg.simulation.save_visualizations = False
    cwd = os.getcwd()
    os.chdir(root)  # the eval stage writes ./evaluation_results
    try:
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        t0 = time.time()
        with stage_seconds(device, {}) as stages:
            report = run(cfg, STAGES, device=device)
        sync(device)
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
        again = run(cfg, STAGES, device=device)
    finally:
        os.chdir(cwd)
    scenes = [f"Area_1_{room}" for room in PIPELINE_ROOMS]
    log(f"[pipeline] {json.dumps(report['rooms'])}; {wall:.2f} s wall, "
        f"{report['rooms_per_hour']:.1f} rooms/hour on {card}; launches {launches}")
    log(f"[pipeline] stage seconds, room by room, on {card}: "
        f"{json.dumps({k: [round(x, 3) for x in v] for k, v in stages.items()})}")
    for scene in scenes:
        entry = report["rooms"][scene]
        require(all(entry.get(st, "").startswith("done") for st in STAGES),
                f"pipeline: {scene} {entry}")
        require(all(again["rooms"][scene][st].startswith("skipped") for st in STAGES),
                f"pipeline rerun: {scene} {again['rooms'][scene]}")
    n = len(scenes)
    require(launched(launches, auto_launches(n)),
            f"pipeline: {auto_launches(n)} expected (the auto backend, a scan a room): "
            f"{launches}")
    labeled = {}
    for scene in scenes:
        t0 = time.time()
        data = reference_read_labeled_ply(root / "sim" / scene /
                                          "combined_pointcloud_with_label.ply")
        labeled[scene] = int(len(data["xyz"]))
        require(labeled[scene] > 100_000 and len(np.unique(data["sem"])) > 2,
                f"pipeline: {scene} labeled PLY {labeled[scene]} points")
        log(f"[pipeline] {scene}: the reference reader walked {labeled[scene]} labeled "
            f"points in {time.time() - t0:.1f} s (host of {card})")
    require(all(len(stages.get(st, ())) == len(scenes) for st in STAGES),
            f"pipeline: stage calls {stages}")
    return dict(wall_s=wall, rooms_per_hour=report["rooms_per_hour"], stage_seconds=stages,
                total_seconds=report["total_seconds"], launches=launches,
                labeled_points=labeled, room_points=sizes)


def phase_release_gate(device, work: Path, card: str) -> dict:
    """``release_gate_lroom.run_gate``: the five stages on
    tests/fixtures/golden_room_l, two passes, with its parity checks."""
    from ipcgen_tpu_torch.release_gate_lroom import run_gate

    t0 = time.time()
    gate = run_gate(passes=2, device=device, root=work)
    log(f"[gate] parity {gate['parity']}, {gate['labeled_points']} labeled points, "
        f"{gate['detection_objects']} boxes; on {card}: cold "
        f"{json.dumps(gate['stage_seconds_cold'])} ({gate['total_seconds_cold']:.2f} s), "
        f"steady {json.dumps(gate['stage_seconds_steady'])} "
        f"({gate['total_seconds_steady']:.2f} s); {time.time() - t0:.1f} s in all")
    return gate


SHARDS = (2, 4)


def pairs_agreement(t_a, s_a, p_a, t_b, s_b, p_b) -> dict:
    """The raycast contract between two pair-kernel runs of the same rays:
    hit masks and slots agree, hit-point error p99 and the share over 5 cm
    (a silhouette graze, at most 0.1 %)."""
    hit_a, hit_b = s_a >= 0, s_b >= 0
    both = hit_a & hit_b
    err = (p_a[both] - p_b[both]).norm(dim=1)
    require(err.numel() > 0, "pair shards: no ray hit on both sides")
    return dict(hit_agree=float((hit_a == hit_b).float().mean()),
                same_slot=float((s_a[both] == s_b[both]).float().mean()),
                p99_mm=float(err.quantile(0.99) * 1e3), max_mm=float(err.max() * 1e3),
                over_5cm_frac=float((err > 0.05).float().mean()))


def pair_shards_vs_oracle(o, d, t, slot, t1, s1, asset, asset_p, n_shards: int,
                          p: dict, max_range: float) -> dict:
    """The combined pair shards (t, slot over the padded ``asset_p``) held to
    the raycast contract against the brute oracle on the ten tiles that
    ``check_own_rays`` draws plus every candidate ray: a hit more than 5 cm
    from the unsharded pair run (t1, s1), or a hit on one side only.  A ray
    over 5 cm from the oracle, or hit on one side only, passes only where
    float64 sides with the shards (``f64_sides_with``, on the unsharded
    asset's triangles: the float64 edge test has no centre, so no shard's
    centre enters); at most 0.1 % of the rays.  ``p``: ``prepare_pairs`` of
    the unsharded run (its tiling and overflow flags)."""
    import torch

    from ipcgen_tpu_torch.ops.raycast import finalize_result, raycast_brute_components

    shard_res = finalize_result(o, d, t, slot, asset_p)
    one_res = finalize_result(o, d, t1, s1, asset)
    both = shard_res.hit & one_res.hit
    far = torch.zeros_like(both)
    far[both] = (shard_res.points[both] - one_res.points[both]).norm(dim=1) > 0.05
    cand = torch.nonzero(far | (shard_res.hit != one_res.hit)).flatten()
    sample, _, _, _ = contract_tiles(p, o.shape[0], 10, o.device)
    idx = torch.unique(torch.cat([sample, cand]))
    t_o, s_o = raycast_brute_components(o[idx], d[idx], asset.tri_data, max_range)
    ro = finalize_result(o[idx], d[idx], t_o, s_o, asset)
    hk, ho = shard_res.hit[idx].cpu().numpy(), ro.hit.cpu().numpy()
    tk, to = shard_res.tri_id[idx].cpu().numpy(), ro.tri_id.cpu().numpy()
    both = hk & ho
    pe = np.linalg.norm(shard_res.points[idx].cpu().numpy()[both]
                        - ro.points.cpu().numpy()[both], axis=1)
    differ = np.flatnonzero(hk != ho)
    over = np.concatenate([np.flatnonzero(both)[pe > 0.05], differ])
    sel = idx.cpu().numpy()[over]
    tri_k, tri_o = np.where(hk[over], tk[over], -1), np.where(ho[over], to[over], -1)
    sides = f64_sides_with(o[sel].cpu().numpy(), d[sel].cpu().numpy(), asset, tri_k, tri_o,
                           max_range)
    pe_rest = pe[pe <= 0.05]
    res = dict(sample_rays=int(sample.numel()), candidates=int(cand.numel()),
               rays=int(idx.numel()), hit_agree=float((hk == ho).mean()),
               same_tri=float((tk[both] == to[both]).mean()),
               p99_mm=float(np.percentile(pe, 99) * 1e3),
               max_mm=float(pe.max() * 1e3),
               max_mm_without_adjudicated=float(pe_rest.max() * 1e3) if len(pe_rest)
               else 0.0,
               over_5cm=int((pe > 0.05).sum()), hit_differ=int(len(differ)),
               adjudicated=[dict(ray=int(r), kernel_tri=int(a), oracle_tri=int(b),
                                 f64_sides_with_kernel=bool(w))
                            for r, a, b, w in zip(sel, tri_k, tri_o, sides)])
    require(res["hit_agree"] >= 0.99, f"S={n_shards} pair shards vs oracle: hits {res}")
    require(res["same_tri"] >= 0.99, f"S={n_shards} pair shards vs oracle: triangles {res}")
    require(res["p99_mm"] <= 5.0, f"S={n_shards} pair shards vs oracle: p99 {res}")
    require(bool(np.all(sides)),
            f"S={n_shards} pair shards: a ray off the oracle where float64 does not side "
            f"with the shards: {res}")
    require(len(over) <= MAX_GRAZE_FRAC * idx.numel(),
            f"S={n_shards} pair shards: too many rays off the oracle: {res}")
    return res


def phase_multidevice(device, work: Path, card: str) -> dict:
    """The multi-device paths on the card: an NCCL group of one rank through
    a ``FileStore``; ``scan_waypoints_sharded`` of the main room (BLK2GO, 20
    waypoints, 40 poses: 2.56 M rays) on the pair and culled kernels, equal to ``scan_waypoints``
    bit for bit; the triangle-sharded raycast of all its rays with S = 2 and
    4 shard-local launches combined in this process, equal to the unsharded
    culled kernel bit for bit (the pair kernel: to the raycast contract);
    ``run_scenes_device_parallel`` on [cuda:0, cuda:0] over the two-room
    batch, equal to the sequential ``main`` of ``phase_batch``;
    ``sharded_grid_nn`` equal to the one-card 1-NN; the dry run."""
    import torch
    import torch.distributed as dist

    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.models.lidar_intrinsics import DualAxisLidarIntrinsics
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.grid_nn import nearest_neighbor_indices_grid
    from ipcgen_tpu_torch.ops.raycast import finalize_result
    from ipcgen_tpu_torch.ops.raycast_pairs import prepare_pairs
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.parallel import dryrun, shard
    from ipcgen_tpu_torch.sim.scan import scan_rays, scan_waypoints
    from ipcgen_tpu_torch.sim.simulator import find_available_scenes, run_scenes_device_parallel
    from ipcgen_tpu_torch.utils.device import sync

    def reset():
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0

    dryrun.init_group("nccl", str(work / "nccl_store"), 1, 0)
    try:
        mesh = shard.make_device_mesh()
        log(f"[multi] NCCL group of {dist.get_world_size()} rank through a FileStore; "
            f"mesh {mesh}")
        mesh_tri = TriMesh.load(work / "mesh_dense.ply")
        asset = build_scene_asset(mesh_tri.vertices, mesh_tri.triangles, device=device)
        intr = DualAxisLidarIntrinsics.create_blk2go_dual_axis()
        # 40 poses: the 2.56 M rays of a 20-waypoint planned run (the
        # planner doubles the waypoints), as phase_main_path's BLK2GO run.
        poses = room_poses(40, seed=3)
        scans, launches = {}, {}
        for backend in ("pairs", "culled"):
            reset()
            t0 = time.time()
            got = shard.scan_waypoints_sharded(
                asset, intr, poses, mesh, backend=backend, outputs="unordered",
                generator=torch.Generator(device=device).manual_seed(0))
            sync(device)
            sharded_s = time.time() - t0
            launches[f"scan_{backend}"] = dict(_kernels.LAUNCHES)
            want = scan_waypoints(asset, intr, poses, backend=backend, outputs="unordered",
                                  generator=torch.Generator(device=device).manual_seed(0))
            same = all(torch.equal(getattr(got, k), getattr(want, k))
                       for k in ("points", "t", "mask"))
            scans[backend] = dict(rays=int(got.mask.numel()), hits=int(got.mask.sum()),
                                  bit_equal=same, seconds=sharded_s)
            log(f"[multi] scan_waypoints_sharded BLK2GO x 40 poses on {backend}: "
                f"{scans[backend]}, "
                f"launches {launches[f'scan_{backend}']} on {card}")
            require(same, f"sharded scan ({backend}) differs from scan_waypoints")
            key = "raycast_pairs" if backend == "pairs" else "raycast_culled"
            require(launches[f"scan_{backend}"][key] == 1,
                    f"sharded scan ({backend}) launches {launches[f'scan_{backend}']}")

        # Triangle shards, S shard-local launches in this process.
        o, d, _ = scan_rays(intr, poses, torch.Generator(device=device).manual_seed(0),
                            device, backend="culled")
        max_range = float(intr.max_range)
        one = {}
        for backend in ("culled", "pairs"):
            one[backend] = shard.local_raycast(
                o, d, asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo,
                asset.super_hi, super_factor=asset.super_factor, t_max=max_range,
                backend=backend)
        # The unsharded pair run's tiling, for the oracle sample of the pair
        # shards (outside every counted window).
        pairs_p = prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                                t_max=max_range)
        tri_shards = {}
        for n_shards in SHARDS:
            asset_p = shard.shard_asset_blocks(asset, n_shards)
            for backend in ("culled", "pairs"):
                reset()
                ts, slots = [], []
                t0 = time.time()
                for i in range(n_shards):
                    t, s = shard.local_raycast(
                        o, d, *shard.block_shard(asset_p, n_shards, i),
                        super_factor=asset_p.super_factor, t_max=max_range, backend=backend)
                    ts.append(t)
                    slots.append(shard.globalize_slots(s, i, asset_p.num_blocks // n_shards,
                                                       asset_p.block_size))
                t, slot = shard.combine_nearest(torch.stack(ts), torch.stack(slots))
                sync(device)
                secs = time.time() - t0
                shard_launches = dict(_kernels.LAUNCHES)
                t1, s1 = one[backend]
                if backend == "culled":
                    res = dict(bit_equal=bool(torch.equal(t, t1) and torch.equal(slot, s1)))
                    require(res["bit_equal"], f"S={n_shards} culled shards differ")
                    require(shard_launches["raycast_culled"] == n_shards,
                            f"S={n_shards} culled launches {shard_launches}")
                else:
                    pa = finalize_result(o, d, t, slot, asset_p).points
                    pb = finalize_result(o, d, t1, s1, asset).points
                    res = pairs_agreement(t, slot, pa, t1, s1, pb)
                    require(res["hit_agree"] >= 0.99 and res["same_slot"] >= 0.99
                            and res["p99_mm"] <= 5.0 and res["over_5cm_frac"] <= 1e-3,
                            f"S={n_shards} pair shards off the contract: {res}")
                    require(shard_launches["raycast_pairs"] == n_shards,
                            f"S={n_shards} pair launches {shard_launches}")
                    res["oracle"] = pair_shards_vs_oracle(o, d, t, slot, t1, s1, asset,
                                                          asset_p, n_shards,
                                                          pairs_p, max_range)
                res.update(rays=int(o.shape[0]), seconds=secs, launches=shard_launches)
                tri_shards[f"{backend}_S{n_shards}"] = res
                log(f"[multi] triangle shards S={n_shards}, {backend}, {o.shape[0]} rays: "
                    f"{res} on {card}")

        # Rooms in parallel on [cuda:0, cuda:0], against phase_batch's main.
        jobs = [{"scene_path": p, "scene_name": n, "area": "Area_1",
                 "room": n.split("_", 2)[2]}
                for p, n, _ in find_available_scenes(str(work / "recon"))]
        reset()
        t0 = time.time()
        ok, failed = run_scenes_device_parallel(
            jobs, num_waypoints=20, output_base_dir=str(work / "roomdp_out"),
            devices=[device, device], use_blk2go=True, s3dis_data_root=str(work / "s3dis"))
        sync(device)
        dp_s = time.time() - t0
        launches["room_dp"] = dict(_kernels.LAUNCHES)
        require(not failed and len(ok) == len(jobs) == 2, f"room DP: {ok} {failed}")
        require(launched(launches["room_dp"], auto_launches(2)),
                f"room DP launches {launches['room_dp']}, expected {auto_launches(2)}")
        for name, _ in ok:
            for f in ("combined_pointcloud_with_label.ply", "combined_pointcloud.ply"):
                require((work / "roomdp_out" / name / f).read_bytes()
                        == (work / "batch_out" / name / f).read_bytes(),
                        f"room DP {name}/{f} differs from the sequential main")
        log(f"[multi] run_scenes_device_parallel of {len(ok)} rooms on [{device}, {device}] "
            f"in {dp_s:.2f} s on {card}: labeled and combined clouds equal to the "
            f"sequential main's byte for byte; launches {launches['room_dp']}")

        # Query-sharded 1-NN: the sharded scan's hits against the TLS cloud.
        from ipcgen_tpu_torch.semantic.annotations import S3DISAnnotationLoader

        loader = S3DISAnnotationLoader(str(work / "s3dis"), verbose=False)
        refs, _, _ = loader.create_labeled_pointcloud_with_instances(
            loader.load_room_annotations("Area_1", "office_1"))
        refs = np.asarray(refs, np.float32)
        got = shard.scan_waypoints_sharded(
            asset, intr, poses[:4], mesh, outputs="unordered",
            generator=torch.Generator(device=device).manual_seed(1))
        queries = got.points[got.mask].cpu().numpy()
        t0 = time.time()
        idx = shard.sharded_grid_nn(queries, refs, mesh)
        nn_s = time.time() - t0
        require(np.array_equal(idx, nearest_neighbor_indices_grid(queries, refs,
                                                                  device=device)),
                "sharded 1-NN differs from the one-card 1-NN")
        log(f"[multi] sharded_grid_nn of {len(queries)} scan points into {len(refs)} TLS "
            f"points in {nn_s:.2f} s on {card}: equal to the one-card 1-NN")

        reset()
        t0 = time.time()
        dry = dryrun.dryrun()
        sync(device)
        launches["dryrun"] = dict(_kernels.LAUNCHES)
        require(dry["rays"] >= 1_000_000, f"dry run: {dry}")
        log(f"[multi] dry run at world size 1 over NCCL: {dry} in {time.time() - t0:.2f} s "
            f"on {card}")
    finally:
        dist.destroy_process_group()
    return dict(scans=scans, tri_shards=tri_shards, room_dp_s=dp_s, grid_nn_s=nn_s,
                grid_nn_queries=int(len(queries)), dryrun=dry, launches=launches)


# ---------------------------------------------------------------------------
# The port's bench and the label-transfer probe
# ---------------------------------------------------------------------------
def pairs_vs_culled_adjudicated(o, d, asset, label: str, sort_rays="auto") -> dict:
    """Cast rays o, d through the pair and the culled kernel (t_max 20 m, as
    the bench); hold each ray whose pair hit is over 5 cm from the culled
    kernel's, or hit on one side only, to the brute oracle: where the pair
    kernel's triangle is not the oracle's, float64 must side with the pair
    kernel (``f64_sides_with``).  Returns the figures, each such ray listed
    with the triangle of each kernel and of the oracle."""
    import torch

    from ipcgen_tpu_torch.ops.raycast import raycast_asset

    rp, rc = (raycast_asset(o, d, asset, backend=k, t_max=20.0, sort_rays=sort_rays)
              for k in ("pairs", "culled"))
    both = rp.hit & rc.hit
    far = torch.zeros_like(both)
    far[both] = (rp.points[both] - rc.points[both]).norm(dim=1) > 0.05
    flagged = torch.nonzero(far | (rp.hit != rc.hit)).flatten()
    ro = raycast_asset(o[flagged], d[flagged], asset, backend="brute", t_max=20.0)
    off = torch.nonzero(rp.tri_id[flagged] != ro.tri_id).flatten()
    sel = flagged[off]
    sides = f64_sides_with(o[sel].cpu().numpy(), d[sel].cpu().numpy(), asset,
                           rp.tri_id[sel].cpu().numpy(), ro.tri_id[off].cpu().numpy(), 20.0)
    res = dict(rays=int(o.shape[0]), flagged=int(flagged.numel()), off_oracle=int(sel.numel()),
               f64_sides_with_pairs=int(sides.sum()),
               rays_off=[dict(ray=int(r), pairs_tri=int(a), culled_tri=int(c), oracle_tri=int(b),
                              f64_sides_with_pairs=bool(w))
                         for r, a, c, b, w in zip(sel.tolist(), rp.tri_id[sel].tolist(),
                                                  rc.tri_id[sel].tolist(),
                                                  ro.tri_id[off].tolist(), sides)])
    log(f"[bench] {label} rays, pairs over 5 cm from culled or on one side only, vs the "
        f"oracle: {res}")
    require(bool(np.all(sides)), f"bench {label}: a pair ray off the oracle where float64 "
                                 f"does not side with the pair kernel {res}")
    return res


BENCH_DIRECT = ("incoherent_random_rays", "incoherent_random_rays_sorted",
                "open_scene_32line")
OPEN_SCENE_SAMPLE = 20_480


def phase_bench(device, card: str) -> dict:
    """``bench.run`` at the JAX bench's sizes, its CPU baseline in a child
    process: the compact line parses and fits the budget; every workload has
    pair and culled figures with min <= median <= max; each pair call
    launched one prepass and one walk, each culled call one culled kernel;
    where both kernels cast the same rays, hit masks agree >= 99 % and hit
    points p99 <= 5 mm; the recon mesh has faces; the CPU baseline ran.  On
    a sample of the open scene's rays the culled kernel's miss mask equals
    the brute oracle's, and where the pair kernel's differs float64 sides
    with the pair kernel (``f64_sides_with``); so it does on each ray of
    the whole open-scene workload and of the incoherent rays whose pair hit
    is over 5 cm from the culled kernel's, or on one side only, and off the
    oracle's triangle (``pairs_vs_culled_adjudicated``)."""
    import torch

    from ipcgen_tpu_torch import bench
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast import raycast_asset
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    t0 = time.time()
    out, line = bench.run(device)
    seconds = time.time() - t0
    log(f"[bench] {len(line)} characters in {seconds:.1f} s on {card}: {line}")
    compact = json.loads(line)
    require(len(line) <= bench.LINE_BUDGET and "workloads" in compact["details"],
            f"bench line of {len(line)} characters: {line}")
    table = bench._workload_table(out)
    by_path = {}
    for w, m in [*table.items(), ("box_auto", {out["details"]["auto"]:
                                                out["details"]["box"]["auto"]})]:
        for k, s in m.items():
            if k not in bench.KERNELS:
                continue
            for mode in ("pipelined_s", "per_call_s"):
                sp = s[mode]
                require(sp["min"] <= sp["median"] <= sp["max"], f"bench {w} {k} {mode}: {sp}")
            want = ({"raycast_pairs": s["calls"], "raycast_pairs_prepass": s["calls"]}
                    if k == "pairs" else {"raycast_culled": s["calls"]})
            require(s["launches"] == want,
                    f"bench {w} {k}: launches {s['launches']} for {s['calls']} calls")
            by_path[f"bench_{w}_{k}"] = {n: s["launches"].get(n, 0) for n in _kernels.LAUNCHES}
    agreement = {}
    for name in BENCH_DIRECT:
        a = agreement[name] = out["details"]["workloads"][name]["agreement"]
        require(a["hit_agree"] >= 0.99 and a["p99_mm"] <= 5.0,
                f"bench {name}: pairs vs culled {a}")
    rm = out["details"]["production_workloads"]["reconstructed_mesh_32line"]
    require(rm["mesh_faces"] > 0, "bench: the recon mesh has no faces")
    require(out["details"]["baseline_rays_per_sec"] is not None, "bench: no CPU baseline")

    # The open scene's misses against the oracle, on a sample of its rays.
    verts, tris = synthetic_room(bench.BENCH_TRIS)
    open_asset = build_scene_asset(verts, bench._open_scene_tris(verts, tris), device=device)
    o, d = bench._open_scene_rays(128_000, 20)
    pick = np.sort(np.random.default_rng(5).choice(len(o), OPEN_SCENE_SAMPLE, replace=False))
    o, d = bench._as_rays(o[pick], d[pick], device)
    res = {k: raycast_asset(o, d, open_asset, backend=k, t_max=20.0, sort_rays=False)
           for k in ("pairs", "culled", "brute")}
    miss = {k: ~r.hit for k, r in res.items()}
    differ = torch.nonzero(miss["pairs"] != miss["brute"]).flatten()
    # Each ray the pair kernel and the oracle disagree on: float64 adjudicates.
    sides = f64_sides_with(
        o[differ].cpu().numpy(), d[differ].cpu().numpy(), open_asset,
        res["pairs"].tri_id[differ].cpu().numpy(), res["brute"].tri_id[differ].cpu().numpy(),
        20.0)
    open_check = dict(rays=OPEN_SCENE_SAMPLE, brute_miss=float(miss["brute"].float().mean()),
                      **{f"{k}_miss_agree": float((miss[k] == miss["brute"]).float().mean())
                         for k in bench.KERNELS},
                      pairs_miss_differ=int(differ.numel()),
                      pairs_miss_differ_f64_sides_with_pairs=int(sides.sum()))
    log(f"[bench] open scene, {OPEN_SCENE_SAMPLE} sampled rays vs the oracle: {open_check}")
    require(open_check["brute_miss"] > 0, f"bench open scene: no miss {open_check}")
    require(torch.equal(miss["culled"], miss["brute"]),
            f"bench open scene: culled misses differ from the oracle's {open_check}")
    require(bool(np.all(sides)),
            f"bench open scene: a pair miss differs from the oracle's where float64 does not "
            f"side with the pair kernel {open_check}")

    # The open scene's and the incoherent rays, all of them: each ray whose
    # pair hit is over 5 cm from the culled kernel's or on one side only,
    # held to the oracle.
    o, d = bench._as_rays(*bench._open_scene_rays(128_000, 20), device)
    open_full = pairs_vs_culled_adjudicated(o, d, open_asset, "open scene", sort_rays=False)
    asset = build_scene_asset(verts, tris, device=device)
    o, d = bench._as_rays(*bench._incoherent_rays(bench.Sizes().incoherent_rays), device)
    incoherent_check = pairs_vs_culled_adjudicated(o, d, asset, "incoherent")
    return dict(seconds=seconds, line_chars=len(line), compact=compact,
                agreement=agreement, open_scene=open_check, open_scene_all=open_full,
                incoherent=incoherent_check,
                launches=by_path,
                pair_lists={name: out["details"]["workloads"][name]["pair_lists"]
                            for name in BENCH_DIRECT})


LABEL_SAMPLE = 100_000


def phase_label_probe(device, card: str) -> dict:
    """``label_transfer_probe.run`` at 2.56 M queries x 630 k refs: the
    instrumented 1-NN equals the library call on every row, and on a 100 k
    sample its distances equal a float64 scipy cKDTree query within 1e-6 m;
    ``LabelGrid``'s answers are at the library's distances."""
    from scipy.spatial import cKDTree

    from ipcgen_tpu_torch import label_transfer_probe

    report, (q, refs, idx) = label_transfer_probe.run(device)
    pick = np.random.default_rng(6).choice(len(q), LABEL_SAMPLE, replace=False)
    qs = q[pick].astype(np.float64)
    want, _ = cKDTree(refs.astype(np.float64)).query(qs)
    got = np.linalg.norm(qs - refs[idx[pick]].astype(np.float64), axis=1)
    report["ckdtree_max_abs_m"] = float(np.abs(got - want).max())
    log(f"[label-probe] on {card}: {json.dumps(report)}")
    require(report["mismatch_rows"] == 0, f"label probe: {report['mismatch_rows']} rows "
            "differ from the library call")
    require(report["ckdtree_max_abs_m"] <= 1e-6, f"label probe vs cKDTree: {report}")
    require(report["label_grid_dist_mismatch_rows"] == 0, f"LabelGrid: {report}")
    return report


# The exact 1-NN: 1,300,000 TLS references a room, and the residue rows of a
# BLK2GO room (0.81 % of 2.5 M hits) and of a dense 32-line room (0.99 % of
# 5 M); each pair costs 3 differences, 3 products and 2 sums that cannot
# fuse, one fp32 issue slot each.
NN_REFS = 1_300_000
NN_SHAPES = {"blk2go": 20_000, "dense32": 48_000}
NN_AT_DENSITY = (500_000, 2_600_000)
NN_OPS_PER_PAIR = 8


def time_cold_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` after a warm-up, the L2 cache
    flushed (256 MB written) before each call."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_nn_exact(device, card: str) -> dict:
    """The exact 1-NN kernel at the label residue's shapes against its plain
    version: the same indices on every row, the times and the bound."""
    import torch

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.knn import nearest_neighbor_plain

    def points(n: int, seed: int):
        p = np.random.default_rng(seed).uniform([0, 0, 0], [6, 5, 2.5], (n, 3))
        return torch.from_numpy(p.astype(np.float32)).to(device)

    refs = points(NN_REFS, 21)
    out = {"refs": NN_REFS}
    for k, (name, n) in enumerate(NN_SHAPES.items()):
        q = points(n, 22 + k)
        before = _kernels.LAUNCHES["nn_exact"]
        got = _kernels.nn_exact_cuda(q, refs)
        require(_kernels.LAUNCHES["nn_exact"] == before + 1, "nn_exact: one launch a call")
        want = nearest_neighbor_plain(q, refs)
        off = int((got != want).sum())
        require(off == 0, f"nn_exact at {name}: {off} of {n} rows differ from the plain version")
        res = {"queries": n, "rows_off": off,
               "ms": time_cold_ms(lambda: _kernels.nn_exact_cuda(q, refs), 5),
               "plain_ms": time_cold_ms(lambda: nearest_neighbor_plain(q, refs), 1),
               **bound(nbytes(q, refs) + 8 * n, float(n) * NN_REFS * NN_OPS_PER_PAIR,
                       fp32_issue_rate())}
        res["x_bound"] = res["ms"] / res["bound_ms"]
        out[name] = res
    n, m = NN_AT_DENSITY
    q, r = points(n, 31), points(m, 32)
    out["at_density"] = {"queries": n, "refs": m,
                         "ms": time_cold_ms(lambda: _kernels.nn_exact_cuda(q, r), 2),
                         **bound(nbytes(q, r) + 8 * n, float(n) * m * NN_OPS_PER_PAIR,
                                 fp32_issue_rate())}
    log(f"[nn-exact] on {card}: {json.dumps(out)}")
    return out


ASSET_SEED = 3500000037  # the benchmark's office (benchmark/rooms.py), room 0
ASSET_VOXEL = 0.03  # its cells' recon cut: about 1.4 M triangles


def asset_bytes(n_verts: int, n_tris: int, n_blocks: int, block_size: int,
                n_supers: int) -> int:
    """The least bytes the asset's build must move: the float32 vertices and
    int32 triangles read once, the eight arrays written once."""
    slots = n_blocks * block_size
    return 12 * (n_verts + n_tris) + slots * (16 * 4 + 4 + 12 + 16) + 24 * (n_blocks + n_supers)


def phase_scene_asset(device, card: str) -> dict:
    """The scene asset's build at the benchmark's 1.4 M-triangle office: the
    kernels (``scene_arrays_card``) against the plain torch version on the
    card and the numpy build, bit for bit; one launch of each kernel a build;
    times warm with CUDA events (the kernels alone, the build from the host
    arrays, the plain version) and the numpy build's host seconds."""
    import torch

    from benchmark.rooms import Room, room_rng
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops import scene_asset as sa

    verts, tris = Room.draw(room_rng(ASSET_SEED, 0)).recon_mesh(ASSET_VOXEL)
    verts = verts.astype(np.float64)  # as TriMesh.load gives them
    t0 = time.perf_counter()
    ref = sa.build_scene_arrays(verts, tris)
    numpy_s = time.perf_counter() - t0
    v = torch.from_numpy(verts.astype(np.float32)).to(device)
    t = torch.from_numpy(tris.astype(np.int32)).to(device)
    before = {k: _kernels.LAUNCHES[k] for k in ("scene_codes", "scene_pack")}
    asset = sa.build_scene_asset(verts, tris, device=device)
    require(all(_kernels.LAUNCHES[k] == n + 1 for k, n in before.items()),
            f"scene asset: one launch of each kernel a build: {_kernels.LAUNCHES}")
    card_fields = sa.scene_arrays_card(v, t)
    plain_fields = sa.scene_arrays_plain(v, t)
    for k in sa._ARRAY_FIELDS:
        want = ref[k]
        for route, got in (("build_scene_asset", getattr(asset, k)),
                           ("kernels", card_fields[k]), ("plain", plain_fields[k])):
            got = got.cpu().numpy()
            require(got.dtype == want.dtype and got.shape == want.shape
                    and np.array_equal(got, want, equal_nan=True),
                    f"scene asset {k}: the {route} route differs from build_scene_arrays")
    codes, keys = _kernels.scene_codes_cuda(v, t, 10)
    order = torch.sort(codes, stable=True).indices
    nb = asset.num_blocks
    n = len(tris)
    out = {
        "triangles": n, "blocks": nb, "numpy_s": numpy_s,
        "ms": time_ms(lambda: sa.scene_arrays_card(v, t), 10),
        "codes_ms": time_ms(lambda: _kernels.scene_codes_cuda(v, t, 10), 10),
        "sort_ms": time_ms(lambda: torch.sort(codes, stable=True), 10),
        "pack_ms": time_ms(lambda: _kernels.scene_pack_cuda(v, t, order, keys, nb, 128, 8), 10),
        "from_host_ms": time_ms(lambda: sa.build_scene_asset(verts, tris, device=device), 5),
        "plain_ms": time_ms(lambda: sa.scene_arrays_plain(v, t), 3),
        **bound(asset_bytes(len(verts), n, nb, 128, asset.num_supers), 0.0),
    }
    out["x_bound"] = (out["codes_ms"] + out["pack_ms"]) / out["bound_ms"]
    log(f"[scene-asset] on {card}: {json.dumps(out)}")
    return out


LABEL_TLS_POINTS = 1_300_000  # the benchmark cells' TLS points a room


def label_build_bytes(n_ann: int, n_raw: int, levels) -> dict:
    """The least bytes the label prefetch's builds must move: the join reads
    both float64 clouds and writes an index and a flag a row; the grid
    reads the float32 references and writes each level's table, slot ids
    and counts once."""
    grid = 12 * n_ann + sum(p["table"].numel() * 4 + p["slot_ids"].numel() * 4
                            + p["counts"].numel() * 4 for p in levels)
    return {"join": 24 * (n_ann + n_raw) + 9 * n_ann, "grid": grid}


def build_memory(device, build) -> tuple:
    """(peak, held): the bytes ``build()`` allocates on ``device`` at its
    peak and the bytes its result still holds, both above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    result = build()
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device) - base
    del result
    return torch.cuda.max_memory_allocated(device) - base, held


def phase_label_build(device, card: str) -> dict:
    """The label prefetch's colour join and ``LabelGrid`` built on the card
    at the benchmark's office, against the numpy build bit for bit; the
    card grid's indices equal to the host grid's; times warm with CUDA
    events and the numpy build's host seconds."""
    import torch

    from benchmark.rooms import Room, room_rng, scan_room
    from ipcgen_tpu_torch.containers import sim_scene as ss
    from ipcgen_tpu_torch.ops import grid_nn as gn

    rng = room_rng(ASSET_SEED, 0)
    tls = scan_room(Room.draw(rng), rng, LABEL_TLS_POINTS, 0.002, 0.005)
    ann = np.vstack([mm for mm, _ in tls.instances.values()]) / 1000.0
    raw = np.vstack([ann, tls.outliers_mm / 1000.0])
    raw = raw[rng.permutation(len(raw))]
    refs = ann.astype(np.float32)

    t0 = time.perf_counter()
    want_idx, want_m = ss._exact_coord_join(ann, raw)
    join_numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = gn.LabelGrid(refs, device="cpu")
    grid_numpy_s = time.perf_counter() - t0
    memory = {"join": build_memory(device, lambda: ss._exact_coord_join_tensor(ann, raw, device)),
              "grid": build_memory(device, lambda: gn.LabelGrid(refs, device=device))}
    idx, m = ss._exact_coord_join_tensor(ann, raw, device)
    require(np.array_equal(idx.cpu().numpy(), want_idx)
            and np.array_equal(m.cpu().numpy(), want_m),
            "label build: the card's colour join differs from _exact_coord_join")
    card_grid = gn.LabelGrid(refs, device=device)
    require(card_grid.device_build and card_grid.h0 == host.h0,
            f"label build: h0 {card_grid.h0} on the card, {host.h0} on the host")
    for lvl, (a, b) in enumerate(zip(card_grid._lvl, host._lvl)):
        for k in ("table", "counts", "slot_ids", "lo", "inv_h", "dims"):
            require(a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k]),
                    f"label build: level {lvl} {k} differs from _build_slab_host")
    q_rng = np.random.default_rng(ASSET_SEED)
    q = (refs[q_rng.choice(len(refs), 200_000)]
         + q_rng.normal(0, 0.01, (200_000, 3))).astype(np.float32)
    require(np.array_equal(card_grid.query(torch.from_numpy(q).to(device)), host.query(q)),
            "label build: the card grid's indices differ from the host grid's")
    sizes = label_build_bytes(len(ann), len(raw), card_grid._lvl)
    ann_keys, raw_keys = ss._coord_keys(ann, device), ss._coord_keys(raw, device)
    out = {
        "annotation_points": len(ann), "raw_points": len(raw), "h0": card_grid.h0,
        "matched": int(want_m.sum()), "join_numpy_s": join_numpy_s,
        "grid_numpy_s": grid_numpy_s,
        "join_ms": time_ms(lambda: ss._coord_join_keys(ann_keys, raw_keys), 5),
        "join_from_host_ms": time_ms(lambda: ss._exact_coord_join_tensor(ann, raw, device), 5),
        "grid_from_host_ms": time_ms(lambda: gn.LabelGrid(refs, device=device), 5),
        "join_bound_ms": sizes["join"] / PEAK_BYTES * 1e3,
        "grid_bound_ms": sizes["grid"] / PEAK_BYTES * 1e3,
        **{f"{k}_{what}_mb": v[i] / 1e6 for k, v in memory.items()
           for i, what in enumerate(("peak", "held"))},
        **bound(sizes["join"] + sizes["grid"], 0.0),
    }
    out["x_bound"] = (out["join_from_host_ms"] + out["grid_from_host_ms"]) / out["bound_ms"]
    log(f"[label-build] on {card}: {json.dumps(out)}")
    return out


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
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_s[name] = time.time() - t0
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        return out

    checks, prepass_checks = phase("kernel_check", phase_kernel_check, device, asset)
    culled_checks = phase("culled_kernel_check", phase_culled_kernel_check, device, asset)
    probe = phase("probe", phase_probe, device, asset)
    del asset
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        runs, culled, occupancy, batch = phase("main_path", phase_main_path, device, work,
                                               card)
        preprocess = phase("preprocess", phase_preprocess, device, work, card)
        tls_tree = tls_tree_of(work)
        recon = phase("recon", phase_recon, device, work, card, tls_tree)
        runs["recon_dense32"] = phase("recon_sim", phase_recon_sim, device, work, card,
                                      tls_tree)
        bbox_eval = phase("bbox_eval", phase_bbox_eval, device, work, card)
        pipeline = phase("pipeline", phase_pipeline, device, work, card)
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        gate = phase("release_gate", phase_release_gate, device, work, card)
        gate["launches"] = dict(_kernels.LAUNCHES)
        require(launched(gate["launches"], auto_launches(2)),
                f"release gate: {auto_launches(2)} expected (the auto backend, a scan a "
                f"pass): {gate['launches']}")
        multi = phase("multidevice", phase_multidevice, device, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    bench_res = phase("bench", phase_bench, device, card)
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    label_probe = phase("label_probe", phase_label_probe, device, card)
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    nn = phase("nn_exact", phase_nn_exact, device, card)
    nn_check_calls = _kernels.LAUNCHES["nn_exact"]
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    scene = phase("scene_asset", phase_scene_asset, device, card)
    scene_check_calls = {k: _kernels.LAUNCHES[k] for k in ("scene_codes", "scene_pack")}
    phase("label_build", phase_label_build, device, card)
    log(f"[summary] phase seconds {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"[summary] batch {json.dumps({k: v for k, v in batch.items() if k != 'rooms'})}; "
        f"preprocess warm spans {json.dumps(preprocess['runs'][-1]['spans'])}")
    log(f"[summary] recon warm {json.dumps(recon['runs'][-1]['variants'])}; splat and "
        f"marching {json.dumps(recon['timing'])}")
    rs = runs["recon_dense32"]
    log(f"[summary] recon mesh scan: {rs['faces']} faces, {rs['rays']} rays, "
        f"{rs['rays_per_s']:.0f} rays/s, stages {json.dumps(rs['stages'])}; bbox and eval "
        f"{json.dumps(bbox_eval)}")

    log(f"[summary] pipeline {json.dumps({k: v for k, v in pipeline.items()})}; release gate "
        f"{json.dumps(gate)}; on {card}")
    log(f"[summary] multi-device {json.dumps({k: v for k, v in multi.items() if k != 'launches'})}")
    log(f"[summary] bench on {card}: {bench_res['seconds']:.1f} s, agreement "
        f"{json.dumps(bench_res['agreement'])}, pair lists {json.dumps(bench_res['pair_lists'])}, "
        f"open scene {json.dumps(bench_res['open_scene'])}; label probe "
        f"{json.dumps(label_probe)}")

    # Every path's own launches, each counted from 0 just before it: the
    # two pair runs of phase_main_path, the culled runs, the batch, the scan
    # of the recon mesh, the pipeline, the release gate and the multi-device
    # paths.
    by_path = {f"sim_{k}": r["launches"] for k, r in runs.items()}
    by_path.update(culled_blk2go=culled["launches"],
                   culled_dense32=culled["dense32"]["launches"], batch=batch["launches"],
                   pipeline=pipeline["launches"], release_gate=gate["launches"],
                   **{f"multi_{k}": v for k, v in multi["launches"].items()},
                   **{f"multi_tri_{k}": v["launches"] for k, v in multi["tri_shards"].items()},
                   **bench_res["launches"])

    def path_launches(key):
        return {k: v[key] for k, v in by_path.items() if v.get(key)}

    # A path whose rooms left rows to the label grid's residue searched them
    # with the 1-NN kernel.
    residue_rows = {f"sim_{k}": int(r["stages"].get("label_nn_residue_rows", 0))
                    for k, r in runs.items()}
    residue_rows["batch"] = sum(int(r["stages"].get("label_nn_residue_rows", 0))
                                for r in batch["rooms"].values())
    for path, rows in residue_rows.items():
        require(rows == 0 or by_path[path].get("nn_exact", 0) >= 1,
                f"{path}: {rows} residue rows but no nn_exact launch: {by_path[path]}")

    launches = sum(path_launches("raycast_pairs").values())
    prepass_launches = sum(path_launches("raycast_pairs_prepass").values())
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
        "launches_by_path": path_launches("raycast_pairs"),
        "max_abs_err": max(*(r["kernel"]["max_abs_err"] for r in runs.values()),
                           *(c["max_abs_err"] for c in checks.values())),
        "ms": at_shape["ms"],
        "plain_ms": at_shape["plain_ms"],
        **{k: at_shape[k] for k in bound_keys}, **yardstick,
        "main_path_inputs": {
            k: {"rays": r["kernel"]["rays"], "ms": r["kernel"]["ms"],
                "plain_ms": r["kernel"]["plain_ms"], "bound_ms": r["kernel"]["bound_ms"],
                "tests_run": r["kernel"]["tests_run"],
                "exact_list_tests": r["kernel"]["exact_list_tests"],
                "f64_tests": r["kernel"]["f64_tests"], "f64_share": r["kernel"]["f64_share"]}
            for k, r in runs.items()},
        "occupancy": occupancy,
    }, {
        "name": "pairs_prepass_kernel",
        "route": "cuda",
        "source": "ipcgen_tpu_torch/csrc/raycast_pairs.cu",
        "replaces": "ipcgen_tpu/ops/raycast_mxu.py:297",
        "replaces_note": "not a Pallas kernel (XLA candidate_blocks)",
        "launches": prepass_launches,
        "launches_by_path": path_launches("raycast_pairs_prepass"),
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
        "launches": sum(path_launches("raycast_culled").values()),
        "launches_by_path": path_launches("raycast_culled"),
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
    record["kernels"].append({
        "name": "nn_exact_kernel", "route": "cuda", "source": "ipcgen_tpu_torch/csrc/nn_exact.cu",
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package leaves its exact 1-NN to XLA "
                         "(ipcgen_tpu/ops/knn.py:140)",
        "launches": sum(path_launches("nn_exact").values()),
        "launches_by_path": path_launches("nn_exact"),
        "residue_rows_by_path": residue_rows,
        "check_calls": nn_check_calls,
        "rows_off": sum(nn[k]["rows_off"] for k in NN_SHAPES),
        "ms": nn["blk2go"]["ms"], "plain_ms": nn["blk2go"]["plain_ms"],
        **{k: nn["blk2go"][k] for k in bound_keys}, "library_ms": None,
        "bound_set_by": f"queries x references x {NN_OPS_PER_PAIR} fp32 issue slots a pair",
        "shapes": nn,
    })
    for name, key, ms in (("centroid_kernel + morton_kernel", "scene_codes", "codes_ms"),
                          ("pack_kernel + supers_kernel", "scene_pack", "pack_ms")):
        record["kernels"].append({
            "name": name, "route": "cuda", "source": "ipcgen_tpu_torch/csrc/scene_asset.cu",
            "replaces": None,
            "replaces_note": "no Pallas kernel: the JAX package builds the scene asset in "
                             "host numpy (ipcgen_tpu/ops/scene_asset.py:138)",
            "launches": sum(path_launches(key).values()),
            "launches_by_path": path_launches(key),
            "check_calls": scene_check_calls[key],
            "max_abs_err": 0.0,
            "ms": scene[ms], "plain_ms": scene["plain_ms"], "numpy_s": scene["numpy_s"],
            "sort_ms": scene["sort_ms"], "build_ms": scene["ms"],
            "from_host_ms": scene["from_host_ms"],
            "bound_ms": scene["bound_ms"], "bound_by": scene["bound_by"],
            "bound_set_by": "the mesh read and the arrays written once, over 3.35 TB/s, for "
                            "both kernels together (asset_bytes)",
            "library_ms": None, "triangles": scene["triangles"],
        })
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
