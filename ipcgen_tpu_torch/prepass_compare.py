"""Hold the pair prepass kernel against other builds of it on the main path's inputs.

    python -m ipcgen_tpu_torch.prepass_compare [--against NAME=SRC.cu ...]
        [--out FILE.json] [--ptxas]

Builds the main room of ``chip_smoke.py`` and its auto trajectory
(``profile_scan.main_room``: 638,976 triangles, 6,144 blocks, 20 requested
waypoints, seed 0, densified to 40 by the planner) and, for the BLK2GO and
dense 32-line profiles, the rays the pair scan casts (``sim.scan.scan_rays``,
seed 0, patch order) as ``prepare_pairs`` hands them to the prepass
(2048-ray tiles of 8 subtiles, groups of 8 blocks).  Then, per profile:

- the port's kernel (``csrc/raycast_pairs.cu`` through
  ``_kernels.raycast_pairs_prepass_cuda``): its four outputs against the
  plain three-level model (``raycast_pairs.prepass_model``), bit for bit,
  the megas each tile enters, and the least slab tests of these rays
  (``raycast_pairs.prepass_floors``: per ray, per 32 and per 256 rays);
- its counting launch (``raycast_pairs_prepass_count_cuda``): the same
  outputs, and stage counts that must equal the model's;
- each ``--against`` source, built with the port's nvcc flags for the pair
  source (``variants.build_variant``) and run through the port's wrapper
  (``_kernels._prepass``: count pass, CSR offsets, one host read, fill pass)
  with its own ``raycast_pairs_prepass_launch``, which takes the
  ``stage_counts`` argument or, in sources older than it, does not: its four
  outputs against the port's, bit for bit;
- the time of each, with CUDA events, in turns
  (``variants.time_in_turns``).

With ``--ptxas`` it also reports each kernel of the port's pair source's
registers, shared memory and spill bytes (``variants.ptxas_report``).

Prints one JSON object (and writes it to ``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ipcgen_tpu_torch import variants

OUTPUTS = ("offsets", "blocks", "groups", "union")


def takes_stage_counts(src: Path) -> bool:
    """Does ``src``'s ``raycast_pairs_prepass_launch`` take ``stage_counts``?"""
    text = src.read_text()
    head = text[text.index("int raycast_pairs_prepass_launch("):]
    return "stage_counts" in head[:head.index(")")]


def build_other(name: str, src: Path):
    """Compile ``src`` as the port compiles csrc/raycast_pairs.cu and bind its
    prepass launch function; returns (library, takes stage_counts)."""
    from ipcgen_tpu_torch.ops import _kernels

    lib = variants.build_variant(name, src, "raycast_pairs")
    counts_arg = takes_stage_counts(src)
    argtypes = list(_kernels.KERNELS["raycast_pairs_prepass"][1])
    if not counts_arg:
        del argtypes[12]
    lib.raycast_pairs_prepass_launch.restype = ctypes.c_int
    lib.raycast_pairs_prepass_launch.argtypes = argtypes
    return lib, counts_arg


def run_other(other, o, d, boxes, group: int, t_max: float, n_sub: int):
    """The port's wrapper with ``other``'s launch function (the scratch it
    allocates, one byte per (tile, block), also holds an older source's one
    bit per (tile, group))."""
    from ipcgen_tpu_torch.ops import _kernels

    lib, counts_arg = other
    stream = torch.cuda.current_stream(o.device).cuda_stream

    def launch(*args):
        if not counts_arg:
            args = args[:12] + args[13:]
        rc = lib.raycast_pairs_prepass_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(lib.raycast_pairs_error_string(rc).decode())

    return _kernels._prepass(o, d, *boxes, group, t_max, n_sub, counting=False, launch=launch)


def profile_inputs(device):
    """(name, prepass inputs) of the BLK2GO and dense-32 runs on the main room,
    and the asset."""
    from ipcgen_tpu_torch.models.lidar_intrinsics import (
        DualAxisLidarIntrinsics,
        Indoor8LineLidarIntrinsics,
    )
    from ipcgen_tpu_torch.ops.raycast_pairs import prepare_pairs
    from ipcgen_tpu_torch.profile_scan import main_room
    from ipcgen_tpu_torch.sim.scan import scan_rays

    _, asset, poses = main_room(device)
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    out = []
    for name, intr in (("blk2go", DualAxisLidarIntrinsics.create_blk2go_dual_axis()),
                       ("dense32", Indoor8LineLidarIntrinsics.create_dense_32line())):
        o, d, _ = scan_rays(intr, poses, torch.Generator(device=device).manual_seed(0), device)
        p = prepare_pairs(o, d, *comps, t_max=float(intr.max_range))
        out.append((name, {k: p[k] for k in ("origins", "dirs", "t_init", "group", "tile",
                                             "sub")}))
    return asset, out


def compare(asset, p: dict, others: dict) -> dict:
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_pairs import (
        MEGA,
        _tile_slab_or,
        group_boxes,
        mega_boxes,
        prepass_floors,
        prepass_model,
    )

    o, d, group, t_max = p["origins"], p["dirs"], p["group"], p["t_init"]
    tile = p["tile"]
    n_sub = tile // p["sub"]
    kw = dict(t_max=t_max, group=group, tile=tile)
    boxes = (asset.block_lo, asset.block_hi, *group_boxes(asset.block_lo, asset.block_hi,
                                                          group))
    port = _kernels.raycast_pairs_prepass_cuda(o, d, *boxes, group, t_max, n_sub)
    model = prepass_model(o, d, asset.block_lo, asset.block_hi, n_sub=n_sub, **kw)
    counted = _kernels.raycast_pairs_prepass_count_cuda(o, d, *boxes, group, t_max, n_sub)
    n_tiles = o.shape[0] // tile
    mlo, mhi = mega_boxes(*boxes[2:])
    megas_hit = _tile_slab_or(o.view(n_tiles, tile, 3), d.view(n_tiles, tile, 3), mlo, mhi,
                              t_max).sum(1).float()
    res = {"rays": int(o.shape[0]), "tiles": n_tiles, "groups": int(boxes[2].shape[0]),
           "megas": int(mlo.shape[0]), "mega_factor": MEGA, "pairs": int(port[1].numel()),
           "model_equal": {k: bool(torch.equal(g, w)) for k, g, w in zip(OUTPUTS, port, model)},
           "model_counts": model[4],
           "count_equal": all(torch.equal(g, w) for g, w in zip(counted[:4], port)),
           "kernel_counts": counted[4],
           "floors": prepass_floors(o, d, asset.block_lo, asset.block_hi, **kw),
           "megas_hit_per_tile": {"mean": float(megas_hit.mean()),
                                  "p50": float(megas_hit.median()),
                                  "p90": float(megas_hit.quantile(0.9)),
                                  "max": float(megas_hit.max())},
           "groups_hit_per_tile_mean": float(model[2].float().mean()),
           "two_level_tests": n_tiles * tile * int(boxes[2].shape[0])
           + int(model[2].sum()) * group * tile}
    res["three_level_tests"] = sum(model[4][k] for k in ("mega_tests", "group_tests",
                                                         "block_tests"))
    fns = {"port": lambda: _kernels.raycast_pairs_prepass_cuda(o, d, *boxes, group, t_max,
                                                               n_sub)}
    runs = {"port": {}}
    for name, other in others.items():
        got = run_other(other, o, d, boxes, group, t_max, n_sub)
        runs[name] = {"equal": {k: bool(torch.equal(g, w))
                                for k, g, w in zip(OUTPUTS, got, port)}}
        fns[name] = (lambda other=other: run_other(other, o, d, boxes, group, t_max, n_sub))
    for name, ms in variants.time_in_turns(fns).items():
        runs[name]["ms"] = ms
    res["runs"] = runs
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SRC.cu")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prepass_compare needs a CUDA device")

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.utils.device import card_line

    device = torch.device("cuda", 0)
    out = {"card": card_line()}
    _kernels.build()
    others = {name: build_other(name, src)
              for name, src in variants.against(args.against).items()}
    if args.ptxas:
        out["ptxas"] = variants.ptxas_report("raycast_pairs")
    asset, inputs = profile_inputs(device)
    out["blocks"] = asset.num_blocks
    for name, p in inputs:
        out[name] = compare(asset, p, others)
        print(json.dumps({name: out[name]}), flush=True)
    variants.emit(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
