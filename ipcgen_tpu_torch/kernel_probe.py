"""The pair kernel's probe: where a per-tile walk over leaf-block panels
spends its time on the card.

    python -m ipcgen_tpu_torch.kernel_probe [NAME ...] [--device cuda|cpu]
        [--waypoints N] [--rays N] [--triangles N] [--out FILE.json]

Port of ``scripts/kernel_probe.py``, with its workload at full size: the
room ``synthetic_room(160_000)`` (159,744 triangles, 1,536 blocks), the
2.56 M dense-32 rays of ``patch_ordered_scan_rays(20)`` in patch order, and
the candidate prepass with t_max 25 over 1024-ray tiles, vmax 256 and gmax
48 (96 for ``flat``), TB 128.  Each NAME is one of

- a mode of ``call`` (``ops.raycast_probe.MODES``: full, full4, recip,
  recip4, bf16, quad, dmaonly, dmaonly4, matmul, quadfloor, smallcarry4,
  nodma), the per-tile walk of the candidate list;
- ``flat``, the walk over the flat list of real (tile, block) pairs;
- ``gridN`` (``grid`` = ``grid32``), the walk over the first N candidates of
  each tile as a (tile x N) grid of steps.

With no NAME it runs dmaonly, matmul, nodma and full, as the JAX script
does; unlike it, several kinds may be given in one run.  On the card each
NAME is launched once to warm up and ``REPS`` times between CUDA events; it
prints ms per launch and microseconds per walked pair.  ``--device cpu``
runs the plain versions and takes no time (use a few waypoints, rays and
triangles there).  The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ipcgen_tpu_torch.ops import raycast_probe as rp
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
from ipcgen_tpu_torch.utils.device import as_device, card_line
from ipcgen_tpu_torch.utils.synthetic import patch_ordered_scan_rays, synthetic_room

REPS = 3
DEFAULT_NAMES = ("dmaonly", "matmul", "nodma", "full")
FLAT_GMAX = 96


def grid_cap(name: str) -> int:
    """``gridN`` -> N (``grid`` alone -> 32)."""
    return int(name[4:] or 32)


def check_names(names) -> list:
    """The probe names, validated; the default set when empty."""
    names = list(names) or list(DEFAULT_NAMES)
    for name in names:
        if name in rp.MODES or name == "flat":
            continue
        if name.startswith("grid") and (name[4:] == "" or name[4:].isdigit()) \
                and grid_cap(name) > 0:
            continue
        raise ValueError(f"unknown probe {name!r}: expected one of {rp.MODES}, "
                         "'flat' or 'gridN'")
    return names


def probe_inputs(device, waypoints: int = 20, rays: int = 128_000,
                 triangles: int = 160_000, asset=None):
    """The room (``asset`` when given), the patch-ordered rays and the
    probe's prepass: (asset, origins, dirs, inputs of ``prepare_probe``)."""
    if asset is None:
        verts, tris = synthetic_room(triangles)
        asset = build_scene_asset(verts, tris, device=device)
    origins, dirs = patch_ordered_scan_rays(waypoints, r=rays)
    o = torch.from_numpy(origins).to(device)
    d = torch.from_numpy(dirs).to(device)
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    return asset, o, d, rp.prepare_probe(o, d, *comps)


def run(names, device="cuda", waypoints: int = 20, rays: int = 128_000,
        triangles: int = 160_000, asset=None) -> dict:
    """Run each probe NAME on ``device``: the kernels on a CUDA device (timed),
    their plain versions on the CPU.

    Returns ``{"rays", "tiles", "blocks", "triangles", "overflow_tiles",
    "origins", "dirs", "inputs", "flat_inputs", "results": {name: {"pairs",
    "hit", "ms", "out"}}}``; ``out`` is the (t, slot) pair of the last
    launch, ``ms`` None on the CPU.
    """
    device = as_device(device)
    names = check_names(names)
    asset, o, d, base = probe_inputs(device, waypoints, rays, triangles, asset)
    n_tiles, t_init = base["n_tiles"], base["t_init"]
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    flat = None
    if "flat" in names:
        flat = rp.prepare_probe(o, d, *comps, gmax=FLAT_GMAX)
        flat["pair_tiles"], flat["pair_blocks"] = rp.flat_pairs(
            flat["ids"], flat["counts"], flat["ovf"], flat["nb"])
    walked = rp.flat_pairs(base["ids"], base["counts"], base["ovf"], base["nb"])[0].numel()

    def launcher(name):
        """(launch, walked pairs) of one probe."""
        if name == "flat":
            return (lambda: rp.probe_flat(flat["f"], flat["pair_tiles"], flat["pair_blocks"],
                                          n_tiles, flat["trif"], t_init),
                    flat["pair_tiles"].numel())
        if name.startswith("grid"):
            cap = grid_cap(name)
            ids_flat, counts = rp.grid_ids(base["ids"], base["counts"], cap)
            return (lambda: rp.probe_grid(base["f"], ids_flat, counts, base["trif"], cap,
                                          t_init),
                    int(counts.sum()))
        trif = base["trif_bf16"] if name == "bf16" else base["trif"]
        return (lambda: rp.probe_call(base["f"], base["ids"], base["counts"], base["ovf"],
                                      trif, name, t_init),
                walked)

    results = {}
    for name in names:
        launch, pairs = launcher(name)
        out = launch()
        ms = None
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                out = launch()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / REPS
        results[name] = dict(pairs=int(pairs), hit=float((out[1] >= 0).float().mean()),
                             ms=ms, out=out)
    return dict(rays=int(o.shape[0]), tiles=n_tiles, blocks=base["nb"],
                triangles=int((asset.tri_index >= 0).sum()),
                overflow_tiles=int(base["ovf"].sum()), origins=o, dirs=d,
                inputs=base, flat_inputs=flat, results=results)


def summary(res: dict, device) -> dict:
    """The JSON-ready part of ``run``'s result."""
    out = {k: res[k] for k in ("rays", "tiles", "blocks", "triangles", "overflow_tiles")}
    device = as_device(device)
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        out["card"] = card_line()
    out["results"] = {
        name: {k: v for k, v in r.items() if k != "out"} for name, r in res["results"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="modes, 'flat' or 'gridN'")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--waypoints", type=int, default=20)
    ap.add_argument("--rays", type=int, default=128_000, help="rays per waypoint")
    ap.add_argument("--triangles", type=int, default=160_000)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    res = run(args.names, args.device, args.waypoints, args.rays, args.triangles)
    print(f"{res['tiles']} tiles, {res['blocks']} blocks, "
          f"{res['overflow_tiles']} overflowed", flush=True)
    for name, r in res["results"].items():
        if r["ms"] is None:
            print(f"{name:11s}: {r['pairs']} pairs, hit {r['hit']:.4f} "
                  "(plain version on the CPU; not timed)", flush=True)
        else:
            print(f"{name:11s}: {r['ms']:9.3f} ms  ({r['ms'] * 1e3 / max(r['pairs'], 1):.3f} "
                  f"us/pair, {r['pairs']} pairs, hit {r['hit']:.4f})", flush=True)
    text = json.dumps(summary(res, args.device))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
