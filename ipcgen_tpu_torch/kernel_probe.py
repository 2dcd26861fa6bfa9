"""The pair kernel's probe: where a per-tile walk over leaf-block panels
spends its time on the card.

    python -m ipcgen_tpu_torch.kernel_probe [NAME ...] [--device cuda|cpu]
        [--waypoints N] [--rays N] [--triangles N] [--out FILE.json]
        [--against NAME=SRC.cu ...] [--ptxas]

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
triangles there).  The result also holds ``call``'s schedule (``schedule``:
the work items of ``ITEM_PANELS`` panels and the panels per tile).

On the card, each ``--against`` source is built as the port builds
``csrc/raycast_probe.cu`` (``variants.build_variant``) and run on the same
inputs for every NAME: its t and slot against the port's, bit for bit, and
both timed in turns (``variants.time_in_turns``).  A source with a
``kItemPanels`` constant runs through the port's wrapper with its own item
size; one without it takes the one-block-per-tile ``call`` interface, which
writes its outputs in place.  ``--ptxas`` adds the registers, shared memory
and spills of every kernel of the port's source and of each other source.
The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
from pathlib import Path

import torch

from ipcgen_tpu_torch import variants
from ipcgen_tpu_torch.ops import _kernels
from ipcgen_tpu_torch.ops import raycast_probe as rp
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
from ipcgen_tpu_torch.utils.device import as_device, card_line
from ipcgen_tpu_torch.utils.synthetic import patch_ordered_scan_rays, synthetic_room

REPS = 3
DEFAULT_NAMES = ("dmaonly", "matmul", "nodma", "full")
FLAT_GMAX = 96
# raycast_probe_call_launch of a source without work items: f, ids, counts,
# ovf, trif, t_out, slot_out, n_tiles, vmax, nb, mode, t_init, stream.
PER_TILE_CALL_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]


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


def schedule(base: dict) -> dict:
    """``call``'s work on the probe's inputs: the tiles that overflowed, the
    panels walked, the work items of at most ``ITEM_PANELS`` panels and the
    panels per tile."""
    vmax = base["ids"].shape[0]
    trips = rp.walk_trips(base["counts"], base["ovf"], base["nb"], vmax)
    offsets = rp.item_offsets(base["counts"], base["ovf"], base["nb"], vmax)
    q = torch.quantile(trips.double(), torch.tensor([0.5, 0.9], dtype=torch.float64,
                                                    device=trips.device))
    return dict(item_panels=rp.ITEM_PANELS, overflow_tiles=int((base["ovf"] != 0).sum()),
                walked_panels=int(trips.sum()), items=int(offsets[-1]),
                panels_per_tile={"p50": float(q[0]), "p90": float(q[1]),
                                 "max": int(trips.max())})


def launcher(name: str, base: dict, flat, other=None):
    """(launch, walked pairs) of one probe NAME on the prepared inputs.
    ``other`` ((library, item panels) from ``build_other``) launches another
    build of the source instead of the port's."""
    lib, k = other if other is not None else (None, None)
    n_tiles, t_init = base["n_tiles"], base["t_init"]
    if name == "flat":
        args = (flat["f"], flat["pair_tiles"], flat["pair_blocks"], n_tiles, flat["trif"],
                t_init)
        fn = rp.probe_flat if lib is None else functools.partial(
            _kernels.raycast_probe_flat_cuda, lib=lib)
        return (lambda: fn(*args)), flat["pair_tiles"].numel()
    if name.startswith("grid"):
        cap = grid_cap(name)
        ids_flat, counts = rp.grid_ids(base["ids"], base["counts"], cap)
        args = (base["f"], ids_flat, counts, base["trif"], cap, t_init)
        fn = rp.probe_grid if lib is None else functools.partial(
            _kernels.raycast_probe_grid_cuda, lib=lib)
        return (lambda: fn(*args)), int(counts.sum())
    trif = base["trif_bf16"] if name == "bf16" else base["trif"]
    args = (base["f"], base["ids"], base["counts"], base["ovf"], trif, name, t_init)
    if lib is None:
        fn = rp.probe_call
    elif k is None:
        fn = functools.partial(per_tile_call, lib)
    else:
        fn = functools.partial(_kernels._probe_call, lib=lib, item_panels=k)
    walked = rp.walk_trips(base["counts"], base["ovf"], base["nb"], base["ids"].shape[0])
    return (lambda: fn(*args)), int(walked.sum())


def run(names, device="cuda", waypoints: int = 20, rays: int = 128_000,
        triangles: int = 160_000, asset=None) -> dict:
    """Run each probe NAME on ``device``: the kernels on a CUDA device (timed),
    their plain versions on the CPU.

    Returns ``{"rays", "tiles", "blocks", "triangles", "overflow_tiles",
    "schedule", "origins", "dirs", "inputs", "flat_inputs", "results": {name:
    {"pairs", "hit", "ms", "out"}}}``; ``out`` is the (t, slot) pair of the
    last launch, ``ms`` None on the CPU.
    """
    device = as_device(device)
    names = check_names(names)
    asset, o, d, base = probe_inputs(device, waypoints, rays, triangles, asset)
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    flat = None
    if "flat" in names:
        flat = rp.prepare_probe(o, d, *comps, gmax=FLAT_GMAX)
        flat["pair_tiles"], flat["pair_blocks"] = rp.flat_pairs(
            flat["ids"], flat["counts"], flat["ovf"], flat["nb"])

    results = {}
    for name in names:
        launch, pairs = launcher(name, base, flat)
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
    return dict(rays=int(o.shape[0]), tiles=base["n_tiles"], blocks=base["nb"],
                triangles=int((asset.tri_index >= 0).sum()),
                overflow_tiles=int(base["ovf"].sum()), schedule=schedule(base), origins=o,
                dirs=d, inputs=base, flat_inputs=flat, results=results)


def build_other(name: str, src: Path):
    """Compile ``src`` as the port compiles csrc/raycast_probe.cu and bind its
    three launch functions; returns (library, its ``kItemPanels``, or None
    for a source without work items)."""
    lib = variants.build_variant(name, src, "raycast_probe")
    m = re.search(r"constexpr int kItemPanels = (\d+);", src.read_text())
    k = int(m.group(1)) if m else None
    for kernel in ("raycast_probe_call", "raycast_probe_grid", "raycast_probe_flat"):
        fn = getattr(lib, f"{kernel}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = (PER_TILE_CALL_ARGTYPES if kernel == "raycast_probe_call" and k is None
                       else _kernels.KERNELS[kernel][1])
    return lib, k


def per_tile_call(lib, f, ids, counts, ovf, trif, mode: str, t_init: float):
    """``call`` through a source without work items: one CUDA block per tile,
    outputs written in place.  Uncounted."""
    n = f.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=f.device)
    slot = torch.empty(n, dtype=torch.int32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.raycast_probe_call_launch(
        f.data_ptr(), ids.data_ptr(), counts.data_ptr(), ovf.data_ptr(), trif.data_ptr(),
        t.data_ptr(), slot.data_ptr(), counts.shape[0], ids.shape[0], trif.shape[0],
        rp.MODES.index(mode), float(t_init), stream)
    if rc != 0:
        raise RuntimeError(lib.raycast_probe_error_string(rc).decode())
    return t, slot


def readable_ptxas(report: dict) -> dict:
    """``variants.ptxas_report``'s entries with ``call``'s instances named
    by mode (``probe_call_kernel<full>``); other kernels keep their mangled
    names."""
    out = {}
    for mangled, row in report.items():
        m = re.search(r"probe_call_kernelILi(\d+)E", mangled)
        out[f"probe_call_kernel<{rp.MODES[int(m.group(1))]}>" if m else mangled] = row
    return out


def compare(res: dict, others: dict) -> dict:
    """Each other build against the port on ``run``'s inputs, for every NAME
    of the run: t and slot bit for bit, and the times in turns."""
    base, flat = res["inputs"], res["flat_inputs"]
    out = {}
    for name, r in res["results"].items():
        t_port, s_port = r["out"]
        fns = {"port": launcher(name, base, flat)[0]}
        rows = {"port": {}}
        for other_name, other in others.items():
            fns[other_name] = launcher(name, base, flat, other)[0]
            t_o, s_o = fns[other_name]()
            rows[other_name] = {"bits_equal": bool(
                torch.equal(t_o.view(torch.int32), t_port.view(torch.int32))
                and torch.equal(s_o, s_port))}
        for other_name, ms in variants.time_in_turns(fns).items():
            rows[other_name]["ms"] = ms
        out[name] = rows
        print(f"[against] {name}: {json.dumps(rows)}", flush=True)
    return out


def summary(res: dict, device) -> dict:
    """The JSON-ready part of ``run``'s result."""
    out = {k: res[k] for k in ("rays", "tiles", "blocks", "triangles", "overflow_tiles",
                               "schedule")}
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
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SRC.cu")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    on_card = as_device(args.device).type == "cuda"
    if (args.against or args.ptxas) and not on_card:
        raise SystemExit("--against and --ptxas need a CUDA device")
    others = {name: build_other(name, src)
              for name, src in variants.against(args.against).items()}
    res = run(args.names, args.device, args.waypoints, args.rays, args.triangles)
    print(f"{res['tiles']} tiles, {res['blocks']} blocks, "
          f"{res['overflow_tiles']} overflowed; call's schedule "
          f"{json.dumps(res['schedule'])}", flush=True)
    for name, r in res["results"].items():
        if r["ms"] is None:
            print(f"{name:11s}: {r['pairs']} pairs, hit {r['hit']:.4f} "
                  "(plain version on the CPU; not timed)", flush=True)
        else:
            print(f"{name:11s}: {r['ms']:9.3f} ms  ({r['ms'] * 1e3 / max(r['pairs'], 1):.3f} "
                  f"us/pair, {r['pairs']} pairs, hit {r['hit']:.4f})", flush=True)
    out = summary(res, args.device)
    if others:
        out["against"] = compare(res, others)
    if args.ptxas:
        srcs = {"port": None, **variants.against(args.against)}
        out["ptxas"] = {name: readable_ptxas(variants.ptxas_report("raycast_probe", src))
                        for name, src in srcs.items()}
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
