"""Hold the culled kernel against other builds of it on the BLK2GO scan's rays.

    python -m ipcgen_tpu_torch.culled_compare [--against NAME=SRC.cu ...]
        [--out FILE.json] [--sass DIR]

Builds the main room of ``chip_smoke.py`` and its auto trajectory
(``profile_scan.main_room``: 638,976 triangles, 20 requested waypoints,
seed 0, densified to 40 by the planner) and casts the BLK2GO scan's rays
(``sim.scan.scan_rays``, seed 0) in beam order, as the culled scan casts
them: 2.56 M rays.  Then:

- the port's kernel (``csrc/raycast_culled.cu``): t and slot, and its
  counting instantiation's counts (warp visits, tests, tests past each
  prescreen stage, super visits);
- each ``--against`` source, built with the port's nvcc flags for the
  culled source into ``build/ipcgen_tpu_torch/compare/`` and bound through
  the same C interface (``raycast_culled_launch``, and
  ``raycast_culled_count_launch`` where the source has it, with the port's
  argument list): its t and slot against the port's, bit for bit, and its
  counts;
- the time of each, with CUDA events, in turns (``variants.time_in_turns``:
  the port, each other source, each other source again, the port);
- the visit floors of these rays (``raycast_culled.visit_floors``).

With ``--sass DIR`` it also writes the SASS (``cuobjdump -sass``) of a kernel
that only computes ``__fdiv_rn(1.0f, x)`` and of one that copies ``x``,
built with the same flags, and the instruction count of each.

Prints one JSON object (and writes it to ``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from ipcgen_tpu_torch import variants

DIVIDE_PROBE = r"""
extern "C" __global__ void divide(const float* x, float* y) {
  y[threadIdx.x] = __fdiv_rn(1.0f, x[threadIdx.x]);
}
extern "C" __global__ void copy(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x];
}
"""


def build_other(name: str, src: Path) -> ctypes.CDLL:
    """Compile ``src`` as the port compiles csrc/raycast_culled.cu; bind it."""
    from ipcgen_tpu_torch.ops import _kernels

    lib = variants.build_variant(name, src, "raycast_culled")
    for kernel in ("raycast_culled", "raycast_culled_count"):
        if hasattr(lib, f"{kernel}_launch"):
            fn = getattr(lib, f"{kernel}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = _kernels.KERNELS[kernel][1]
    return lib


def run_lib(lib, args, count: bool):
    """Launch ``raycast_culled[_count]_launch`` of ``lib`` on ``args`` (the
    port's wrapper arguments); returns (t, slot, counts or None)."""
    from ipcgen_tpu_torch.ops._kernels import CULLED_COUNTS

    o, d, tri, blo, bhi, slo, shi, sf, t_init = args
    n, (nb, _, tb), ns = o.shape[0], tri.shape, slo.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    ptrs = [x.data_ptr() for x in (o, d, tri, blo, bhi, slo, shi)] + [t.data_ptr(),
                                                                        slot.data_ptr()]
    counts = None
    if count:
        counts = torch.zeros(len(CULLED_COUNTS), dtype=torch.int64, device=o.device)
        ptrs.append(counts.data_ptr())
    stream = torch.cuda.current_stream(o.device).cuda_stream
    name = "raycast_culled_count_launch" if count else "raycast_culled_launch"
    rc = getattr(lib, name)(*ptrs, n, nb, ns, int(sf), tb, float(t_init), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.raycast_culled_error_string(rc).decode()}")
    if counts is not None:
        counts = dict(zip(CULLED_COUNTS, counts.tolist()))
    return t, slot, counts


def divide_sass(out_dir: Path) -> dict:
    """SASS of ``__fdiv_rn(1.0f, x)`` and of a copy, built as the culled
    source is; returns the instruction count of each function."""
    from ipcgen_tpu_torch.ops import _kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "divide_probe.cu"
    src.write_text(DIVIDE_PROBE)
    cubin = out_dir / "divide_probe.cubin"
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_kernels._nvcc(), *flags, *_kernels.SOURCES["raycast_culled"], "-cubin",
                    "-o", str(cubin), str(src)], check=True, capture_output=True, text=True)
    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    (out_dir / "divide_probe.sass").write_text(sass)
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line) and "NOP" not in line:
            counts[current] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SRC.cu")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("culled_compare needs a CUDA device")

    from ipcgen_tpu_torch.models.lidar_intrinsics import DualAxisLidarIntrinsics
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_culled import t_init_for, visit_floors
    from ipcgen_tpu_torch.profile_scan import main_room
    from ipcgen_tpu_torch.sim.scan import scan_rays
    from ipcgen_tpu_torch.utils.device import card_line

    device = torch.device("cuda", 0)
    out = {"card": card_line()}
    _kernels.build()
    others = {name: build_other(name, src)
              for name, src in variants.against(args.against).items()}
    _, asset, poses = main_room(device)
    intr = DualAxisLidarIntrinsics.create_blk2go_dual_axis()
    o, d, _ = scan_rays(intr, poses, torch.Generator(device=device).manual_seed(0), device,
                        backend="culled")
    t_init = t_init_for(float(intr.max_range))
    kargs = (o.contiguous(), d.contiguous(), asset.tri_data, asset.block_lo, asset.block_hi,
             asset.super_lo, asset.super_hi, asset.super_factor, t_init)
    out.update(rays=int(o.shape[0]), waypoints=int(poses.shape[0]), blocks=asset.num_blocks,
               supers=int(asset.super_lo.shape[0]))

    t_port, s_port = _kernels.raycast_culled_cuda(*kargs)
    tc, sc, counts = _kernels.raycast_culled_count_cuda(*kargs)
    runs = {"port": {"counts": counts, "count_bits_equal":
                     bool(torch.equal(tc, t_port) and torch.equal(sc, s_port))}}
    for name, lib in others.items():
        t_o, s_o, _ = run_lib(lib, kargs, count=False)
        res = {"t_mismatch": int((t_o != t_port).sum()),
               "slot_mismatch": int((s_o != s_port).sum())}
        if hasattr(lib, "raycast_culled_count_launch"):
            res["counts"] = run_lib(lib, kargs, count=True)[2]
        runs[name] = res

    fns = {"port": lambda: _kernels.raycast_culled_cuda(*kargs)}
    fns.update({name: (lambda lib=lib: run_lib(lib, kargs, count=False))
                for name, lib in others.items()})
    for name, ms in variants.time_in_turns(fns).items():
        runs[name]["ms"] = ms
    t_final = torch.where(s_port >= 0, t_port, torch.full_like(t_port, t_init))
    out["floors"] = visit_floors(o, d, asset.block_lo, asset.block_hi, asset.super_lo,
                                 asset.super_hi, asset.super_factor,
                                 asset.tri_data.shape[2], t_final)
    out["hit_rays"] = int((s_port >= 0).sum())
    out["runs"] = runs
    if args.sass is not None:
        out["sass_instructions"] = divide_sass(args.sass)
    variants.emit(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
