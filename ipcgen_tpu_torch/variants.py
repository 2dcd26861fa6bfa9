"""Build other versions of a kernel source and time them against the port's.

Used by ``kernel_probe --against``.  A version given as ``--against
NAME=SRC.cu`` is compiled as the port compiles ``csrc/<source>.cu``
(``_kernels.NVCC_FLAGS`` and the source's own flags) into
``build/ipcgen_tpu_torch/compare/lib<NAME>.so``.  Versions are timed
with CUDA events in turns: the port, each other version, each other version
again in reverse order, the port; each turn is the mean of ``REPS`` calls
after one warm-up.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

REPS = 5


def against(specs) -> dict:
    """{NAME: Path(SRC)} from ``--against NAME=SRC.cu`` arguments."""
    return {name: Path(src) for name, src in (spec.split("=", 1) for spec in specs)}


def build_variant(name: str, src: Path, source: str) -> ctypes.CDLL:
    """Compile ``src`` as the port compiles ``csrc/<source>.cu``; load it and
    bind its ``<source>_error_string``."""
    from ipcgen_tpu_torch.ops import _kernels

    out_dir = _kernels.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *_kernels.SOURCES[source],
                          "-o", str(so), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    error_string = getattr(lib, f"{source}_error_string")
    error_string.restype = ctypes.c_char_p
    error_string.argtypes = [ctypes.c_int]
    return lib


def ptxas_report(source: str, src: Path | None = None) -> dict:
    """Registers, shared memory and spill bytes of each kernel of
    ``csrc/<source>.cu``, or of ``src`` built as that source is (``nvcc
    -Xptxas -v`` with the port's flags), by mangled name."""
    from ipcgen_tpu_torch.ops import _kernels

    out_dir = _kernels.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = _kernels.nvcc_command(source, out_dir / f"libptxas_{source}.so", _kernels._nvcc())
    if src is not None:
        cmd[-1] = str(src)
    res = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:], check=True,
                         capture_output=True, text=True)
    report, current = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            report[current] = {}
        elif current and "spill" in line:
            nums = re.findall(r"(\d+) bytes (spill stores|spill loads)", line)
            report[current].update({kind.replace(" ", "_"): int(n) for n, kind in nums})
        elif current and "Used" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[current]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                report[current]["smem_bytes"] = int(m.group(1))
    return report


def time_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(fns: dict) -> dict:
    """{name: [ms, ms]} for ``fns`` ({name: fn}, the port's first), timed in
    turns: the port, each other, each other again in reverse order, the
    port."""
    port, *others = fns
    times = {name: [] for name in fns}
    for name in (port, *others, *reversed(others), port):
        times[name].append(time_ms(fns[name]))
    return times
