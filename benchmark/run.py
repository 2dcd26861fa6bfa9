"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
``BENCHMARK.json``; its configuration in ``benchmark/configs/<config>.json``
(which names the entry that drives the program, ``benchmark/entries/
<entry>.py``); its traffic in ``benchmark/traffic/<traffic>.json``; each
end-to-end metric's arithmetic in ``benchmark/e2e/<metric>.py`` and each
per-layer metric's reader in ``benchmark/metrics/<metric>.py``.  A cell,
configuration, traffic mix or metric is added as files and entries, with
no edit here.

A run: make the cell's rooms from ``--seed`` and pass one warm room
through the entry (set-up, ``setup_s``); drive the entry for ``--seconds``
(the window; whole calls, the last one started before the time is up);
read the peak device memory; free the program's state; check what the
window produced against the plain reference (``correct``); print the
numbers compared with their limits as the last lines of standard error,
and one JSON object as the last line of standard output.  ``--trace 1``
adds the benchmark's host spans and the device trace and reports the
per-layer metrics instead of the end-to-end ones.

The run works in a directory of its own under ``TMPDIR``, removed at the
end; the program's kernel builds stay under ``build/`` in the checkout.
It exits non-zero and prints no result without a CUDA device, with fewer
than the cell's devices, or when a module of JAX or of the JAX package is
loaded (``benchmark/guard.py``).
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench_cache"
# Kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)

sys.path.insert(0, str(ROOT))
from benchmark.guard import forbidden_loaded  # noqa: E402


class RunError(Exception):
    """A run that must exit non-zero without a result."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise RunError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, workload: str, bench_dir: Path = BENCH):
    """(cell, config, traffic, entry module) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    entry = load_module(bench_dir / "entries" / f"{config['entry']}.py",
                        f"benchmark_entry_{config['entry']}")
    return cell, config, traffic, entry


def metrics_of(bench: dict, kind: str, workload: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def compute_metrics(specs, folder: str, fn: str, record: dict, bench_dir: Path = BENCH):
    """{name: {"value", "unit"}} of each metric whose module gives a number."""
    out = {}
    for m in specs:
        mod = load_module(bench_dir / folder / f"{m['name']}.py",
                          f"benchmark_{folder}_{m['name'].replace('.', '_')}")
        value = getattr(mod, fn)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def host_reading() -> dict:
    """The host beside a run: the load average, the cores' mean clock, and
    this process's CPU seconds so far (diagnostics, never a metric)."""
    out = {"cpu_s": sum(os.times()[:2])}
    try:
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        pass
    return out


def guard(where: str):
    found = forbidden_loaded()
    if found:
        raise RunError(f"forbidden modules loaded {where}: {found}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", need_device: bool = True, bench_path: Path = None,
             bench_dir: Path = BENCH) -> dict:
    """One run of a cell; returns the result line as a dict.  ``control``
    (never in the benchmark's own runs) also judges the control's outputs
    in place of the program's, under ``control_checks``;
    ``need_device=False`` skips the look for a card (the CPU tests)."""
    bench = json.loads((bench_path or ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic, entry = load_cell(bench, workload, bench_dir)
    import torch

    if need_device:
        require_devices(int(cell["chips"]))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    workdir = Path(tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR")))
    cwd = os.getcwd()
    os.chdir(workdir)  # the pipeline's eval stage writes ./evaluation_results
    try:
        runner = entry.Cell(config, traffic, seed, workdir, device)
        runner.setup()
        sync()
        guard("after set-up")
        setup_s = time.time() - T_PROCESS
        from benchmark import trace as tr

        host = tr.HostSpans()
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                if trace and cuda else None)
        with contextlib.ExitStack() as stack:
            if trace:
                stack.enter_context(host)
            if prof is not None:
                stack.enter_context(prof)
            host0 = host_reading()
            t0 = time.time()
            k = 0
            call_s, call_rooms = [], []
            while True:
                c0, rooms0 = time.time(), runner.done()
                runner.call(k)
                call_s.append(time.time() - c0)
                call_rooms.append(runner.done() - rooms0)
                k += 1
                if time.time() - t0 >= seconds:
                    break
            sync()
            t1 = time.time()
        host1 = host_reading()
        guard("after the window")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        record = {"setup_s": setup_s, "window_s": t1 - t0, "rooms_done": runner.done()}
        trace_rec = runner.trace_record()
        spans = {}
        for room in trace_rec["rooms"]:
            for name, v in room.items():
                spans[name] = spans.get(name, 0.0) + v / len(trace_rec["rooms"])
        # The host line, diagnostics and never a metric: each call's wall
        # seconds and rooms show whether a spread sits at call boundaries;
        # ``check_s`` and ``run_s`` (set by ``main``) time the check and
        # the whole run, which grow with the rooms in the window.
        beside = {"load1": [host0.get("load1"), host1.get("load1")],
                  "mhz": [host0.get("mhz"), host1.get("mhz")],
                  "cpu_s_per_s": (host1["cpu_s"] - host0["cpu_s"]) / (t1 - t0),
                  "calls": k, "call_s": call_s, "call_rooms": call_rooms,
                  "span_means_s": spans}
        runner.release()
        if cuda:
            torch.cuda.empty_cache()
        c0 = time.time()
        checks = runner.check()
        beside["check_s"] = time.time() - c0
        control_checks = runner.check(control=True) if control else None
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": correct, "attempted": runner.attempted,
                  "failed": runner.attempted - runner.done()}
        kind, folder, fn = (("per_layer", "metrics", "read") if trace
                            else ("end_to_end", "e2e", "value"))
        summary = None
        if trace:
            events = tr.device_events(prof) if prof is not None else []
            summary = (tr.summarise(events, host.spans, int(t0 * 1e9), int(t1 * 1e9))
                       if events else None)
            trace_rec["device"] = summary
        result["metrics"] = compute_metrics(metrics_of(bench, kind, workload), folder, fn,
                                            trace_rec if trace else record, bench_dir)
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit() if cuda else None,
        }
        if trace:
            result["device"]["busy_s"] = summary["busy_s"] if summary else 0.0
            result["device"]["window_s"] = t1 - t0
            if summary:
                result["breakdown"] = {"device_ops": summary["device_ops"],
                                       "idle_gaps": summary["idle_gaps"]}
        guard("after the check")
        result["host"] = beside
        if control:
            result["control_checks"] = control_checks
        result["checks"] = checks
        return result
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    host = result.pop("host")
    host["run_s"] = time.time() - T_PROCESS
    print("host " + json.dumps(host), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
