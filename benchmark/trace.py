"""What a ``--trace 1`` run records: the benchmark's own host spans around
the calls into the program's layers, and the device's trace from
``torch.profiler``.

Host spans come from wrapping, for the traced run only, the functions
that each layer enters through (``SPANS``); the wrapper notes the start
and end (``time.time_ns``) and the thread.  The device trace is
``torch.profiler`` with device activity only (kernels, copies, sets).  From the two this module gives
the seconds the device was busy (the union of its intervals), the device
time by operation name, and the idle gaps named by the span that was open
on the host then.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# (span name, module, attribute path) of each layer's entry.
SPANS = (
    ("load_scene", "ipcgen_tpu_torch.sim.simulator", "S3DISSimulator.load_scene"),
    ("trajectory", "ipcgen_tpu_torch.sim.simulator", "S3DISSimulator.generate_auto_trajectory"),
    ("dispatch", "ipcgen_tpu_torch.sim.simulator", "S3DISSimulator.dispatch_scan"),
    ("frame_build", "ipcgen_tpu_torch.sim.simulator", "S3DISSimulator.collect_scan"),
    ("export", "ipcgen_tpu_torch.sim.simulator", "S3DISSimulator.save_results"),
    ("label_prefetch", "ipcgen_tpu_torch.containers.sim_scene", "LabelPrefetch._work"),
    ("label_join", "ipcgen_tpu_torch.containers.sim_scene",
     "S3DISSimScene._get_colors_and_labels_from_s3dis"),
    ("preprocess", "ipcgen_tpu_torch.preprocess.loader", "preprocess_room"),
    ("recon", "ipcgen_tpu_torch.recon.cli", "reconstruct_room"),
    ("bbox", "ipcgen_tpu_torch.bbox.detection", "S3DISBBoxVisualizer.visualize_room_bboxes"),
    ("eval", "ipcgen_tpu_torch.eval.evaluate", "find_best_match"),
)

NAME_CHARS = 160  # a device operation's name in the breakdown, at most


class HostSpans:
    """Wraps the ``SPANS`` entries while active; ``spans`` holds
    (name, start ns, end ns, thread id, is main thread)."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int, int, bool]] = []
        self._saved = []
        self._main = threading.main_thread().ident

    def __enter__(self):
        for name, module, path in SPANS:
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                tid = threading.get_ident()
                self.spans.append((name, t0, time.time_ns(), tid, tid == self._main))
        return wrapped

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity in ``prof``."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" in str(ev.device_type()) and ev.duration_ns() > 0:
            out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def name_gaps(gaps, spans) -> List[str]:
    """For each idle gap (start, end), the host span that covers most of
    it: the main thread's first, then any thread's; the innermost
    (shortest) on a tie; "harness" where none is open."""
    import numpy as np

    if not gaps:
        return []
    s = np.array([g[0] for g in gaps], np.int64)
    e = np.array([g[1] for g in gaps], np.int64)
    best = np.full(len(gaps), -1)
    for main_only in (True, False):
        best_ov = np.zeros(len(gaps), np.int64)
        best_len = np.full(len(gaps), np.iinfo(np.int64).max)
        pick = np.full(len(gaps), -1)
        for j, (_name, a, b, _tid, is_main) in enumerate(spans):
            if main_only and not is_main:
                continue
            ov = np.minimum(b, e) - np.maximum(a, s)
            better = (ov > 0) & ((ov > best_ov) | ((ov == best_ov) & (b - a < best_len)))
            pick[better], best_ov[better], best_len[better] = j, ov[better], b - a
        best = np.where(best < 0, pick, best)
    return [spans[j][0] if j >= 0 else "harness" for j in best]


def summarise(events, spans, t0_ns: int, t1_ns: int, top: int = 10) -> Optional[Dict]:
    """Busy and window seconds, device seconds by name, the top device
    operations and the idle gaps named by host span, over [t0, t1]."""
    clipped = [(n, max(a, t0_ns), min(b, t1_ns)) for n, a, b in events
               if b > t0_ns and a < t1_ns]
    if not clipped:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in clipped:
        by_name[n] += (b - a) / 1e9
    busy = merge([(a, b) for _, a, b in clipped])
    busy_s = sum(b - a for a, b in busy) / 1e9
    holes, prev = [], t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(holes, name_gaps(holes, spans)):
        gaps[name] += (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "...", v) for n, v in ops]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_s,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "kernels": dict(by_name),
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": [[n, s] for n, s in idle],
    }
