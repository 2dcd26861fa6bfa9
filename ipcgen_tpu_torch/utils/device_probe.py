"""Bounded device health probe for benchmark entry points (port of
``ipcgen_tpu/utils/device_probe.py``).

A benchmark checks the card from a subprocess, whose hang a timeout bounds,
before it touches the card itself: the probe runs a small product on the
card and reports the platform.
"""

from __future__ import annotations

import subprocess
import sys
import time

_PROBE = (
    "import torch\n"
    "assert torch.cuda.is_available()\n"
    "x = torch.ones((128, 128), device='cuda')\n"
    "v = float((x @ x).sum())\n"
    "assert v == 128.0 ** 3, v\n"
    "print('DEVICE_OK', 'gpu', flush=True)\n"
)


def probe_device(timeout_s: float = 120.0, env=None):
    """``"gpu"`` when a subprocess runs a 128 x 128 product on the card within
    ``timeout_s``, else None (no card, or it did not answer in time).
    ``env`` overrides the subprocess environment."""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            env=env,
        )
    except subprocess.TimeoutExpired:
        return None
    for line in proc.stdout.splitlines():
        if line.startswith("DEVICE_OK"):
            return line.split()[1]
    return None


def wait_for_device(max_wait_s: float = 900.0, poll_s: float = 60.0,
                    probe_timeout_s: float = 120.0):
    """Probe until the card answers or ``max_wait_s`` elapses; the platform
    name, or None on timeout."""
    deadline = time.monotonic() + max_wait_s
    while True:
        platform = probe_device(probe_timeout_s)
        if platform is not None:
            return platform
        if time.monotonic() >= deadline:
            return None
        time.sleep(poll_s)
