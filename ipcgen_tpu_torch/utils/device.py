"""Device helpers (counterpart of ``ipcgen_tpu/utils/host.py``).

On a local GPU a device->host copy is a plain ``.cpu()``, and
``torch.cuda.synchronize`` is a real completion barrier, so the JAX package's
uint8 detour for bool downloads and its scalar-fetch barrier are not needed.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def as_device(device) -> torch.device:
    """``torch.device`` from a string or device; CUDA without an index
    becomes the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_or_card(device) -> torch.device:
    """``device``, or the card (the current CUDA device) when it is None:
    the port's entry points run on the card unless asked otherwise."""
    return as_device("cuda" if device is None else device)


def sync(x=None) -> None:
    """Wait until the work queued on ``x``'s device has finished.

    ``x`` is a tensor, a device, a string or None (the current CUDA device).
    A CPU tensor or device needs no barrier.
    """
    if isinstance(x, torch.Tensor):
        device = x.device
    elif x is None:
        device = torch.device("cuda")
    else:
        device = torch.device(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and without the
    host waiting on the copy for a CUDA device, a plain copy elsewhere."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host(x) -> np.ndarray:
    """numpy copy of a tensor (or passthrough for array-likes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them
    (a card may be set below its maximum power and then runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
