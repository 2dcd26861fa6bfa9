"""Mesh surface sampling (port of ``ipcgen_tpu/ops/sampling.py``).

Area-weighted uniform surface sampling, and a blue-noise thinning of it, for
the reconstruction evaluator (the reference uses Open3D's Poisson-disk
sampler).  The JAX package draws with ``jax.random`` from ``PRNGKey(0)``,
whose stream torch cannot reproduce: here the draws come from a
``torch.Generator`` seeded 0 unless the caller passes one, and ``_sample``
takes the two uniform draws as arguments so that a test can feed it the JAX
draws.  The JAX package pads the triangle list to a power-of-two bucket to
share compiled programs; the port does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.utils.device import device_or_card


def _mesh_tables(mesh, device) -> Tuple[torch.Tensor, ...]:
    """(v0, e1, e2, cumulative area), float32 on ``device``: each triangle's
    first corner and two edges, and the running sum of the areas."""
    corners = mesh.triangle_corners().astype(np.float32)
    v0 = corners[:, 0]
    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 2] - corners[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    cum = np.cumsum(areas)
    if cum[-1] <= 0:
        raise ValueError("sample_points_on_mesh: degenerate mesh (zero area).")
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (v0, e1, e2, cum))


def _sample(v0, e1, e2, cum_area, n: int, generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None):
    """``n`` area-uniform surface points: a triangle by ``u`` (n,) uniform
    in [0, 1) over the cumulative area, a point in it by ``r`` (n, 2) with
    the square-root trick.  ``u`` and ``r`` are drawn from ``generator``
    when not given."""
    device = v0.device
    if u is None:
        u = torch.rand(n, generator=generator, device=device)
    if r is None:
        r = torch.rand((n, 2), generator=generator, device=device)
    tri = torch.searchsorted(cum_area, u * cum_area[-1], right=True)
    tri = tri.clamp(0, v0.shape[0] - 1)
    su = torch.sqrt(r[:, 0:1])
    a = 1.0 - su
    b = su * r[:, 1:2]
    return v0[tri] + a * e1[tri] + b * e2[tri]


def sample_points_on_mesh(mesh, n: int, generator: Optional[torch.Generator] = None, *,
                          device=None) -> np.ndarray:
    """Sample ``n`` points uniformly by area from a TriMesh surface on
    ``device`` (None: the card); the draws come from ``generator``, by
    default one seeded 0 on that device.  (n, 3) float32 numpy."""
    device = device_or_card(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return _sample(*_mesh_tables(mesh, device), int(n), generator).cpu().numpy()


def sample_points_poisson_disk(
    mesh, n: int, generator: Optional[torch.Generator] = None, oversample: int = 4, *,
    device=None,
) -> np.ndarray:
    """Blue-noise-ish surface sampling (replaces Open3D's
    ``sample_points_poisson_disk``, reference call site
    s3dis_nksr_reconstructor.py:293-295).

    Oversample the surface uniformly by area, then thin with a uniform grid
    whose cell size targets the Poisson radius r ≈ sqrt(A / (2√3·n))
    (hex-packing density), keeping one point per cell; O(N) and vectorised
    instead of a sequential rejection loop.
    """
    cand = sample_points_on_mesh(mesh, n * oversample, generator, device=device)
    area = float(mesh.surface_area())
    if area <= 0 or len(cand) == 0:
        return cand[:n]
    r = float(np.sqrt(area / (2.0 * np.sqrt(3.0) * max(n, 1))))
    cell = max(r, 1e-9)
    keys = np.floor((cand - cand.min(axis=0)) / cell).astype(np.int64)
    packed = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    _, first = np.unique(packed, return_index=True)
    picked = cand[np.sort(first)]
    if len(picked) >= n:
        return picked[:n]
    # Fill the remainder with unused candidates (rare: very rough meshes)
    mask = np.ones(len(cand), bool)
    mask[first] = False
    extra = cand[mask][: n - len(picked)]
    return np.concatenate([picked, extra])
