"""The raycast backends, named in one place.

The port has three backends (``BACKENDS``):

- ``"pairs"``: the candidate-pair kernel of ``ops/raycast_pairs.py`` (the
  JAX package's mxu); its scan casts a waypoint's rays in patch order;
- ``"culled"``: the two-level AABB-culled Moller-Trumbore kernel of
  ``ops/raycast_culled.py`` (the JAX package's pallas and xla);
- ``"brute"``: the block-scan oracle of ``ops/raycast.py`` (the JAX
  package's xla_brute).

Each has its whole-asset call (``ops.raycast.raycast_asset``), its call over
raw asset components, which a triangle shard casts with
(``parallel.shard.local_raycast``), and the order its scan casts a
waypoint's rays in (``sim.scan.scan_permutation``).  The tensors' device
picks the kernel or its plain version.

The config's ``raycast_engine.backend`` is in the JAX package's names
(``RAYCAST_BACKENDS``, ``port_backend``).  "auto" is the culled kernel, as
the JAX package's "auto" is its culled "xla" traversal off the TPU
(``ipcgen_tpu/ops/raycast.py:320-323``): on an NVIDIA H100 80GB HBM3 at
700 W the culled kernel is bit-exact against the oracle and was the faster
of the two on each workload of ``python -m ipcgen_tpu_torch.bench``,
pipelined rays per second culled against pairs: the box scan 252.8 M
against 135.2 M, the reconstructed mesh 171.9 M against 87.5 M, BLK2GO x 80
108.8 M against 74.3 M.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ipcgen_tpu_torch.ops.raycast import raycast_asset_brute, raycast_brute_components
from ipcgen_tpu_torch.ops.raycast_culled import (
    raycast_asset_culled,
    raycast_culled_components,
)
from ipcgen_tpu_torch.ops.raycast_pairs import raycast_asset_pairs, raycast_pairs_components


class Backend(NamedTuple):
    """One of the port's raycast backends."""

    # (origins, dirs, asset, t_max, sort_rays) -> RaycastResult; sort_rays
    # is the pair kernel's alone.
    cast_asset: Callable
    # (o, d, tri_data, block_lo, block_hi, super_lo, super_hi, *,
    # super_factor, t_max) -> (t, packed slot local to the components).
    cast_parts: Callable
    # Its scan casts a waypoint's rays in patch order, else in beam order.
    patch_order: bool


BACKENDS = {
    "pairs": Backend(
        lambda o, d, asset, t_max, sort_rays: raycast_asset_pairs(
            o, d, asset, t_max=t_max, sort_rays=sort_rays),
        # No ray sort: a shard keeps its rays' order.
        lambda o, d, tri_data, block_lo, block_hi, *supers, super_factor, t_max:
            raycast_pairs_components(o, d, tri_data, block_lo, block_hi, t_max=t_max,
                                     sort_rays=False),
        True),
    "culled": Backend(
        lambda o, d, asset, t_max, sort_rays: raycast_asset_culled(o, d, asset, t_max=t_max),
        lambda o, d, *parts, super_factor, t_max: raycast_culled_components(
            o, d, *parts, super_factor=super_factor, t_max=t_max),
        False),
    "brute": Backend(
        lambda o, d, asset, t_max, sort_rays: raycast_asset_brute(o, d, asset, t_max=t_max),
        lambda o, d, tri_data, *boxes, super_factor, t_max: raycast_brute_components(
            o, d, tri_data, t_max),
        False),
}

# The JAX package's raycast backend names -> the port's backends.
RAYCAST_BACKENDS = {
    "auto": "culled",
    "mxu": "pairs",
    "pallas": "culled",
    "xla": "culled",
    "xla_brute": "brute",
}


def _unknown(name: str, names) -> ValueError:
    return ValueError(f"unknown raycast backend {name!r}; expected one of "
                      f"{', '.join(map(repr, names))}")


def port_backend(name: str) -> str:
    """The port's backend for a JAX backend name (the config's names); raises
    on any other name, a port name included."""
    try:
        return RAYCAST_BACKENDS[name]
    except KeyError:
        raise _unknown(name, RAYCAST_BACKENDS) from None


def resolve_backend(name: str) -> str:
    """The port's backend for a port name or a JAX name; raises on any
    other."""
    return name if name in BACKENDS else port_backend(name)


def lookup(name: str) -> Backend:
    """The port's backend ``name``; raises on any other name."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise _unknown(name, BACKENDS) from None
