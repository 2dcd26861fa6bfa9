"""The import guard: no module of JAX, or of the JAX package the port was
made from, may be loaded where the benchmark runs.  Names are compared by
their top-level part (before the first dot) as a whole, so the port
``ipcgen_tpu_torch`` passes while ``ipcgen_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ipcgen_tpu"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
