"""``raycast_roofline.sim``: the share of its roofline that the raycast
kernels reach, in percent: the least time a raycast of the room's rays over
its triangles needs (``benchmark/roofline.py``, independent of the
implementation) times the rooms, over the device time of the raycast
kernels by name in the trace.  Nothing without a device trace or without
raycast kernel time."""

import re

from benchmark.roofline import raycast_floor_s

# The port's raycast kernels (``ipcgen_tpu_torch/csrc``), by function name
# in the trace's signature: the culled Moller-Trumbore walk, and the pair
# path's prepass and walk.
KERNELS = re.compile(r"\b(raycast_culled_kernel|raycast_pairs_kernel|pairs_prepass_kernel"
                     r"|pairs_prepass_fill_kernel)\b")


def read(trace):
    dev = trace.get("device")
    if not dev:
        return None
    busy = sum(s for name, s in dev["kernels"].items()
               if KERNELS.search(name))
    rooms = len(trace.get("rooms", []))
    if busy <= 0 or rooms == 0:
        return None
    floor = raycast_floor_s(trace["scan"]["rays"], trace["scan"]["triangles"])["seconds"]
    return 100.0 * floor * rooms / busy
