"""``scan_s.sim``: the fused scan, its dispatch and its execution up to the
barrier, mean over the window's rooms of ``profile["dispatch"] +
profile["scan_exec"]`` (seconds)."""


def read(trace):
    vals = [p["dispatch"] + p["scan_exec"] for p in trace.get("rooms", [])
            if "dispatch" in p and "scan_exec" in p]
    return sum(vals) / len(vals) if vals else None
