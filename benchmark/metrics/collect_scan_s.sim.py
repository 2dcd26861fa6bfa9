"""``collect_scan_s.sim``: the sim facade's ``collect_scan`` whole (the
scan's barrier, the copy to the host, the label hand-off, the frames and
the statistics), mean over the window's rooms of the program's span
``profile["collect_scan"]`` (seconds)."""


def read(trace):
    vals = [p["collect_scan"] for p in trace.get("rooms", []) if "collect_scan" in p]
    return sum(vals) / len(vals) if vals else None
