"""``label_prefetch_offcpu_s.sim``: the time the label prefetch thread was
not running within its span (waiting for the interpreter lock, the disk or
a blocking copy), mean over the window's rooms of
``profile["label_load_bg"] - profile["label_load_bg_cpu"]`` (seconds)."""


def read(trace):
    vals = [p["label_load_bg"] - p["label_load_bg_cpu"] for p in trace.get("rooms", [])
            if "label_load_bg" in p and "label_load_bg_cpu" in p]
    return sum(vals) / len(vals) if vals else None
