"""``label_transfer_s.sim``: the labels' join and copy in the export, the mean over the window's
rooms of the program's own span ``profile["label_transfer"]`` (seconds)."""


def read(trace):
    vals = [p["label_transfer"] for p in trace.get("rooms", []) if "label_transfer" in p]
    return sum(vals) / len(vals) if vals else None
