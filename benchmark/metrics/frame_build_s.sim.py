"""``frame_build_s.sim``: the frames' build on the host after the scan, the mean over the window's
rooms of the program's own span ``profile["frame_build"]`` (seconds)."""


def read(trace):
    vals = [p["frame_build"] for p in trace.get("rooms", []) if "frame_build" in p]
    return sum(vals) / len(vals) if vals else None
