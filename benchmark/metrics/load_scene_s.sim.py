"""``load_scene_s.sim``: the mesh's parse and the scene asset's build, the mean over the window's
rooms of the program's own span ``profile["load_scene"]`` (seconds)."""


def read(trace):
    vals = [p["load_scene"] for p in trace.get("rooms", []) if "load_scene" in p]
    return sum(vals) / len(vals) if vals else None
