"""``preprocess_s.pipeline``: the preprocess stage, the sum of the room
pickle's own ``spans`` (load, outliers and normals, variants, pickle),
mean over the window's rooms (seconds)."""


def read(trace):
    vals = [sum(r["preprocess_spans"].values()) for r in trace.get("pipeline", [])
            if r.get("preprocess_spans")]
    return sum(vals) / len(vals) if vals else None
