"""``recon_s.pipeline``: the reconstruction of the room's variant, its
``reconstruction_time`` in ``reconstruction_report.json``, mean over the
window's rooms (seconds)."""


def read(trace):
    vals = [r["recon_s"] for r in trace.get("pipeline", []) if r.get("recon_s") is not None]
    return sum(vals) / len(vals) if vals else None
