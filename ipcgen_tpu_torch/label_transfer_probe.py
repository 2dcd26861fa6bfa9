"""Sub-cost attribution of the label-transfer 1-NN on the card (port of
``scripts/label_transfer_probe.py``).

    python -m ipcgen_tpu_torch.label_transfer_probe [--out PATH]

2.56 M queries (a box-shell surface plus 4 mm noise, one in eight moved off
the surface by 0.25 m) against 630 k references, from ``default_rng(0)``:
the sim stage's shape.  Times, with a barrier on the device at each end,
every piece of ``ops.grid_nn.nearest_neighbor_indices_grid`` on its own
(the cell-size search, the host grid build with its sort, the reference
gather, the upload, the core, the accept mask, the index copy to the host,
the host finish, then the retry ladder or the exact 1-NN of what is left),
twice after one warm call of the whole function, and checks that the
instrumented result equals the function's (0 rows differ).

The sim stage transfers labels through ``LabelGrid``, not through that
function, so the same shapes also go through it: its build, each level of
``query`` and the residue rows that the exact 1-NN takes.  Prints one JSON
object with the card's name and power limit beside it (and writes it to
``--out``).  ``run(device="cpu", n_queries=..., n_refs=...)`` runs it on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

N_QUERIES = 2_560_000
N_REFS = 630_000


def surface_cloud(rng, n, w=6.0, h=5.0, z=2.7):
    """Box-shell surface cloud approximating a TLS room scan."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32) * [w, h, z]
    face = rng.integers(0, 6, n)
    for ax, ext in enumerate((w, h, z)):
        pts[face == 2 * ax, ax] = 0.0
        pts[face == 2 * ax + 1, ax] = ext
    return pts


def make_clouds(n_queries: int = N_QUERIES, n_refs: int = N_REFS, seed: int = 0):
    """(queries, refs), float32: scan hits are the reference surface plus
    small noise, some off the surface.  ``surface_cloud`` gives float64 (a
    float32 array times a list), as in the JAX probe; the 1-NN casts its
    inputs to float32, so they are cast once here and every timed piece
    sees what the library call sees."""
    rng = np.random.default_rng(seed)
    refs = surface_cloud(rng, n_refs)
    q = surface_cloud(rng, n_queries)
    q += rng.normal(0, 0.004, q.shape).astype(np.float32)
    off = rng.integers(0, n_queries, n_queries // 8)
    q[off] += rng.normal(0, 0.25, (len(off), 3)).astype(np.float32)
    return q.astype(np.float32), refs.astype(np.float32)


def instrumented_nn(q_dev: torch.Tensor, refs: np.ndarray, spans: dict,
                    cap: int = 48, q_block: int = 8192):
    """``nearest_neighbor_indices_grid(q_dev, refs)`` piece by piece, each
    piece's seconds added to ``spans``; returns (indices, rows the first
    grid pass left unresolved)."""
    from ipcgen_tpu_torch.ops import grid_nn as g
    from ipcgen_tpu_torch.ops.knn import nearest_neighbor_indices
    from ipcgen_tpu_torch.utils.device import sync

    device = q_dev.device

    @contextlib.contextmanager
    def span(name):
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0

    m = len(refs)
    with span("choose_cell_size"):
        h = g._choose_cell_size(refs, cap)
    with span("build_hash_grid"):
        order, starts, lo, dims, inv_h = g._build_hash_grid(refs, h)
    with span("refs_sort_host"):
        refs_sorted = refs[order]
    with span("upload"):
        grid = (
            torch.from_numpy(refs_sorted).to(device),
            torch.from_numpy(starts).to(device),
            torch.from_numpy(np.asarray(lo, np.float32)).to(device),
            torch.tensor(np.float32(inv_h), device=device),
            torch.from_numpy(dims.astype(np.int32)).to(device),
        )
    with span("core"):
        slot, d2, ovf = g._grid_nn_core(q_dev, *grid, int(cap), int(q_block))
    with span("accept"):
        r2 = torch.tensor(np.float32((0.5 * h) ** 2), device=device)
        enc_dev = torch.where((d2 <= r2) & ~ovf, slot, torch.full_like(slot, -1))
    with span("idx_d2h"):
        enc = enc_dev.cpu().numpy()
    with span("host_finish"):
        resolved = enc >= 0
        result = order[np.clip(enc, 0, m - 1)].astype(np.int32)
    un = np.flatnonzero(~resolved)
    with span("unresolved_gather"):
        q_un = q_dev[torch.from_numpy(un).to(device)] if len(un) else None
    with span("retry_ladder" if len(un) > 65536 else "exact_fallback"):
        if len(un) > 65536:
            result[un] = g.nearest_neighbor_indices_grid(
                q_un, refs, cell_size=2.0 * h, cap=min(2 * cap, 256), q_block=q_block,
                _depth=1, device=device)
        elif len(un):
            result[un] = nearest_neighbor_indices(q_un, refs, device=device)
    return result, len(un)


def label_grid_pieces(q_dev: torch.Tensor, refs: np.ndarray) -> tuple:
    """``LabelGrid``: its build (host slabs and upload) and one query, with
    the seconds of each level and the rows each level leaves; (figures,
    indices)."""
    from ipcgen_tpu_torch.ops.grid_nn import LabelGrid
    from ipcgen_tpu_torch.utils.device import sync
    from ipcgen_tpu_torch.utils.profiling import Recorder

    device = q_dev.device
    sync(device)
    t0 = time.perf_counter()
    grid = LabelGrid(refs, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    rec = Recorder()
    t0 = time.perf_counter()
    idx = grid.query(q_dev, rec=rec)
    query_s = time.perf_counter() - t0
    prof = rec.profile
    return {"build_s": build_s, "query_s": query_s, "l0_s": prof["label_nn_l0"],
            "l1_rows": int(prof["label_nn_l1_rows"]), "l1_s": prof.get("label_nn_l1", 0.0),
            "residue_rows": int(prof["label_nn_residue_rows"]),
            "residue_s": prof["label_nn_residue"], "h0": grid.h0}, idx


def run(device=None, *, n_queries: int = N_QUERIES, n_refs: int = N_REFS,
        reps: int = 2):
    """The probe on ``device`` (None: the card): (report, (queries, refs,
    the instrumented indices of the last pass))."""
    from ipcgen_tpu_torch.ops.grid_nn import nearest_neighbor_indices_grid
    from ipcgen_tpu_torch.utils.device import card_line, device_or_card, sync

    device = device_or_card(device)
    q, refs = make_clouds(n_queries, n_refs)
    q_dev = torch.from_numpy(q).to(device)
    sync(device)
    t0 = time.perf_counter()
    lib = nearest_neighbor_indices_grid(q_dev, refs, device=device)
    library_s = time.perf_counter() - t0
    passes = []
    for _ in range(reps):
        spans = {}
        result, n_un = instrumented_nn(q_dev, refs, spans)
        passes.append({"total_s": sum(spans.values()), "unresolved": n_un,
                       "unresolved_frac": n_un / n_queries, "spans": spans})
    d_lib = np.linalg.norm(q - refs[lib], axis=1)
    d_ins = np.linalg.norm(q - refs[result], axis=1)
    lg, lg_idx = label_grid_pieces(q_dev, refs)
    d_lg = np.linalg.norm(q - refs[lg_idx], axis=1)
    report = {
        "card": card_line() if device.type == "cuda" else "cpu",
        "queries": n_queries, "refs": n_refs,
        "library_call_s": library_s,
        "passes": passes,
        "mismatch_rows": int((result != lib).sum()),
        "dist_equal_rows": int((np.abs(d_lib - d_ins) < 1e-5).sum()),
        "label_grid": lg,
        "label_grid_dist_mismatch_rows": int((np.abs(d_lg - d_lib) >= 1e-5).sum()),
    }
    return report, (q, refs, result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("label_transfer_probe needs a CUDA device")
    report, _ = run()
    text = json.dumps(report)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
