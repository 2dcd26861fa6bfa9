"""The port's label-transfer probe (``ipcgen_tpu_torch/label_transfer_probe.py``)
against ``scripts/label_transfer_probe.py`` and the JAX package's grid 1-NN
on the CPU, at 20 k queries against 5 k references.

Held: the clouds equal the JAX probe's construction bit for bit once cast
to float32, the type the 1-NN searches in; the
instrumented 1-NN equals the port's library call on every row and
``LabelGrid`` returns the library's distances; the 1-NN distances equal
those of the JAX ``nearest_neighbor_indices_grid`` within 1e-5 m (distances,
not indices: the JAX exact residue path resolves fp32 near-ties to within
about 0.5 mm, ROADMAP Queue 3 item 4).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch import label_transfer_probe as ltp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_Q, N_R = 20_000, 5_000


@pytest.fixture(scope="module")
def probe():
    return ltp.run("cpu", n_queries=N_Q, n_refs=N_R, reps=1)


def test_clouds_are_the_jax_probes():
    spec = importlib.util.spec_from_file_location(
        "jax_label_probe", REPO / "scripts" / "label_transfer_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # scripts/label_transfer_probe.py:40-46, restated at N_Q x N_R.
    rng = np.random.default_rng(0)
    refs = mod.surface_cloud(rng, N_R)
    q = mod.surface_cloud(rng, N_Q)
    q += rng.normal(0, 0.004, q.shape).astype(np.float32)
    off = rng.integers(0, N_Q, N_Q // 8)
    q[off] += rng.normal(0, 0.25, (len(off), 3)).astype(np.float32)
    got_q, got_refs = ltp.make_clouds(N_Q, N_R)
    # The JAX probe's clouds are float64; the 1-NN searches them in float32.
    assert q.dtype == refs.dtype == np.float64
    assert got_q.dtype == got_refs.dtype == np.float32
    assert np.array_equal(got_q, q.astype(np.float32))
    assert np.array_equal(got_refs, refs.astype(np.float32))


def test_instrumented_result_equals_the_library_call(probe):
    report, (q, refs, idx) = probe
    assert report["mismatch_rows"] == 0 and report["dist_equal_rows"] == N_Q
    assert report["label_grid_dist_mismatch_rows"] == 0
    assert report["card"] == "cpu" and len(report["passes"]) == 1
    spans = report["passes"][0]["spans"]
    assert {"choose_cell_size", "build_hash_grid", "refs_sort_host", "upload", "core",
            "accept", "idx_d2h", "host_finish"} <= set(spans)
    assert report["passes"][0]["unresolved"] > 0  # the off-surface queries
    lg = report["label_grid"]
    assert lg["build_s"] > 0 and lg["l1_rows"] >= lg["residue_rows"] >= 0
    assert idx.shape == (N_Q,) and idx.dtype == np.int32


def test_distances_equal_the_jax_grid_1nn(probe):
    from ipcgen_tpu.ops.grid_nn import nearest_neighbor_indices_grid

    _, (q, refs, idx) = probe
    want = nearest_neighbor_indices_grid(q, refs)
    d_port = np.linalg.norm(q - refs[idx], axis=1)
    d_jax = np.linalg.norm(q - refs[want], axis=1)
    assert np.abs(d_port - d_jax).max() <= 1e-5
