"""Label transfer: the port's ``LabelGrid`` and exact 1-NN against the JAX
package's, on the golden room cloud (tests/fixtures/golden_room).

Both grids are exact nearest-neighbour searches, so the indices must be
IDENTICAL except where the two candidates are equally near: a query whose
two nearest references lie within 1e-9 m^2 of each other may resolve to
either (the float32 distance sums round in a different order).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops.grid_nn import LabelGrid as JaxLabelGrid  # noqa: E402
from ipcgen_tpu.semantic.annotations import S3DISAnnotationLoader  # noqa: E402
from ipcgen_tpu_torch.containers.sim_scene import load_room_label_data  # noqa: E402
from ipcgen_tpu_torch.ops.grid_nn import LabelGrid  # noqa: E402
from ipcgen_tpu_torch.ops.knn import nearest_neighbor_indices  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
TIE_M2 = 1e-9


@pytest.fixture(scope="module")
def golden_cloud():
    loader = S3DISAnnotationLoader(str(GOLDEN), verbose=False)
    pts, _, _ = loader.create_labeled_pointcloud_with_instances(
        loader.load_room_annotations("Area_1", "office_1"))
    return np.asarray(pts, np.float32)


def queries_for(refs, seed=0):
    """Surface queries (refs + 5 mm noise), off-surface queries up to 0.4 m
    away (level 1), and far queries outside the room (the exact residue)."""
    rng = np.random.default_rng(seed)
    near = refs[rng.choice(len(refs), 6000)] + rng.normal(0, 0.005, (6000, 3))
    off = refs[rng.choice(len(refs), 1500)] + rng.normal(0, 0.2, (1500, 3))
    far = rng.uniform([-3, -3, -2], [7, 6, 5], (500, 3))
    return np.concatenate([near, off, far]).astype(np.float32)


def assert_same_up_to_ties(q, refs, got, want):
    diff = np.flatnonzero(got != want)
    if len(diff):
        q64, r64 = q[diff].astype(np.float64), refs.astype(np.float64)
        d_got = ((q64 - r64[got[diff]]) ** 2).sum(1)
        d_want = ((q64 - r64[want[diff]]) ** 2).sum(1)
        assert np.all(np.abs(d_got - d_want) <= TIE_M2), np.abs(d_got - d_want).max()
    return len(diff)


def test_label_grid_matches_jax(golden_cloud):
    refs = golden_cloud
    q = queries_for(refs)
    want = JaxLabelGrid(refs).query(q)
    grid = LabelGrid(refs, device="cpu")
    got = grid.query(torch.from_numpy(q))
    assert got.dtype == np.int32 and got.shape == want.shape
    n_diff = assert_same_up_to_ties(q, refs, got, want)
    assert n_diff <= 0.001 * len(q)
    # All three levels ran.
    assert grid.profile["l1_rows"] > 0 and grid.profile["residue_rows"] > 0


def test_label_grid_is_exact(golden_cloud):
    """Against a float64 brute force: the true nearest, up to ties."""
    refs = golden_cloud
    q = queries_for(refs, seed=1)[::4]
    got = LabelGrid(refs, device="cpu").query(q)
    d = ((q[:, None, :].astype(np.float64) - refs[None].astype(np.float64)) ** 2).sum(-1)
    assert_same_up_to_ties(q, refs, got, d.argmin(1))


def test_exact_nn_matches_brute_force(golden_cloud):
    refs = golden_cloud[::3]
    q = queries_for(refs, seed=2)[::8]
    got = nearest_neighbor_indices(q, refs, q_block=128, max_elems=1 << 16)
    d = ((q[:, None, :].astype(np.float64) - refs[None].astype(np.float64)) ** 2).sum(-1)
    assert_same_up_to_ties(q, refs, got, d.argmin(1))


def test_room_label_data_matches_jax():
    from ipcgen_tpu.containers.sim_scene import load_room_label_data as jax_load

    want = jax_load(str(GOLDEN), "Area_1", "office_1")
    got = load_room_label_data(str(GOLDEN), "Area_1", "office_1", device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_room_label_data_missing_room_raises(tmp_path, capsys):
    """A room with no ``Annotations/`` directory has no annotation data: four
    Nones (default labels) and a warning, as the JAX package gives.  An
    annotation file that exists but cannot be read still raises: the port's
    loader does not turn a broken file into defaults."""
    from ipcgen_tpu.containers.sim_scene import load_room_label_data as jax_load

    got = load_room_label_data(str(GOLDEN), "Area_1", "no_such_room")
    assert got == (None,) * 4 == jax_load(str(GOLDEN), "Area_1", "no_such_room")
    assert "warning" in capsys.readouterr().out
    room = tmp_path / "Area_1" / "office_1"
    shutil.copytree(GOLDEN / "Area_1" / "office_1", room)
    (room / "Annotations" / "chair_1.txt").write_bytes(bytes(range(128, 256)) * 16)
    with pytest.raises(UnicodeDecodeError):
        load_room_label_data(str(tmp_path), "Area_1", "office_1", device="cpu")
