"""The preprocess stage of the port against the JAX package on the CPU: the
grid and exact neighbour searches, PCA normals, outlier removal, sparsity
and occlusion, ``preprocess_room`` and its CLI.

The same seeded numpy inputs go through the JAX function and its
counterpart in ``ipcgen_tpu_torch``.  Tolerances, and why:

- grid searches: both take direct differences, so distances agree to 1e-6
  relative; indices agree except where two candidates tie;
- exact k-NN: the port matches a float64 brute force; the JAX package's
  norm expansion |q|^2 - 2 q.r + |r|^2 carries an error of a few float32
  steps of |q|^2 + |r|^2 in d2, and is held to that;
- normals: the same neighbourhoods give the same normal to 1e-5 in |dot|
  where the neighbourhood defines one (its two smallest covariance
  eigenvalues apart); the golden room compares neighbourhoods whose radius
  test the JAX join's error does not flip;
- outlier masks: identical, except points whose mean distance lies within
  1e-5 relative of the threshold;
- sparsity and occlusion: pure numpy with the same seeded generator, bit
  for bit.
"""

import importlib
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import jax  # noqa: E402

jgrid, jknn, jnrm, jout = (importlib.import_module(f"ipcgen_tpu.ops.{m}")
                           for m in ("grid_nn", "knn", "normals", "outliers"))
from ipcgen_tpu.preprocess import loader as jloader  # noqa: E402
from ipcgen_tpu_torch.ops import grid_nn as pgrid  # noqa: E402
from ipcgen_tpu_torch.ops import knn as pknn  # noqa: E402
from ipcgen_tpu_torch.ops import normals as pnrm  # noqa: E402
from ipcgen_tpu_torch.ops import outliers as pout  # noqa: E402
from ipcgen_tpu_torch.preprocess import cli as pcli  # noqa: E402
from ipcgen_tpu_torch.preprocess import loader as ploader  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
CPU = dict(device="cpu")
SPARSITY = [{"name": "dense", "keep_ratio": 1.0, "occlusion": False},
            {"name": "sparse50", "keep_ratio": 0.5, "occlusion": True}]


def shell(rng, n, scale=(4.0, 3.0, 2.5)):
    """Points on the faces of a box (the surface clouds of test_grid_nn)."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32) * np.float32(scale)
    side = rng.integers(0, 6, n)
    for ax in range(3):
        pts[side == 2 * ax, ax] = 0.0
        pts[side == 2 * ax + 1, ax] = scale[ax]
    return pts


def dense_cloud(rng, n=6000, outliers=60):
    """A 1 x 0.8 x 0.6 m box shell dense enough that every 30-NN lies
    within 0.1 m (about 50 points in that radius), 1 mm noise, and
    ``outliers`` far points."""
    pts = shell(rng, n, (1.0, 0.8, 0.6)) + rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    far = rng.uniform(2.0, 3.0, (outliers, 3)).astype(np.float32)
    return np.concatenate([pts, far])


@pytest.fixture
def grid_everywhere(monkeypatch):
    """Both packages take their grid and fused paths on small clouds."""
    for mod in (jout, jnrm, pout, pnrm):
        monkeypatch.setattr(mod, "GRID_MIN_N", 1000)


def pca64(points: np.ndarray, idx: np.ndarray, valid: np.ndarray):
    """Float64 covariance eigen-decomposition of each neighbourhood:
    (eigenvalues (N, 3) ascending, smallest eigenvector (N, 3))."""
    nb = points[idx].astype(np.float64)
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(axis=1), 1.0)  # (N, 1)
    c = (nb - ((nb * w).sum(axis=1) / cnt)[:, None, :]) * w
    cov = np.einsum("nki,nkj->nij", c, c) / cnt[:, :, None]
    vals, vecs = np.linalg.eigh(cov)
    return vals, vecs[:, :, 0]


def well_defined(vals: np.ndarray) -> np.ndarray:
    """A normal is defined where the two smallest eigenvalues are apart."""
    return (vals[:, 1] - vals[:, 0]) > 0.05 * np.maximum(vals[:, 2], 1e-30)


def absdot(a, b):
    return np.abs(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64), axis=1))


# ---------------------------------------------------------------------------
# Grid searches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,cell", [(20000, 0.1), (5000, 0.037), (40, 1.0)])
def test_build_hash_grid_bit_equal(n, cell):
    refs = shell(np.random.default_rng(n), n)
    want = jgrid._build_hash_grid(refs, cell)
    got = pgrid._build_hash_grid(refs, cell)
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == np.asarray(g).dtype
        np.testing.assert_array_equal(g, w)
    assert pgrid._MAX_TABLE == jgrid._MAX_TABLE
    assert all(pgrid._bucket_len(m) == jgrid._bucket_len(m) for m in range(0, 5000, 37))


def assert_knn_matches(gi, gd, wi, wd):
    """Distances to 1e-6 relative (inf where the JAX package has inf);
    indices equal except among near-equal distances."""
    assert gi.shape == wi.shape and gd.shape == wd.shape
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=1e-9)
    differ = (gi != wi) & fin
    if differ.any():
        # A differing index must be a tie: the port's pick lies at the
        # JAX pick's distance.
        rows, cols = np.nonzero(differ)
        assert np.allclose(gd[rows, cols], wd[rows, cols], rtol=1e-6)


@pytest.mark.parametrize("duplicates", [False, True])
def test_knn_grid_matches_jax(duplicates):
    rng = np.random.default_rng(1)
    refs = shell(rng, 20000)
    if duplicates:  # S3DIS rooms hold repeated points: exact distance ties
        refs[1::7] = refs[0:-1:7][: len(refs[1::7])]
    queries = np.concatenate([shell(rng, 2000) + rng.normal(0, 0.004, (2000, 3)).astype(
        np.float32), refs[:500]])
    wi, wd = jgrid.knn_grid(queries, refs, k=10)
    gi, gd = pgrid.knn_grid(queries, refs, k=10, **CPU)
    assert_knn_matches(gi, gd, wi, wd)
    if duplicates:  # ties resolve to the first candidate position, as top_k
        assert (gi == wi).mean() > 0.999


def test_knn_grid_padding_changes_nothing():
    """The JAX package pads queries to bucketed lengths (rows at lo - 10
    cells) only to share compiled programs; the port searches the rows it is
    given.  Padded rows sliced off leave every result as it was."""
    rng = np.random.default_rng(2)
    refs = shell(rng, 8000)
    queries = shell(rng, 3001)
    cell = pgrid._choose_cell_size(refs, 48)
    n_pad = pgrid._bucket_len(-(-len(queries) // 4096)) * 4096
    pad = np.full((n_pad - len(queries), 3), refs.min(axis=0) - 10 * cell, np.float32)
    padded = np.concatenate([queries, pad])
    gi, gd = pgrid.knn_grid(queries, refs, k=6, **CPU)
    pi, pd = pgrid.knn_grid(padded, refs, k=6, **CPU)
    np.testing.assert_array_equal(pi[:len(queries)], gi)
    np.testing.assert_array_equal(pd[:len(queries)], gd)
    assert not np.isfinite(pd[len(queries):]).any()


def test_knn_grid_device_arrays():
    rng = np.random.default_rng(3)
    pts = shell(rng, 6000)
    idx_d, d2_d = pgrid.knn_grid(pts, pts, k=4, device_arrays=True, **CPU)
    assert isinstance(idx_d, torch.Tensor) and isinstance(d2_d, torch.Tensor)
    idx_h, d_h = pgrid.knn_grid(pts, pts, k=4, **CPU)
    np.testing.assert_array_equal(idx_d.numpy(), idx_h)
    fin = np.isfinite(d_h)
    np.testing.assert_allclose(np.sqrt(d2_d.numpy()[fin]), d_h[fin], rtol=1e-6)
    wi, wd2 = jgrid.knn_grid(pts, pts, k=4, device_arrays=True)
    np.testing.assert_allclose(d2_d.numpy(), np.asarray(wd2), rtol=1e-6, atol=1e-12)


def norm_expansion_bound(q, refs):
    """What the JAX package's exact join (|q|^2 - 2 q.r + |r|^2 in float32)
    may err by in d2: a few float32 steps of |q|^2 + |r|^2."""
    scale = (q.astype(np.float64) ** 2).sum(-1) + (refs.astype(np.float64) ** 2).sum(-1).max()
    return 8 * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("case", ["surface", "far", "retry"])
def test_nearest_neighbor_indices_grid_matches_jax(case):
    """Exact by construction: the port's answer is the float64 nearest
    neighbour (to float32 rounding), the JAX package's too where its grid
    resolves a query; its exact fallback carries the norm expansion's
    error.  "far" takes the fallback; "retry" leaves over 65,536 queries
    unresolved at h/2, so the doubled-cell retry runs."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(4)
    refs = shell(rng, 20000)
    if case == "surface":
        q = shell(rng, 3000) + rng.normal(0, 0.004, (3000, 3)).astype(np.float32)
    elif case == "far":
        q = rng.uniform(50, 60, (20, 3)).astype(np.float32)
    else:
        q = shell(rng, 70000) + rng.normal(0, 0.05, (70000, 3)).astype(np.float32)
    want = jgrid.nearest_neighbor_indices_grid(q, refs)
    got = pgrid.nearest_neighbor_indices_grid(q, refs, **CPU)
    assert got.dtype == np.int32 and got.shape == (len(q),)
    d_true, _ = cKDTree(refs.astype(np.float64)).query(q.astype(np.float64))
    d_w = np.linalg.norm(q.astype(np.float64) - refs[want], axis=1)
    d_g = np.linalg.norm(q.astype(np.float64) - refs[got], axis=1)
    np.testing.assert_allclose(d_g, d_true, rtol=1e-6, atol=1e-9)
    assert np.all(d_w ** 2 - d_true ** 2 <= norm_expansion_bound(q, refs))
    assert (got == want).mean() > 0.999


# ---------------------------------------------------------------------------
# Exact k-NN and the budget dispatch
# ---------------------------------------------------------------------------
def test_knn_exact_against_float64_and_jax():
    rng = np.random.default_rng(5)
    refs = shell(rng, 4000)
    refs[1::9] = refs[0:-1:9][: len(refs[1::9])]  # exact ties
    q = np.concatenate([shell(rng, 600) + rng.normal(0, 0.01, (600, 3)).astype(np.float32),
                        refs[:50]])
    k = 8
    gi, gd = pknn.knn(q, refs, k=k, **CPU)
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    d64 = np.sqrt(((q[:, None, :].astype(np.float64) - refs[None].astype(np.float64)) ** 2
                   ).sum(-1))
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(d64, order, axis=1)
    np.testing.assert_allclose(gd, want_d, rtol=0, atol=1e-6)
    # Indices equal outside float64 ties (a tie keeps the smaller index).
    tie = np.abs(np.take_along_axis(d64, gi.astype(np.int64), axis=1) - want_d) <= 0
    assert np.all((gi == order) | tie)
    assert (gi == order).mean() > 0.999
    # The JAX join's norm expansion errs by a few float32 steps of |q|^2 + |r|^2.
    wi, wd = jknn.knn(q, refs, k=k)
    assert np.all(np.abs(wd.astype(np.float64) ** 2 - gd.astype(np.float64) ** 2)
                  <= norm_expansion_bound(q, refs)[:, None])


def test_knn_pads_k_above_the_reference_count():
    refs = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0]], np.float32)
    q = np.array([[0.1, 0, 0]], np.float32)
    gi, gd = pknn.knn(q, refs, k=5, **CPU)
    wi, wd = jknn.knn(q, refs, k=5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-6)


def test_exact_pair_budget_and_auto(monkeypatch):
    assert pknn.exact_pair_budget(**CPU) == 2e8
    assert pknn.exact_pair_budget(device="cuda") == 1e10
    assert pknn.exact_pair_budget() == 1e10  # None: the card
    rng = np.random.default_rng(6)
    refs = shell(rng, 5000)
    q = shell(rng, 800) + rng.normal(0, 0.003, (800, 3)).astype(np.float32)
    exact = pknn.nearest_neighbor_auto(q, refs, **CPU)
    monkeypatch.setattr(pknn, "exact_pair_budget", lambda *, device=None: 0.0)
    grid = pknn.nearest_neighbor_auto(q, refs, **CPU)
    d = [np.linalg.norm(q.astype(np.float64) - refs[i], axis=1) for i in (exact, grid)]
    np.testing.assert_allclose(d[1], d[0], rtol=1e-6)
    want = jknn.nearest_neighbor_auto(q, refs)
    np.testing.assert_allclose(np.linalg.norm(q.astype(np.float64) - refs[want], axis=1),
                               d[0], atol=1e-4)


def test_select_smallest_breaks_ties_on_position():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 0.0, float("inf"), 1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, pos = pknn.select_smallest(d2, 4)
    assert pos.tolist() == [[3, 1, 2, 5], [0, 1, 2, 3]]
    assert vals.tolist() == [[0.0, 1.0, 1.0, 1.0], [2.0] * 4]


# ---------------------------------------------------------------------------
# Normals
# ---------------------------------------------------------------------------
def planar_neighbourhoods(rng, n=3000, k=30):
    """(neighbours (n, k, 3), valid (n, k)): noisy patches of random planes
    with 10 to k valid members each."""
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    u = np.cross(normal, rng.normal(size=(n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(normal, u)
    ab = rng.uniform(-0.05, 0.05, (n, k, 2))
    pts = rng.uniform(-5, 5, (n, 1, 3)) + ab[..., :1] * u[:, None] + ab[..., 1:] * v[:, None] \
        + rng.normal(0, 1e-3, (n, k, 1)) * normal[:, None]
    valid = np.arange(k)[None, :] < rng.integers(10, k + 1, (n, 1))
    return pts.astype(np.float32), valid


def test_pca_normals_match_jax():
    rng = np.random.default_rng(7)
    nb, valid = planar_neighbourhoods(rng)
    want = np.asarray(jnrm._pca_normals(jax.numpy.asarray(nb), jax.numpy.asarray(valid)))
    got = pnrm._pca_normals(torch.from_numpy(nb), torch.from_numpy(valid)).numpy()
    assert got.dtype == np.float32
    assert absdot(got, want).min() >= 1 - 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    idx = np.arange(nb.shape[0] * nb.shape[1]).reshape(nb.shape[:2])
    vals, ref = pca64(nb.reshape(-1, 3), idx, valid)
    assert absdot(got, ref)[well_defined(vals)].min() >= 1 - 1e-5


def test_smallest_eigenvector_isotropic_and_diagonal():
    cov = torch.stack([torch.eye(3), torch.diag(torch.tensor([3.0, 1.0, 2.0])),
                       torch.zeros(3, 3)])
    got = pnrm._smallest_eigenvector_3x3(cov).numpy()
    want = np.asarray(jnrm._smallest_eigenvector_3x3(jax.numpy.asarray(cov.numpy())))
    np.testing.assert_allclose(got[0], [0, 0, 1])
    np.testing.assert_allclose(got[2], [0, 0, 1])
    np.testing.assert_allclose(np.abs(got[1]), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-6)


@pytest.mark.parametrize("grid", [False, True])
def test_estimate_normals_matches_jax(grid, monkeypatch):
    if grid:
        monkeypatch.setattr(jnrm, "GRID_MIN_N", 1000)
        monkeypatch.setattr(pnrm, "GRID_MIN_N", 1000)
    rng = np.random.default_rng(8)
    pts = dense_cloud(rng, outliers=0)
    view = np.array([0.5, 0.4, 0.3])
    want = jnrm.estimate_normals(pts, radius=0.1, max_nn=30, orient_towards=view)
    got = pnrm.estimate_normals(pts, radius=0.1, max_nn=30, orient_towards=view, **CPU)
    idx, d = pknn.knn(pts, pts, k=30, **CPU)
    vals, _ = pca64(pts, idx, d <= 0.1)
    ok = well_defined(vals)
    assert ok.mean() > 0.9
    dot = np.sum(got.astype(np.float64) * want, axis=1)
    assert dot[ok].min() >= 1 - 1e-5  # oriented alike, not only parallel


# ---------------------------------------------------------------------------
# Outlier removal
# ---------------------------------------------------------------------------
def assert_masks_match(got, want, means, std_ratio=2.0):
    fin = np.isfinite(means)
    thr = float(means[fin].mean() + std_ratio * means[fin].std())
    differ = got != want
    near = np.abs(means - thr) <= 1e-5 * thr
    assert np.all(near[differ]), np.flatnonzero(differ & ~near)


@pytest.mark.parametrize("path", ["exact", "grid"])
def test_remove_statistical_outliers_matches_jax(path, request):
    if path == "grid":
        request.getfixturevalue("grid_everywhere")
    rng = np.random.default_rng(9)
    pts = dense_cloud(rng)
    want_m, want_d = jout.remove_statistical_outliers(pts, nb_neighbors=20, std_ratio=2.0)
    got_m, got_d = pout.remove_statistical_outliers(pts, nb_neighbors=20, std_ratio=2.0,
                                                    **CPU)
    assert got_m.dtype == bool and got_d.dtype == np.float32
    assert not got_m[-60:].any() and got_m[:-60].mean() > 0.9
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    rtol = 1e-6 if path == "grid" else 1e-3  # the JAX exact join's norm expansion
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=rtol)
    assert_masks_match(got_m, want_m, got_d)


def test_fused_outliers_and_normals_match_jax(grid_everywhere):
    rng = np.random.default_rng(10)
    pts = dense_cloud(rng)
    want_m, want_n = jout.remove_outliers_and_estimate_normals(pts)
    got_m, got_n = pout.remove_outliers_and_estimate_normals(pts, **CPU)
    sep_m, means = pout.remove_statistical_outliers(pts, **CPU)
    np.testing.assert_array_equal(got_m, sep_m)  # one join, the same mask
    assert_masks_match(got_m, want_m, means)
    assert got_n.shape == (int(got_m.sum()), 3) and got_n.dtype == np.float32
    if np.array_equal(got_m, want_m):
        idx, d = pknn.knn(pts[got_m], pts[got_m], k=30, **CPU)
        vals, _ = pca64(pts[got_m], idx, d <= 0.1)
        ok = well_defined(vals)
        assert ok.mean() > 0.9 and absdot(got_n, want_n)[ok].min() >= 1 - 1e-5


def test_small_input_outliers():
    pts = np.zeros((5, 3), np.float32)
    mask, means = pout.remove_statistical_outliers(pts, **CPU)
    assert mask.all() and not means.any()


# ---------------------------------------------------------------------------
# Preprocessor, preprocess_room, CLI
# ---------------------------------------------------------------------------
def test_sparsity_and_occlusion_bit_equal():
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1, (5000, 3)) * [6, 5, 3]
    colors = rng.uniform(size=(5000, 3))
    labels = rng.integers(0, 13, 5000)
    want = jloader.S3DISPreprocessor({}, seed=3)
    got = ploader.S3DISPreprocessor({}, seed=3, **CPU)
    assert got.config == want.config == ploader.DEFAULT_PREPROCESSING
    for cfg in SPARSITY + [{"name": "occ", "keep_ratio": 1.0, "occlusion": True}, None]:
        for a, b in zip(want.simulate_robot_sparsity(pts, colors, labels, cfg),
                        got.simulate_robot_sparsity(pts, colors, labels, cfg)):
            np.testing.assert_array_equal(b, a)
    for a, b in zip(want._simulate_occlusion(pts, colors), got._simulate_occlusion(pts, colors)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(b, a)


def test_loader_reads_labels(tmp_path):
    rng = np.random.default_rng(12)
    room = tmp_path / "Area_1" / "office_1"
    room.mkdir(parents=True)
    data = np.hstack([rng.uniform(0, 1, (300, 3)), rng.integers(0, 256, (300, 3)),
                      rng.integers(0, 13, (300, 1))])
    np.savetxt(room / "office_1.txt", data)
    want = jloader.S3DISLoader(str(tmp_path)).load_room_data("Area_1", "office_1")
    got = ploader.S3DISLoader(str(tmp_path)).load_room_data("Area_1", "office_1")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert ploader.S3DISLoader(str(tmp_path)).get_available_rooms("Area_1") == ["office_1"]


@pytest.fixture(scope="module")
def golden_rooms(tmp_path_factory):
    out = tmp_path_factory.mktemp("pre")
    kw = dict(sparsity_experiments=SPARSITY, seed=0)
    want = jloader.preprocess_room(str(GOLDEN), "Area_1", "office_1", {},
                                   output_dir=str(out / "jax"), **kw)
    got = ploader.preprocess_room(str(GOLDEN), "Area_1", "office_1", {},
                                  output_dir=str(out / "port"), **kw, **CPU)
    return want, got


def test_preprocess_room_golden_points_bit_equal(golden_rooms):
    want, got = golden_rooms
    for key in ("points", "colors"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["labels"] is None and want["labels"] is None  # x y z r g b rows
    for name in ("dense", "sparse50"):
        for key in ("points", "colors"):
            np.testing.assert_array_equal(got["variants"][name][key],
                                          want["variants"][name][key])
        assert got["variants"][name]["config"] == want["variants"][name]["config"]
    assert len(got["variants"]["sparse50"]["points"]) < len(got["points"])


def test_preprocess_room_golden_normals(golden_rooms):
    """Normals agree to 0.9999 in |dot| where the neighbourhood defines
    one and the JAX join's radius test picked the same neighbours; the
    port matches a float64 PCA of its neighbourhoods everywhere they
    define one."""
    want, got = golden_rooms
    for name in ("dense", "sparse50"):
        pts = got["variants"][name]["points"].astype(np.float32)
        gi, gd = pknn.knn(pts, pts, k=30, **CPU)
        wi, wd = jknn.knn(pts, pts, k=30)
        same = np.array([set(a[x]) == set(b[y]) for a, x, b, y in
                         zip(gi, gd <= 0.1, wi, wd <= 0.1)])
        vals, ref = pca64(pts, gi, gd <= 0.1)
        ok = well_defined(vals)
        g, w = got["variants"][name]["normals"], want["variants"][name]["normals"]
        assert g.shape == w.shape == pts.shape
        assert absdot(g, ref)[ok].min() >= 0.9999
        assert absdot(g, w)[ok & same].min() >= 0.9999
        # The sparse variant keeps 3.5 k of the 20 k points: a median of 4
        # neighbours within 0.1 m, and many collinear or single ones.
        assert (ok & same).mean() > {"dense": 0.97, "sparse50": 0.5}[name]


def test_preprocess_room_pickle_schema(golden_rooms):
    want, got = golden_rooms
    assert sorted(got) == sorted(want)
    assert sorted(got["spans"]) == sorted(want["spans"]) == \
        ["load", "outliers_normals", "pickle", "variants"]
    loaded = ploader.load_preprocessed_data(got["output_path"])
    with open(want["output_path"], "rb") as f:
        ref = pickle.load(f)
    assert sorted(loaded) == sorted(ref)
    assert sorted(loaded["variants"]["dense"]) == sorted(ref["variants"]["dense"])
    np.testing.assert_array_equal(loaded["points"], got["points"])


def test_cli_main_on_a_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    rng = np.random.default_rng(13)
    room = tmp_path / "data" / "Area_1" / "office_1"
    room.mkdir(parents=True)
    pts = dense_cloud(rng, n=3000, outliers=20)
    np.savetxt(room / "office_1.txt",
               np.hstack([pts, rng.integers(0, 256, (len(pts), 3))]), fmt="%.5f")
    config = {"data": {"data_root": str(tmp_path / "data"), "area_name": "Area_1",
                       "output_root": str(tmp_path / "outputs")},
              "preprocessing": {"normal_max_nn": 20},
              "sparsity_experiments": SPARSITY}
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(config))
    results = pcli.main(["--config", str(cfg), "--sparsity", "dense"], **CPU)
    pkl = tmp_path / "outputs" / "preprocessed" / "Area_1_office_1_preprocessed.pkl"
    assert results == {"office_1": str(pkl)}
    data = ploader.load_preprocessed_data(str(pkl))
    assert list(data["variants"]) == ["dense"]
    assert data["normals"].shape == data["points"].shape
    assert len(pts) - 20 <= len(data["points"]) < len(pts)
