"""The recon stage of the port against the JAX package on the CPU: the SDF
splat, marching tetrahedra, welding, the IMLS refinement, surface sampling,
``SurfaceReconstructor`` and its facades, ``reconstruct_room`` and the CLI.

The same seeded numpy inputs go through the JAX function and its
counterpart in ``ipcgen_tpu_torch``.  Tolerances, and why:

- the splat: both sum float32 contributions in another order (and the
  exponentials differ by an ulp), so weights agree to 1e-5 relative and the
  SDF to 1e-6 m where the weight exceeds 1e-3;
- the marching on the *same* grid: the same float32 arithmetic, so the
  active cubes are equal and the soups within 1e-6 m;
- welding: host numpy on the same soup, bit for bit;
- the IMLS projection: both packages on the same k-NN branch (exact or
  grid), 99.5 % of the vertices within 1e-4 m and all within a tenth of the
  radius (the JAX exact join's norm expansion can swap the k-th neighbour
  of a near-tie);
- sampling: ``jax.random`` cannot be reproduced in torch, so the JAX draws
  are fed to the port's ``_sample`` (points within 1e-6 m), and the port's
  own draws are held to their distribution;
- whole meshes: a vertex whose SDF lies within an ulp of 0 can flip a cube,
  so meshes are compared by distance (symmetric vertex Hausdorff <= 0.1
  voxel), face counts within 0.5 %, and orientation and colours as an
  agreement share (the JAX exact 1-NN resolves near-ties either way).
"""

import importlib
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import jax  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from ipcgen_tpu.containers import TriMesh as JaxMesh  # noqa: E402
jknn, jmarch, jsamp, jsdf = (importlib.import_module(f"ipcgen_tpu.ops.{m}")
                             for m in ("knn", "marching", "sampling", "sdf"))
from ipcgen_tpu.recon import cli as jcli  # noqa: E402
from ipcgen_tpu.recon import reconstructor as jrec  # noqa: E402
from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.ops import knn as pknn  # noqa: E402
from ipcgen_tpu_torch.ops import marching as pmarch  # noqa: E402
from ipcgen_tpu_torch.ops import sampling as psamp  # noqa: E402
from ipcgen_tpu_torch.ops import sdf as psdf  # noqa: E402
from ipcgen_tpu_torch.ops.normals import estimate_normals  # noqa: E402
from ipcgen_tpu_torch.preprocess.loader import S3DISLoader  # noqa: E402
from ipcgen_tpu_torch.recon import cli as pcli  # noqa: E402
from ipcgen_tpu_torch.recon import reconstructor as prec  # noqa: E402
from ipcgen_tpu_torch.recon.projection_viz import ReconstructionVisualizer  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
CPU = dict(device="cpu")
VOXEL = 0.08


def shell(rng, n, scale):
    """Points on the faces of a box."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32) * np.float32(scale)
    side = rng.integers(0, 6, n)
    for ax in range(3):
        pts[side == 2 * ax, ax] = 0.0
        pts[side == 2 * ax + 1, ax] = scale[ax]
    return pts


def sphere(n=5000, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)  # points, outward normals


@pytest.fixture(scope="module")
def grids():
    pts, nrm = sphere()
    return (jsdf.fuse_point_normal_sdf(pts, nrm, voxel_size=VOXEL),
            psdf.fuse_point_normal_sdf(pts, nrm, voxel_size=VOXEL, **CPU))


@pytest.fixture(scope="module")
def golden_cloud():
    """The golden room's TLS points, colours and one set of normals (the
    port's PCA, oriented towards the room's centre) fed to both packages."""
    pts, cols, _ = S3DISLoader(str(GOLDEN)).load_room_data("Area_1", "office_1")
    pts = pts.astype(np.float32)
    nrm = estimate_normals(pts, radius=0.15, max_nn=16, orient_towards=pts.mean(axis=0), **CPU)
    return pts, nrm, cols.astype(np.float32)


# ---------------------------------------------------------------------------
# The splat
# ---------------------------------------------------------------------------
def test_fuse_matches_jax(grids):
    jg, pg = grids
    assert pg.shape == jg.shape and pg.voxel_size == jg.voxel_size
    np.testing.assert_array_equal(pg.origin, jg.origin)
    jw, js = np.asarray(jg.weight), np.asarray(jg.sdf)
    pw, ps = pg.weight.numpy(), pg.sdf.numpy()
    assert (jw > 1e-3).sum() > 1000
    np.testing.assert_allclose(pw, jw, rtol=1e-5, atol=1e-5 * jw.max())
    m = jw > 1e-3
    np.testing.assert_allclose(ps[m], js[m], rtol=0, atol=1e-6)


def test_grid_shape_buckets_as_jax():
    for d in range(0, 3000, 7):
        b = psdf._dim_bucket(d)
        assert b >= max(d, 32)
        assert b == psdf._dim_bucket(b)
    pts, nrm = sphere(500)
    for voxel in (0.03, 0.05, 0.11):
        jg = jsdf.fuse_point_normal_sdf(pts * 3.7, nrm, voxel_size=voxel)
        pg = psdf.fuse_point_normal_sdf(pts * 3.7, nrm, voxel_size=voxel, **CPU)
        assert pg.shape == jg.shape
        np.testing.assert_array_equal(pg.origin, jg.origin)


def test_fuse_chunks_sum_as_one(grids):
    """Chunking the points only cuts the list of additions."""
    pts, nrm = sphere()
    _, pg = grids
    origin = torch.from_numpy(pg.origin)
    s, w = psdf._fuse(torch.from_numpy(pts), torch.from_numpy(nrm), origin, VOXEL, pg.shape,
                      2, chunk=777)
    np.testing.assert_allclose(w.numpy(), pg.weight.numpy(), rtol=1e-5, atol=1e-6)
    m = pg.weight.numpy() > 1e-3
    np.testing.assert_allclose(s.numpy()[m], pg.sdf.numpy()[m], atol=1e-6)


def test_sdf_grid_round_trip(grids):
    jg, _ = grids
    g = psdf.SdfGrid.from_numpy(jg.sdf, jg.weight, jg.origin, jg.voxel_size, **CPU)
    sdf, weight, origin, voxel = g.to_numpy()
    np.testing.assert_array_equal(sdf, np.asarray(jg.sdf))
    np.testing.assert_array_equal(weight, np.asarray(jg.weight))
    np.testing.assert_array_equal(origin, jg.origin)
    assert voxel == jg.voxel_size and g.shape == jg.shape
    np.testing.assert_array_equal(g.valid(0.5).numpy(), np.asarray(jg.valid(0.5)))


# ---------------------------------------------------------------------------
# Marching tetrahedra and welding, on the JAX grid
# ---------------------------------------------------------------------------
def test_marching_on_the_jax_grid(grids):
    jg, _ = grids
    g = psdf.SdfGrid.from_numpy(jg.sdf, jg.weight, jg.origin, jg.voxel_size, **CPU)
    want = np.asarray(jmarch._classify_cubes(jg.sdf, jg.valid()))
    got = pmarch._classify_cubes(g.sdf, g.valid()).numpy()
    np.testing.assert_array_equal(got, want)
    ij = np.argwhere(want)
    assert len(ij) > 1000
    jt, jmask = jmarch._extract_active(jg.sdf, jax.numpy.asarray(ij.astype(np.int32)),
                                       jax.numpy.asarray(jg.origin), jg.voxel_size)
    pt, pmask = pmarch._extract_active(g.sdf, torch.from_numpy(ij), torch.from_numpy(g.origin),
                                       g.voxel_size)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    m = np.asarray(jmask)
    np.testing.assert_allclose(pt.numpy()[m], np.asarray(jt)[m], rtol=0, atol=1e-6)

    soup_j, ids_j = jmarch.marching_tetrahedra(jg)
    soup_p, ids_p = pmarch.marching_tetrahedra(g)
    np.testing.assert_array_equal(ids_p, ids_j)
    np.testing.assert_allclose(soup_p, soup_j, rtol=0, atol=1e-6)
    assert soup_p.dtype == np.float32 and ids_p.dtype == np.int32
    # Chunks only cut the list: the same soup in the same order, bit for bit.
    soup_c, ids_c = pmarch.marching_tetrahedra(g, chunk=1000)
    np.testing.assert_array_equal(soup_c, soup_p)
    np.testing.assert_array_equal(ids_c, ids_p)


def test_marching_empty_grid():
    g = psdf.SdfGrid.from_numpy(np.ones((4, 4, 4)), np.ones((4, 4, 4)), np.zeros(3), 0.1, **CPU)
    soup, ids = pmarch.marching_tetrahedra(g)
    assert soup.shape == (0, 3, 3) and ids.shape == (0,)


def test_marching_tables_are_the_jax_tables():
    for name in ("_CORNERS", "_TETS", "_TET_EDGES", "_TET_TRIS"):
        np.testing.assert_array_equal(getattr(pmarch, name), getattr(jmarch, name))


def test_weld_bit_equal(grids):
    jg, _ = grids
    soup, _ = jmarch.marching_tetrahedra(jg)
    for s in (soup, np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                              [[1, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32),
              np.zeros((0, 3, 3), np.float32)):
        (jv, jt), (pv, pt) = jmarch.weld_triangle_soup(s), pmarch.weld_triangle_soup(s)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pt, jt)
        assert pv.dtype == jv.dtype and pt.dtype == jt.dtype


# ---------------------------------------------------------------------------
# IMLS refinement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("branch", ["exact", "grid"])
def test_imls_matches_jax(branch, monkeypatch):
    """Both packages forced onto the same k-NN branch (the port's budget
    depends on the device, the JAX package's on its backend)."""
    budget = 0.0 if branch == "grid" else 1e30
    monkeypatch.setattr(jknn, "exact_pair_budget", lambda: budget)
    monkeypatch.setattr(pknn, "exact_pair_budget", lambda device=None: budget)
    rng = np.random.default_rng(3)
    pts = shell(rng, 6000, (2.0, 1.5, 1.2))
    nrm = estimate_normals(pts, radius=0.15, max_nn=16, orient_towards=pts.mean(axis=0), **CPU)
    verts = shell(rng, 1500, (2.0, 1.5, 1.2)) + rng.normal(0, 0.02, (1500, 3)).astype(np.float32)
    want = jsdf.imls_project_vertices(verts, pts, nrm, radius=0.12, iters=2)
    got = psdf.imls_project_vertices(verts, pts, nrm, radius=0.12, iters=2, **CPU)
    assert got.dtype == np.float32
    moved = np.linalg.norm(want - verts, axis=1)
    assert np.median(moved) > 1e-3  # the projection did something
    # The JAX exact join's norm expansion can swap the k-th neighbour of a
    # near-tie, which moves that vertex by millimetres: an agreement share.
    err = np.abs(got - want).max(axis=1)
    assert (err <= 1e-4).mean() >= 0.995, np.sort(err)[-10:]
    assert err.max() <= 0.1 * 0.12


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
def test_sample_with_the_jax_draws():
    mesh = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    n = 4000
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    u = torch.from_numpy(np.array(jax.random.uniform(k1, (n,))))
    r = torch.from_numpy(np.array(jax.random.uniform(k2, (n, 2))))
    want = jsamp.sample_points_on_mesh(JaxMesh(mesh.vertices, mesh.triangles), n)
    got = psamp._sample(*psamp._mesh_tables(mesh, "cpu"), n, u=u, r=r).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sample_points_on_mesh_distribution():
    """The port's own draws: on the surface, spread by area, seeded."""
    mesh = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    pts = psamp.sample_points_on_mesh(mesh, 20000, **CPU)
    assert pts.shape == (20000, 3) and pts.dtype == np.float32
    lo, hi = np.array([0, 0, 0]), np.array([4.0, 3.0, 2.5])
    on = np.isclose(pts, lo, atol=1e-5) | np.isclose(pts, hi, atol=1e-5)
    assert on.any(axis=1).all()
    areas = np.array([3.0 * 2.5, 4.0 * 2.5, 4.0 * 3.0]) * 2
    share = np.array([on[:, a].mean() for a in range(3)])
    np.testing.assert_allclose(share, areas / areas.sum(), atol=0.02)
    np.testing.assert_array_equal(pts, psamp.sample_points_on_mesh(mesh, 20000, **CPU))
    g = torch.Generator().manual_seed(5)
    assert not np.array_equal(pts, psamp.sample_points_on_mesh(mesh, 20000, g, **CPU))


def test_poisson_disk_spacing():
    mesh = TriMesh.box(center=(0, 0, 0), size=(2.0, 2.0, 2.0))
    n = 1500
    pd = psamp.sample_points_poisson_disk(mesh, n, **CPU)
    un = psamp.sample_points_on_mesh(mesh, n, **CPU)
    assert len(pd) == n

    def min_nn(pts):
        return cKDTree(pts).query(pts, k=2)[0][:, 1]

    assert np.percentile(min_nn(pd), 1) > 2 * np.percentile(min_nn(un), 1)
    assert np.all(np.isclose(np.abs(pd), 1.0, atol=1e-5).any(axis=1))


# ---------------------------------------------------------------------------
# SurfaceReconstructor
# ---------------------------------------------------------------------------
STAT_KEYS = {"input_points", "output_vertices", "output_faces", "reconstruction_time",
             "spans", "has_colors", "device_used", "voxel_size", "method", "mise_iter"}


def assert_meshes_agree(pm, jm, voxel, stats_p, stats_j, hausdorff=True):
    """Face counts within 0.5 %, the stats' keys, the vertices by distance
    (``hausdorff``: every vertex within 0.1 voxel of the other mesh's; else
    99.9 % of them within 0.1 mm both ways) and the faces' orientation as an
    agreement share."""
    nf_p, nf_j = pm.num_triangles, jm.num_triangles
    assert nf_j > 1000 and abs(nf_p - nf_j) <= 0.005 * nf_j, (nf_p, nf_j)
    assert set(stats_p) == set(stats_j) == STAT_KEYS
    assert set(stats_p["spans"]) == set(stats_j["spans"])
    for k in ("input_points", "has_colors", "voxel_size", "method", "mise_iter"):
        assert stats_p[k] == stats_j[k], k
    assert stats_p["device_used"] == "cpu"
    vp, vj = pm.vertices.astype(np.float64), np.asarray(jm.vertices, np.float64)
    d_pj, d_jp = cKDTree(vj).query(vp)[0], cKDTree(vp).query(vj)[0]
    if hausdorff:
        assert max(d_pj.max(), d_jp.max()) <= 0.1 * voxel, (d_pj.max(), d_jp.max())
    else:
        assert min((d_pj <= 1e-4).mean(), (d_jp <= 1e-4).mean()) >= 0.999, (
            np.sort(d_pj)[-5:], np.sort(d_jp)[-5:])
    # Orientation: each port face against the JAX face at its centroid.
    cp = pm.triangle_corners().mean(axis=1)
    cj = np.asarray(jm.triangle_corners()).mean(axis=1)
    near = cKDTree(cj).query(cp)[1]
    agree = (np.sum(pm.face_normals() * np.asarray(jm.face_normals())[near], axis=1) > 0).mean()
    assert agree >= 0.999, agree


def test_reconstruct_sphere_matches_jax():
    pts, nrm = sphere(6000)
    jm, js = jrec.SurfaceReconstructor(voxel_size=VOXEL, mise_iter=2).reconstruct(pts, nrm)
    pm, ps = prec.SurfaceReconstructor(voxel_size=VOXEL, mise_iter=2, **CPU).reconstruct(pts,
                                                                                          nrm)
    assert_meshes_agree(pm, jm, VOXEL, ps, js)
    r = np.linalg.norm(pm.vertices, axis=1)
    assert abs(np.median(r) - 1.0) < 0.01
    outward = pm.triangle_corners().mean(axis=1)
    assert (np.sum(pm.face_normals() * outward, axis=1) > 0).mean() > 0.99


def test_golden_room_active_cubes_differ_only_at_ties(golden_cloud):
    """The golden room's walls and furniture are axis-aligned planes at
    multiples of 5 cm; at voxel 0.1 some pass exactly through voxel
    centres, where the SDF is 0 and its sign is float32 rounding (about 1e-14
    in the JAX package, -2.4e-7 here).  The active cubes are equal except
    cubes with a corner |sdf| < 1e-6."""
    pts, nrm, _ = golden_cloud
    jg = jsdf.fuse_point_normal_sdf(pts, nrm, voxel_size=0.1)
    pg = psdf.fuse_point_normal_sdf(pts, nrm, voxel_size=0.1, **CPU)
    want = np.asarray(jmarch._classify_cubes(jg.sdf, jg.valid()))
    got = pmarch._classify_cubes(pg.sdf, pg.valid()).numpy()
    tie = np.minimum(np.abs(np.asarray(jg.sdf)), np.abs(pg.sdf.numpy())) < 1e-6
    x, y, z = tie.shape
    tie_cube = np.zeros_like(want)
    for dx, dy, dz in pmarch._CORNERS:
        tie_cube |= tie[dx:x - 1 + dx, dy:y - 1 + dy, dz:z - 1 + dz]
    assert want.sum() > 5000 and (got != want).any()  # the ties are there
    assert not ((got != want) & ~tie_cube).any()


def test_reconstruct_golden_room_matches_jax(golden_cloud):
    """At voxel 0.09 no plane passes through a voxel centre.  The IMLS
    step's grid k-NN picks its 2x2x2 window by the vertex's position, so a
    vertex an ulp apart can see other neighbours in a sparse corner: the
    vertices are held as an agreement share."""
    pts, nrm, cols = golden_cloud
    voxel = 0.09
    jm, js = jrec.SurfaceReconstructor(voxel_size=voxel, mise_iter=2).reconstruct(pts, nrm, cols)
    pm, ps = prec.SurfaceReconstructor(voxel_size=voxel, mise_iter=2, **CPU).reconstruct(
        pts, nrm, cols)
    assert_meshes_agree(pm, jm, voxel, ps, js, hausdorff=False)
    near = cKDTree(np.asarray(jm.vertices)).query(pm.vertices)[1]
    same = np.all(pm.vertex_colors == np.asarray(jm.vertex_colors)[near], axis=1).mean()
    assert same >= 0.99, same


def test_reconstruct_without_normals_and_chunked():
    rng = np.random.default_rng(0)
    plane = np.zeros((3000, 3), np.float32)
    plane[:, :2] = rng.uniform(0, 2, (3000, 2))
    jm, _ = jrec.SurfaceReconstructor(voxel_size=0.1).reconstruct(plane, None)
    pm, ps = prec.SurfaceReconstructor(voxel_size=0.1, **CPU).reconstruct(plane, None)
    assert ps["output_faces"] > 0 and np.abs(pm.vertices[:, 2]).max() < 0.15
    assert abs(pm.num_triangles - jm.num_triangles) <= 0.005 * jm.num_triangles

    strip = np.zeros((4000, 3), np.float32)
    strip[:, 0] = rng.uniform(0, 6, 4000)
    strip[:, 1] = rng.uniform(0, 1, 4000)
    up = np.tile(np.array([[0, 0, 1]], np.float32), (4000, 1))
    kw = dict(voxel_size=0.12, chunked=True, chunk_size=2.0)
    jm, js = jrec.SurfaceReconstructor(**kw).reconstruct(strip, up)
    pm, ps = prec.SurfaceReconstructor(**kw, **CPU).reconstruct(strip, up)
    assert "fuse_and_march" in ps["spans"] and set(ps["spans"]) == set(js["spans"])
    assert abs(pm.num_triangles - jm.num_triangles) <= 0.005 * jm.num_triangles
    assert pm.vertices[:, 0].max() - pm.vertices[:, 0].min() > 4.5


def test_semantic_mesh_reconstructor(tmp_path):
    pts, nrm = sphere(3000)
    labels = (pts[:, 2] > 0).astype(np.int32) * 8  # two classes: 0 / chair
    jr = jrec.SemanticMeshReconstructor(num_classes=13, voxel_size=0.1)
    pr = prec.SemanticMeshReconstructor(num_classes=13, voxel_size=0.1, **CPU)
    jm, js = jr.reconstruct_with_semantics(pts, nrm, labels)
    pm, ps = pr.reconstruct_with_semantics(pts, nrm, labels)
    assert ps["num_classes"] == js["num_classes"] == 13
    out = tmp_path / "semantic.ply"
    assert pr.save_semantic_mesh(pm, out, ps)
    jr.save_semantic_mesh(jm, tmp_path / "jax.ply", js)
    assert out.with_suffix(".colormap.txt").read_text() == \
        (tmp_path / "jax.colormap.txt").read_text()
    decoded = pr.decode_mesh_labels(pm)
    near = cKDTree(np.asarray(jm.vertices)).query(pm.vertices)[1]
    assert (decoded == jr.decode_mesh_labels(jm)[near]).mean() >= 0.99
    assert (decoded[pm.vertices[:, 2] > 0.3] == 8).mean() > 0.9


def test_facade_and_evaluator_match_jax(tmp_path):
    pts, nrm = sphere(3000)
    cfg = {"nksr": {"detail_level": 0.15, "voxel_size": 0.1, "chunked": False,
                    "chunk_size": 60.0, "device": "auto"},
           "evaluation": {"max_eval_points": 2000, "compute_chamfer": True,
                          "compute_mesh_quality": True}}
    pr = prec.S3DISReconstructor(cfg, **CPU)
    assert pr.core.voxel_size == jrec.S3DISReconstructor(cfg).core.voxel_size
    assert pr.core.mise_iter == 2
    pm, stats = pr.reconstruct_mesh(pts, nrm)
    out = tmp_path / "mesh_dense.ply"
    assert pr.save_mesh(pm, out, stats)
    assert out.with_suffix(".json").exists()
    assert TriMesh.load(out).num_triangles == pm.num_triangles

    # The same mesh into both evaluators: the mesh-quality metrics are host
    # numpy (equal); the Chamfer distance samples the mesh with each
    # package's own draws, so it agrees within the sampling's spread.
    jm = JaxMesh(pm.vertices.copy(), pm.triangles.copy())
    want = jrec.S3DISEvaluator(cfg).evaluate_reconstruction_quality(jm, pts)
    got = prec.S3DISEvaluator(cfg, **CPU).evaluate_reconstruction_quality(pm, pts)
    assert set(got) == set(want)
    for k in ("mesh_vertices", "mesh_faces", "is_watertight", "volume_method"):
        assert got[k] == want[k], k
    for k in ("surface_area", "volume"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert got["chamfer_distance"] == pytest.approx(want["chamfer_distance"], rel=0.1)
    assert got["chamfer_distance"] < 0.05
    assert prec.S3DISEvaluator._is_watertight(TriMesh.box(center=(0, 0, 0), size=(1, 1, 1)))


# ---------------------------------------------------------------------------
# reconstruct_room, the CLI and the projections
# ---------------------------------------------------------------------------
RECON_CFG = {"nksr": {"voxel_size": 0.1, "mise_iter": 2},
             "evaluation": {"compute_chamfer": False, "compute_mesh_quality": True},
             "visualization": {"save_visualizations": False}}


@pytest.fixture(scope="module")
def room_pickle(tmp_path_factory):
    root = tmp_path_factory.mktemp("room")
    pts, nrm = sphere(3000)
    cols = (pts + 1) / 2
    variant = {"points": pts, "normals": nrm, "colors": cols, "labels": None,
               "config": {"name": "dense"}}
    half = {k: (v[::2] if isinstance(v, np.ndarray) else v) for k, v in variant.items()}
    room = {"area": "Area_9", "room": "ball_1", "points": pts, "colors": cols, "labels": None,
            "normals": nrm, "variants": {"dense": variant, "sparse50": half}}
    path = root / "Area_9_ball_1_preprocessed.pkl"
    path.write_bytes(pickle.dumps(room))
    return path


def assert_summaries_agree(got, want):
    """reconstruction_summary.txt: the same lines but for each variant's row,
    where the time column is free and the vertex and face counts agree
    within 0.5 % (one ulp of an SDF near 0 can flip a cube, and one of a
    vertex near a 1e-5 m rounding boundary can split a welded vertex)."""
    g, w = got.read_text().splitlines(), want.read_text().splitlines()
    assert len(g) == len(w) and g[:5] == w[:5]
    for rg, rw in zip(g[5:], w[5:]):
        (cg, ng, vg, fg, _, eg), (cw, nw, vw, fw, _, ew) = rg.split(), rw.split()
        assert (cg, ng, eg) == (cw, nw, ew)
        assert int(vg) == pytest.approx(int(vw), rel=0.005)
        assert int(fg) == pytest.approx(int(fw), rel=0.005)


def test_reconstruct_room_matches_jax(room_pickle, tmp_path):
    spans = {}
    want = jcli.reconstruct_room(str(room_pickle), RECON_CFG, str(tmp_path / "jax"))
    got = pcli.reconstruct_room(str(room_pickle), RECON_CFG, str(tmp_path / "port"),
                                span_sink=spans, **CPU)
    assert list(got) == list(want) == ["dense", "sparse50"]
    for name in got:
        assert set(got[name]) == set(want[name])
        sp, sj = got[name]["reconstruction_stats"], want[name]["reconstruction_stats"]
        assert set(sp) == set(sj) == STAT_KEYS
        for k in ("input_points", "has_colors"):
            assert sp[k] == sj[k], (name, k)
        for k in ("output_vertices", "output_faces"):
            assert sp[k] == pytest.approx(sj[k], rel=0.005), (name, k)
        qp, qj = got[name]["quality_metrics"], want[name]["quality_metrics"]
        assert set(qp) == set(qj)
        assert qp["surface_area"] == pytest.approx(qj["surface_area"], rel=1e-4)
    scene = "Area_9_ball_1"
    assert_summaries_agree(tmp_path / "port" / scene / "reconstruction_summary.txt",
                           tmp_path / "jax" / scene / "reconstruction_summary.txt")
    for f in ("mesh_dense.ply", "mesh_dense.json", "mesh_sparse50.ply",
              "reconstruction_report.json"):
        assert (tmp_path / "port" / scene / f).is_file(), f
    assert {"load_pickle", "init", "recon", "save_mesh", "report", "op_fuse", "op_march",
            "op_weld", "op_imls", "op_orient", "op_colors"} <= set(spans)
    only = pcli.reconstruct_room(str(room_pickle), RECON_CFG, str(tmp_path / "one"),
                                 sparsity="sparse50", **CPU)
    assert list(only) == ["sparse50"]


def test_cli_main(room_pickle, tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(RECON_CFG))
    res = pcli.main(["--config", str(cfg), "--data_path", str(room_pickle),
                     "--output_dir", str(tmp_path / "out"), "--sparsity", "dense"], **CPU)
    assert list(res) == ["dense"] and "error" not in res["dense"]
    assert (tmp_path / "out" / "Area_9_ball_1" / "reconstruction_report.json").is_file()


def test_projection_viz_draws_or_raises(tmp_path, monkeypatch):
    pts, _ = sphere(500)
    mesh = TriMesh.box(center=(0, 0, 0), size=(1, 1, 1))
    off = ReconstructionVisualizer({"visualization": {"save_visualizations": False}})
    assert off.visualize_pointcloud(pts, output_path=tmp_path / "x.png") is None
    assert off.visualize_mesh_projection(mesh, output_path=tmp_path / "y.png") is None
    on = ReconstructionVisualizer({"visualization": {"max_vis_points": 100}})
    # Without matplotlib (the GPU host) a draw asked for raises.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        on.visualize_pointcloud(pts, output_path=tmp_path / "p.png")
    monkeypatch.undo()
    pytest.importorskip("matplotlib")
    assert on.visualize_pointcloud(pts, colors=(pts + 1) / 2,
                                   output_path=tmp_path / "p.png").is_file()
    assert on.visualize_mesh_projection(mesh, output_path=tmp_path / "m.png").is_file()
