"""Fused scan: the port's ``_scan_core`` against JAX ``scan_waypoints``.

The JAX side runs its mxu backend in interpret mode (patched in as
tests/test_raycast_mxu.py:312-336 does), so its ``scan_permutation`` is the
patch order and ``"unordered"`` rows line up with the port's.  The port is
fed the patterns and keep masks JAX drew (``jax.random`` streams are not
reproduced), so both sides scan identical rays.  Tolerances: per-waypoint hit
counts within 0.5 %, and on the rows the raycast contract of
tests/test_tpu_hardware.py:234-258 (valid masks agree >= 99 %, hit-point
error p99 <= 5 mm, max <= 5 cm): the port's Pluecker products round
differently from JAX's bf16x3 ones.

The unordered output is checked on its own terms too: per waypoint, the same
hit count and the same order-free hash of the hit points (quantised to
0.1 mm) as the beam-ordered output of the same scan.  The port's own random
draws are checked by distribution.

The culled scan (``backend="culled"``) is held against JAX
``scan_waypoints(backend="xla")``, the same function as "pallas" with the
same identity permutation: rows in beam order for both "unordered" and
"full", masks equal and hit points within 1e-5 m (both are float32
Moller-Trumbore; XLA may fuse what torch rounds step by step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import jax  # noqa: E402

from ipcgen_tpu.models import (  # noqa: E402
    DualAxisLidarIntrinsics as JaxDual,
    Indoor8LineLidarIntrinsics as JaxLine,
)
from ipcgen_tpu.ops.raycast_mxu import raycast_asset_mxu  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu.sim import scan as jax_scan  # noqa: E402
from ipcgen_tpu.trajectory import Waypoint  # noqa: E402
from ipcgen_tpu.trajectory.waypoint import waypoints_to_pose_batch  # noqa: E402
from ipcgen_tpu_torch.models import beams, from_reference  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.sim import scan as port_scan  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import cluttered_room  # noqa: E402


def profiles():
    blk = JaxDual.create_blk2go_dual_axis()
    blk.point_rate = 40_000  # 64 k rays per waypoint cut to 4,000
    dense = JaxLine.create_dense_32line()
    dense.horizontal_res = 250  # 128 k rays cut to 8,000
    line8 = JaxLine.create_standard_8line()
    line8.horizontal_res = 500  # 16 k rays cut to 4,000
    return {"line8": line8, "dense32": dense, "blk2go": blk}


POSES = waypoints_to_pose_batch([
    Waypoint(1.2, 1.0, 1.0, 0.3), Waypoint(2.8, 2.0, 1.0, 2.1),
    Waypoint(2.0, 1.5, 1.4, -1.0), Waypoint(3.3, 0.8, 0.8, 4.0),
])


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng)
    return jax_build(verts, tris), build_scene_asset(verts, tris, device="cpu")


def quantised_hash(points: np.ndarray) -> int:
    """Order-free hash of a point set quantised to 0.1 mm."""
    q = np.round(points.astype(np.float64) * 1e4).astype(np.int64).view(np.uint64)
    h = (q[:, 0] * np.uint64(0x9E3779B97F4A7C15)) ^ \
        (q[:, 1] * np.uint64(0xC2B2AE3D27D4EB4F)) ^ \
        (q[:, 2] * np.uint64(0x165667B19E3779F9))
    h ^= h >> np.uint64(29)
    return int(np.sum(h * np.uint64(0xBF58476D1CE4E5B9), dtype=np.uint64))


def per_waypoint(batch_points, batch_mask):
    return [(int(m.sum()), quantised_hash(p[m])) for p, m in zip(batch_points, batch_mask)]


def jax_scan_mxu(ja, intr, outputs, monkeypatch):
    orig = jax_scan.raycast_asset

    def patched(o, d, a, backend="auto", t_max=np.inf):
        if backend == "mxu":
            return raycast_asset_mxu(o, d, a, t_max=t_max, interpret=True)
        return orig(o, d, a, backend=backend, t_max=t_max)

    monkeypatch.setattr(jax_scan, "raycast_asset", patched)
    b = jax_scan.scan_waypoints(ja, intr, POSES, key=jax.random.PRNGKey(7),
                                backend="mxu", outputs=outputs)
    return np.asarray(b.points), np.asarray(b.mask)


JAX_BACKEND = {"pairs": "mxu", "culled": "xla"}


def port_scan_injected(pa, jintr, outputs, backend="pairs"):
    """The port's scan core on the patterns/keep masks JAX drew."""
    pintr = from_reference(jintr)
    dirs, keep = jax_scan.sensor_dirs_batch(jintr, len(POSES), jax.random.PRNGKey(7))
    dirs = torch.from_numpy(np.array(dirs))
    keep = torch.from_numpy(np.array(keep)) if isinstance(jintr, JaxDual) else None
    r = dirs.shape[1]
    perm, inv = port_scan.scan_permutation(pintr, r, backend)
    jperm, _ = jax_scan.scan_permutation(jintr, JAX_BACKEND[backend], r)
    np.testing.assert_array_equal(perm, jperm)
    b = port_scan._scan_core(
        pa, torch.from_numpy(POSES), dirs, keep, None, torch.tensor(perm),
        torch.tensor(inv), float(pintr.max_range), outputs, backend)
    return b.points.numpy(), b.mask.numpy()


@pytest.mark.parametrize("outputs", ["unordered", "full"])
@pytest.mark.parametrize("profile", ["line8", "dense32", "blk2go"])
def test_scan_core_matches_jax(scene, profile, outputs, monkeypatch):
    ja, pa = scene
    jintr = profiles()[profile]
    jp, jm = jax_scan_mxu(ja, jintr, outputs, monkeypatch)
    pp, pm = port_scan_injected(pa, jintr, outputs)
    assert pp.shape == jp.shape and pm.shape == jm.shape
    for w in range(len(POSES)):
        nj, np_ = int(jm[w].sum()), int(pm[w].sum())
        assert abs(np_ - nj) <= 0.005 * nj, (w, np_, nj)
    assert (pm == jm).mean() >= 0.99
    both = pm & jm
    pe = np.linalg.norm(pp[both] - jp[both], axis=1)
    assert np.percentile(pe, 99) <= 0.005 and pe.max() <= 0.05


@pytest.mark.parametrize("profile", ["dense32", "blk2go"])
def test_unordered_same_hits_as_full(scene, profile):
    """Per waypoint, "unordered" holds exactly the hits of "full": the same
    count and the same order-free hash of the quantised points."""
    _, pa = scene
    jintr = profiles()[profile]
    pu = per_waypoint(*port_scan_injected(pa, jintr, "unordered"))
    pf = per_waypoint(*port_scan_injected(pa, jintr, "full"))
    assert pu == pf
    assert all(n > 0 for n, _ in pu)


def test_scan_waypoints_draws_its_own_patterns(scene):
    """``scan_waypoints`` with a generator: deterministic per seed, dropout
    applied to the mask, and every kept in-room ray hits."""
    _, pa = scene
    intr = from_reference(profiles()["blk2go"])
    runs = [port_scan.scan_waypoints(
        pa, intr, POSES, generator=torch.Generator().manual_seed(s),
        outputs="unordered") for s in (3, 3, 4)]
    assert torch.equal(runs[0].points, runs[1].points)
    assert not torch.equal(runs[0].points, runs[2].points)
    frac = runs[0].mask.float().mean().item()
    assert 0.95 < frac < 0.995  # ~2 % dropout, nothing else is lost


@pytest.mark.parametrize("profile", ["dense32", "blk2go"])
def test_scan_rays_are_the_scans_own(scene, profile):
    """``scan_rays`` with the scan's generator state gives the scan's rays:
    raycasting them as the scan does and masking by keep reproduces the
    "unordered" output bit for bit."""
    from ipcgen_tpu_torch.ops.raycast import raycast_asset

    _, pa = scene
    intr = from_reference(profiles()[profile])
    batch = port_scan.scan_waypoints(
        pa, intr, POSES, generator=torch.Generator().manual_seed(11),
        outputs="unordered")
    o, d, keep = port_scan.scan_rays(intr, POSES, torch.Generator().manual_seed(11),
                                     "cpu")
    assert (keep is None) == (profile == "dense32")
    res = raycast_asset(o, d, pa, t_max=float(intr.max_range), sort_rays=False)
    mask = res.hit if keep is None else res.hit & keep
    w, r = batch.mask.shape
    assert torch.equal(mask.view(w, r), batch.mask)
    assert torch.equal(res.points.view(w, r, 3)[batch.mask], batch.points[batch.mask])


@pytest.mark.parametrize("outputs", ["unordered", "full"])
@pytest.mark.parametrize("profile", ["line8", "dense32", "blk2go"])
def test_culled_scan_matches_jax_xla(scene, profile, outputs):
    ja, pa = scene
    jintr = profiles()[profile]
    jb = jax_scan.scan_waypoints(ja, jintr, POSES, key=jax.random.PRNGKey(7),
                                 backend="xla", outputs=outputs)
    jp, jm = np.asarray(jb.points), np.asarray(jb.mask)
    pp, pm = port_scan_injected(pa, jintr, outputs, backend="culled")
    assert pp.shape == jp.shape
    np.testing.assert_array_equal(pm, jm)
    assert pm.mean() > 0.9
    np.testing.assert_allclose(pp[pm], jp[jm], atol=1e-5, rtol=0)


@pytest.mark.parametrize("profile", ["dense32", "blk2go"])
def test_culled_scan_rays_are_the_scans_own(scene, profile):
    """``scan_rays(backend="culled")`` gives the culled scan's rays, in beam
    order (identity permutation): cast again they reproduce its
    "unordered" output bit for bit, which equals its beam-ordered "minimal"
    output."""
    from ipcgen_tpu_torch.ops.raycast import raycast_asset

    _, pa = scene
    intr = from_reference(profiles()[profile])
    scans = [port_scan.scan_waypoints(
        pa, intr, POSES, generator=torch.Generator().manual_seed(11),
        outputs=outputs, backend="culled") for outputs in ("unordered", "minimal")]
    assert torch.equal(scans[0].mask, scans[1].mask)
    assert torch.equal(scans[0].points, scans[1].points)
    o, d, keep = port_scan.scan_rays(intr, POSES, torch.Generator().manual_seed(11),
                                     "cpu", backend="culled")
    res = raycast_asset(o, d, pa, backend="culled", t_max=float(intr.max_range))
    mask = res.hit if keep is None else res.hit & keep
    w, r = scans[0].mask.shape
    assert torch.equal(mask.view(w, r), scans[0].mask)
    assert torch.equal(res.points.view(w, r, 3)[scans[0].mask],
                       scans[0].points[scans[0].mask])


def test_scan_permutation_follows_the_backend():
    """Patch order for the pair kernel, the identity for the others (as the
    JAX package gives its mxu and its other backends), whether the port's
    names or the JAX package's name them; an unknown name raises."""
    jax_names = ("auto", "mxu", "pallas", "xla", "xla_brute")
    for name, jintr in profiles().items():
        pintr = from_reference(jintr)
        r = 4000 if name != "dense32" else 8000
        for backend, jax_backend in (("pairs", "mxu"), ("culled", "pallas"),
                                     ("brute", "xla_brute"),
                                     *zip(jax_names, jax_names)):
            perm, inv = port_scan.scan_permutation(pintr, r, backend)
            jperm, jinv = jax_scan.scan_permutation(jintr, jax_backend, r)
            np.testing.assert_array_equal(perm, jperm)
            np.testing.assert_array_equal(inv, jinv)
            if jax_backend != "mxu":
                np.testing.assert_array_equal(perm, np.arange(r))
        with pytest.raises(ValueError, match="unknown raycast backend"):
            port_scan.scan_permutation(pintr, r, "embree")


def test_dual_axis_dropout_rate():
    """Dropout rate within 5 sigma of the profile's 0.02."""
    g = torch.Generator().manual_seed(0)
    n, p = 256_000, 0.02
    _, keep = beams.gen_dual_axis_dirs(g, n, 32, -0.35, 0.26, 0.087, 1.0,
                                       0.001, p)
    rate = 1.0 - keep.float().mean().item()
    sigma = np.sqrt(p * (1 - p) / keep.numel())
    assert abs(rate - p) <= 5 * sigma, (rate, sigma)


def test_dual_axis_angle_noise_std():
    """Angle-noise std within 5 % of the profile's 0.001 rad, on both axes."""
    args = (64_000, 32, -20 * np.pi / 180, 15 * np.pi / 180, 5 * np.pi / 180, 1.0)
    d0, _ = beams.gen_dual_axis_dirs(torch.Generator().manual_seed(0), *args, 0.0, 0.0)
    d1, _ = beams.gen_dual_axis_dirs(torch.Generator().manual_seed(1), *args, 0.001, 0.0)
    d0, d1 = d0.double(), d1.double()
    dtheta = torch.asin(d1[:, 2]) - torch.asin(d0[:, 2])
    dphi = torch.atan2(d1[:, 1], d1[:, 0]) - torch.atan2(d0[:, 1], d0[:, 0])
    dphi = (dphi + np.pi) % (2 * np.pi) - np.pi
    for x in (dtheta, dphi):
        assert abs(x.std().item() / 0.001 - 1.0) <= 0.05, x.std().item()
