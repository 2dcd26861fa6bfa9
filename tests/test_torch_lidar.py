"""The port's sensor classes and beam transforms against the JAX package on
the CPU.

- ``rays_to_world``, ``IndoorLidar.get_rays`` and the grid patterns of
  ``sensor_dirs_from_intrinsics``: the same float32 products, to 1e-6;
- ``asset_from_mesh``: the same host build, array for array;
- ``DualAxisLidar``'s numpy noise (``get_rays_sequence``,
  ``add_noise_to_rays``): seeded from the key data JAX's ``PRNGKey(seed)``
  holds, so bit for bit, call after call;
- the dual-axis pattern itself is drawn from a torch generator, which no
  JAX key reproduces: ``get_multi_line_rays`` is compared on JAX's draws
  injected, and the port's own draws by their distribution.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import jax  # noqa: E402

from ipcgen_tpu.containers import TriMesh as JaxMesh  # noqa: E402
from ipcgen_tpu.models import beams as jbeams  # noqa: E402
from ipcgen_tpu.models import lidar as jlidar  # noqa: E402
from ipcgen_tpu.models import lidar_intrinsics as jintr  # noqa: E402
from ipcgen_tpu.ops.scene_asset import asset_from_mesh as jax_asset  # noqa: E402
from ipcgen_tpu_torch import models as pmodels  # noqa: E402
from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.models import beams as pbeams  # noqa: E402
from ipcgen_tpu_torch.models import lidar as plidar  # noqa: E402
from ipcgen_tpu_torch.models import lidar_intrinsics as pintr  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import _ARRAY_FIELDS, asset_from_mesh  # noqa: E402

CPU = dict(device="cpu")
GRID_PROFILES = ["create_standard_8line", "create_dense_32line", "create_high_resolution_8line",
                 "create_low_cost_8line", "create_leica_blk2go"]


def pose(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    p = np.eye(4)
    p[:3, :3] = q * np.sign(np.linalg.det(q))
    p[:3, 3] = rng.uniform(-3, 3, 3)
    return p


def test_rays_to_world_matches_jax():
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(5000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    p = pose(1)
    want = np.asarray(jbeams.rays_to_world(jax.numpy.asarray(dirs), p))
    got = pbeams.rays_to_world(torch.from_numpy(dirs), p)
    assert got.shape == (5000, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(pbeams.dirs_to_world(torch.from_numpy(dirs),
                                                    torch.from_numpy(p)).numpy(),
                               want[:, 3:], atol=1e-6)


@pytest.mark.parametrize("profile", GRID_PROFILES)
def test_indoor_lidar_get_rays_matches_jax(profile):
    p = pose(2)
    want = jlidar.IndoorLidar(getattr(jintr.Indoor8LineLidarIntrinsics, profile)(), p)
    got = plidar.IndoorLidar(getattr(pintr.Indoor8LineLidarIntrinsics, profile)(), p, **CPU)
    np.testing.assert_allclose(got.get_rays(), want.get_rays(), atol=1e-6)
    d, keep = got.beam_directions()
    wd, wkeep = want.beam_directions()
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-6)
    assert keep.all() and np.asarray(wkeep).all()
    assert got.get_total_rays() == want.get_total_rays()
    assert got.get_range_limits() == want.get_range_limits()
    assert got.get_scan_frequency() == want.get_scan_frequency()


def test_asset_from_mesh_matches_jax():
    room = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    jroom = JaxMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    got = asset_from_mesh(room, block_size=4, super_factor=2, **CPU)
    want = jax_asset(jroom, block_size=4, super_factor=2)
    for name in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.n_tris, got.block_size, got.super_factor) == \
        (want.n_tris, want.block_size, want.super_factor)


def dual_pair(seed):
    p = pose(3)
    want = jlidar.DualAxisLidar(jintr.DualAxisLidarIntrinsics.create_blk2go_dual_axis(), p,
                                rng_key=jax.random.PRNGKey(seed))
    got = plidar.DualAxisLidar(pintr.DualAxisLidarIntrinsics.create_blk2go_dual_axis(), p,
                               seed=seed, **CPU)
    return want, got


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 1, -5])
def test_dual_axis_numpy_noise_bit_equal(seed):
    want, got = dual_pair(seed)
    np.testing.assert_array_equal(got._key, np.asarray(jax.random.key_data(want.rng_key)))
    assert got.intrinsics.angle_noise_std > 0 and got.intrinsics.dropout_probability > 0
    ts = want.intrinsics.generate_time_sequence(0.05)
    for _ in range(2):  # the draw counter advances alike
        np.testing.assert_array_equal(got.get_rays_sequence(ts), want.get_rays_sequence(ts))
    rays = got.get_rays_sequence(ts)
    want.get_rays_sequence(ts)
    for _ in range(2):
        np.testing.assert_array_equal(got.add_noise_to_rays(rays), want.add_noise_to_rays(rays))
    sp, sts = got.get_spiral_scan_rays(4096)
    wp, wts = want.get_spiral_scan_rays(4096)
    np.testing.assert_array_equal(sp, wp)
    np.testing.assert_array_equal(sts, wts)
    np.testing.assert_array_equal(got.get_rays_at_time(0.37), want.get_rays_at_time(0.37))


def test_dual_axis_seed_outside_jax_range_raises():
    with pytest.raises(ValueError, match="seed"):
        plidar.DualAxisLidar(pintr.DualAxisLidarIntrinsics.create_blk2go_dual_axis(),
                             np.eye(4), seed=2**32, **CPU)


def test_get_multi_line_rays_with_jax_draws(monkeypatch):
    """The pattern JAX drew, injected: the same world rays after dropout."""
    want, got = dual_pair(11)
    wd, wkeep = want.beam_directions(8000)
    monkeypatch.setattr(got, "beam_directions", lambda num_points=None, generator=None: (
        torch.from_numpy(np.array(wd)), torch.from_numpy(np.array(wkeep))))
    np.testing.assert_allclose(got.get_multi_line_rays(8000), want.get_multi_line_rays(8000),
                               atol=1e-6)


def test_dual_axis_own_draws_by_distribution():
    _, got = dual_pair(0)
    d, keep = got.beam_directions()
    intr = got.intrinsics
    n = int(intr.point_rate * intr.scan_duration)
    assert d.shape == ((n // intr.num_vertical_lines) * intr.num_vertical_lines, 3)
    np.testing.assert_allclose(d.norm(dim=1).numpy(), 1.0, atol=1e-6)
    assert abs(float(keep.float().mean()) - (1 - intr.dropout_probability)) < 0.005
    d2, keep2 = got.beam_directions()  # no generator: the seed's pattern again
    assert torch.equal(d, d2) and torch.equal(keep, keep2)
    g = torch.Generator().manual_seed(5)
    d3, _ = got.beam_directions(generator=g)
    assert not torch.equal(d, d3)
    rays = got.get_multi_line_rays()
    assert rays.shape == (int(keep.sum()), 6)
    np.testing.assert_allclose(rays[:, :3], np.broadcast_to(got.pose[:3, 3], (len(rays), 3)),
                               atol=1e-6)


@pytest.mark.parametrize("profile", GRID_PROFILES + ["blk2go_dual_axis"])
def test_sensor_dirs_and_lidar_type(profile):
    if profile == "blk2go_dual_axis":
        wi = jintr.DualAxisLidarIntrinsics.create_blk2go_dual_axis()
        pi = pintr.DualAxisLidarIntrinsics.create_blk2go_dual_axis()
    else:
        wi = getattr(jintr.Indoor8LineLidarIntrinsics, profile)()
        pi = getattr(pintr.Indoor8LineLidarIntrinsics, profile)()
    assert pmodels.get_lidar_type(pi) == jlidar.get_lidar_type(wi)
    lidar = pmodels.create_lidar(pi, np.eye(4), seed=3, **CPU)
    assert type(lidar).__name__ == type(jlidar.create_lidar(wi, np.eye(4))).__name__
    d, keep = pbeams.sensor_dirs_from_intrinsics(pi, **CPU)
    wd, wkeep = jbeams.sensor_dirs_from_intrinsics(wi)
    assert d.shape == np.asarray(wd).shape and keep.shape == np.asarray(wkeep).shape
    if profile != "blk2go_dual_axis":
        np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-6)
    assert pmodels.get_lidar_type(object()) == "Unknown type"


def test_simulated_dual_axis_type_string():
    intr = pintr.Indoor8LineLidarIntrinsics.create_standard_8line()
    intr.dual_axis = True
    assert pmodels.get_lidar_type(intr) == "Single-axis simulated dual-axis"
