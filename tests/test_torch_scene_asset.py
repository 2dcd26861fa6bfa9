"""Scene asset: the port's build against the JAX package's, array for array.

The port's numpy build (``build_scene_arrays``) is the JAX build's host
numpy, and on the CPU ``build_scene_asset`` takes the plain torch version,
held to both; the arrays must be IDENTICAL (``array_equal`` with NaN
positions, no tolerance): the packed slots that the raycast returns index
them.  ``load_scene`` times the mesh read and the asset build apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.containers import TriMesh  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from benchmark.rooms import Room, room_rng  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import (  # noqa: E402
    build_scene_arrays,
    build_scene_asset,
    scene_asset_from_numpy,
)
from ipcgen_tpu_torch.utils.synthetic import asset_edge_meshes, synthetic_room  # noqa: E402

FIELDS = ("tri_data", "block_lo", "block_hi", "super_lo", "super_hi",
          "tri_index", "tri_normal", "tri_fin")


def _box_room():
    m = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    return np.asarray(m.vertices, np.float32), np.asarray(m.triangles, np.int32)


def jax_fields(asset):
    out = {k: np.asarray(getattr(asset, k)) for k in FIELDS}
    out.update(n_tris=asset.n_tris, block_size=asset.block_size,
               super_factor=asset.super_factor)
    return out


def assert_same_asset(port, ref_fields):
    for k in FIELDS:
        got = getattr(port, k).cpu().numpy()
        want = ref_fields[k]
        assert got.dtype == want.dtype, k
        assert got.shape == want.shape, k
        assert np.array_equal(got, want, equal_nan=True), k
    assert port.n_tris == ref_fields["n_tris"]
    assert port.block_size == ref_fields["block_size"]
    assert port.super_factor == ref_fields["super_factor"]


def scene_mesh(scene):
    """(vertices, triangles) of a named test scene."""
    if scene == "box":
        return _box_room()
    if scene == "synthetic156":
        verts, tris = synthetic_room(200)  # 156 triangles: no subdivision
        assert len(tris) == 156
        return verts, tris
    if scene == "office3cm":  # the benchmark's room, cut as its cells cut it
        verts, tris = Room.draw(room_rng(3500000037, 0)).recon_mesh(0.03)
        return verts.astype(np.float64), tris
    return asset_edge_meshes()[scene]


@pytest.mark.parametrize(
    "scene, block_size, super_factor",
    [("box", 128, 8), ("box", 8, 2), ("synthetic156", 128, 8),
     ("synthetic156", 16, 4), ("office3cm", 128, 8), ("ragged", 128, 8),
     ("few_blocks", 128, 8), ("single", 128, 8), ("zero_area", 16, 4),
     ("equal_centroids", 128, 8), ("equal_centroids", 4, 2), ("flat", 128, 8)],
)
def test_build_matches_jax(scene, block_size, super_factor):
    verts, tris = scene_mesh(scene)
    ref = jax_fields(jax_build(verts, tris, block_size, super_factor))
    port = build_scene_asset(verts, tris, block_size, super_factor, device="cpu")
    assert_same_asset(port, ref)
    # Padded blocks (if any) keep NaN boxes in the same places.
    assert np.array_equal(np.isnan(port.block_lo.numpy()),
                          np.isnan(ref["block_lo"]))
    # The numpy build, the reference of the plain torch version and the
    # kernels, is the JAX build's.
    assert_same_asset(scene_asset_from_numpy(
        build_scene_arrays(verts, tris, block_size, super_factor), "cpu"), ref)


def test_from_numpy_round_trip():
    """A JAX asset carried over as numpy equals the port's own build."""
    verts, tris = synthetic_room(200)
    ref = jax_fields(jax_build(verts, tris, 16, 4))
    carried = scene_asset_from_numpy(ref, "cpu")
    assert_same_asset(carried, ref)
    own = build_scene_asset(verts, tris, 16, 4, device="cpu")
    for k in FIELDS:
        assert np.array_equal(getattr(own, k).numpy(),
                              getattr(carried, k).numpy(), equal_nan=True), k


def test_load_scene_spans(tmp_path):
    """``load_scene`` records the mesh read and the asset build as spans
    inside its own, and the counter ``asset_device_build``: 0 on the CPU."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh as PortMesh
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    verts, tris = synthetic_room(200)
    path = tmp_path / "room.ply"
    PortMesh(verts, tris).save(path)
    sim = S3DISSimulator({}, device="cpu")
    sim.load_scene(str(path))
    prof = sim.rec.profile
    assert prof["asset_device_build"] == 0.0
    assert prof["load_scene"] >= prof["mesh_read"] + prof["asset_build"]
    parents = {e.name: e.parent for e in sim.rec.events}
    assert parents["mesh_read"] == "load_scene" and parents["asset_build"] == "load_scene"
    assert sim.scene_asset.device.type == "cpu" and sim.scene_asset.n_tris == 156
