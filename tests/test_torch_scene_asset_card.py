"""The scene asset's device builds (``ops/scene_asset.py``): the kernels of
``csrc/scene_asset.cu`` on the card and the plain torch version, each held
to the numpy build ``build_scene_arrays`` bit for bit (``array_equal`` with
NaN positions), and the dispatch by device.

This file imports no jax, so it also runs on the GPU host:
``python -m pytest --noconftest tests/test_torch_scene_asset_card.py -q``.
The ``cuda`` tests skip without a card.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.containers.mesh import TriMesh  # noqa: E402
from ipcgen_tpu_torch.ops import _kernels  # noqa: E402
from ipcgen_tpu_torch.ops import scene_asset as sa  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import asset_edge_meshes, synthetic_room  # noqa: E402

KERNEL_KEYS = ("scene_codes", "scene_pack")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the asset kernels have no CPU mode")
    return torch.device("cuda", 0)


def mesh(name):
    if name == "box":
        m = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
        return m.vertices, m.triangles
    if name == "synthetic":
        return synthetic_room(40_000)
    if name == "office3cm":  # the benchmark's room at its cells' 3 cm cut
        from benchmark.rooms import Room, room_rng

        verts, tris = Room.draw(room_rng(3500000037, 0)).recon_mesh(0.03)
        return verts.astype(np.float64), tris
    return asset_edge_meshes()[name]


def assert_same(fields, ref):
    for k in sa._ARRAY_FIELDS:
        got = fields[k].cpu().numpy() if isinstance(fields[k], torch.Tensor) else fields[k]
        assert got.dtype == ref[k].dtype and got.shape == ref[k].shape, k
        assert np.array_equal(got, ref[k], equal_nan=True), k
    for k in ("n_tris", "block_size", "super_factor"):
        assert fields[k] == ref[k], k


def asset_fields(asset):
    out = {k: getattr(asset, k) for k in sa._ARRAY_FIELDS}
    out.update(n_tris=asset.n_tris, block_size=asset.block_size,
               super_factor=asset.super_factor)
    return out


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------


def test_kernel_source_matches_the_module():
    """The source builds without FMA contraction and never with an
    approximate operation; its pad and leaf limit are the module's and the
    wrapper's; both kernels have launch counts."""
    src = (_kernels.CSRC / "scene_asset.cu").read_text()
    assert "-fmad=false" in _kernels.nvcc_command("scene_asset", _kernels.BUILD_DIR / "x.so")
    for fast in ("__fdividef", "__frcp", "fmaf", "__fsqrt_rz", "rsqrtf", "__expf"):
        assert fast not in src, fast
    assert float(re.search(r"kPadCoord = ([0-9e.]+)f;", src).group(1)) == sa._PAD_COORD
    assert "constexpr int kMaxLeaf = 1024;" in src
    for k in KERNEL_KEYS:
        assert _kernels.KERNELS[k][0] == "scene_asset" and k in _kernels.LAUNCHES
        assert f"int {k}_launch(" in src


@pytest.mark.parametrize("name", ["ragged", "equal_centroids", "zero_area"])
@pytest.mark.parametrize("block_size, super_factor", [(1, 2), (3, 5), (100, 3), (1024, 1)])
def test_plain_matches_numpy_any_block(name, block_size, super_factor):
    """The plain version at leaf sizes the cells never use (odd, one,
    the kernel's 1024) and unbucketed."""
    verts, tris = mesh(name)
    for bucket in (True, False):
        ref = sa.build_scene_arrays(verts, tris, block_size, super_factor, bucket=bucket)
        got = sa.scene_arrays_plain(torch.from_numpy(verts.astype(np.float32)),
                                    torch.from_numpy(tris.astype(np.int32)),
                                    block_size, super_factor, bucket=bucket)
        assert_same(got, ref)


def test_cpu_takes_the_plain_version():
    """A CPU build launches nothing and equals the numpy build; the kernel
    wrappers refuse CPU tensors."""
    verts, tris = mesh("ragged")
    before = dict(_kernels.LAUNCHES)
    asset = sa.build_scene_asset(verts, tris, device="cpu")
    assert _kernels.LAUNCHES == before and not sa.builds_on_card("cpu")
    assert_same(asset_fields(asset), sa.build_scene_arrays(verts, tris))
    v = torch.from_numpy(verts.astype(np.float32))
    t = torch.from_numpy(tris)
    with pytest.raises(ValueError):
        _kernels.scene_codes_cuda(v, t, 10)
    with pytest.raises(ValueError):
        _kernels.scene_pack_cuda(v, t, torch.arange(len(t)), torch.zeros(6, dtype=torch.int32),
                                 8, 128, 8)


@pytest.mark.parametrize("bad", ["negative", "past_end", "empty"])
def test_bad_triangles_raise(bad):
    verts, tris = mesh("ragged")
    tris = tris.copy()
    if bad == "negative":
        tris[7, 1] = -1
    elif bad == "past_end":
        tris[-1, 2] = len(verts)
    else:
        tris = tris[:0]
    with pytest.raises(ValueError):
        sa.build_scene_asset(verts, tris, device="cpu")


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

CARD_CASES = [("box", 128, 8), ("box", 8, 2), ("synthetic", 128, 8), ("office3cm", 128, 8),
              ("ragged", 128, 8), ("ragged", 3, 5), ("few_blocks", 128, 8), ("single", 128, 8),
              ("single", 1, 2), ("zero_area", 16, 4), ("equal_centroids", 128, 8),
              ("equal_centroids", 1, 2), ("flat", 128, 8), ("flat", 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, block_size, super_factor", CARD_CASES)
def test_card_build_matches_numpy(cuda_device, name, block_size, super_factor):
    """The kernels' arrays, and the plain version's on the card, are the
    numpy build's; each build launches each kernel once."""
    verts, tris = mesh(name)
    ref = sa.build_scene_arrays(verts, tris, block_size, super_factor)
    before = dict(_kernels.LAUNCHES)
    asset = sa.build_scene_asset(verts, tris, block_size, super_factor, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    for k in KERNEL_KEYS:
        assert _kernels.LAUNCHES[k] == before[k] + 1, k
    assert asset.device == cuda_device
    assert_same(asset_fields(asset), ref)
    plain = sa.scene_arrays_plain(torch.from_numpy(verts.astype(np.float32)).to(cuda_device),
                                  torch.from_numpy(tris.astype(np.int32)).to(cuda_device),
                                  block_size, super_factor)
    assert_same(plain, ref)


@pytest.mark.cuda
def test_card_wrappers_refuse(cuda_device):
    verts, tris = mesh("ragged")
    v = torch.from_numpy(verts.astype(np.float32)).to(cuda_device)
    t = torch.from_numpy(tris).to(cuda_device)
    with pytest.raises(ValueError):
        _kernels.scene_codes_cuda(v, t, 11)
    with pytest.raises(TypeError):
        _kernels.scene_codes_cuda(v.double(), t, 10)
    codes, keys = _kernels.scene_codes_cuda(v, t, 10)
    order = torch.sort(codes, stable=True).indices
    with pytest.raises(ValueError):  # leaf blocks of more than 1024
        _kernels.scene_pack_cuda(v, t, order, keys, 1, 2048, 8)
    with pytest.raises(ValueError):  # too few slots
        _kernels.scene_pack_cuda(v, t, order, keys, 7, 128, 8)


@pytest.mark.cuda
def test_load_scene_builds_on_card(cuda_device, tmp_path):
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    verts, tris = synthetic_room(40_000)
    path = tmp_path / "room.ply"
    TriMesh(verts, tris).save(path)
    sim = S3DISSimulator({}, device=cuda_device)
    before = dict(_kernels.LAUNCHES)
    sim.load_scene(str(path))
    assert sim.rec.profile["asset_device_build"] == 1.0
    assert {"mesh_read", "asset_build"} <= set(sim.rec.profile)
    for k in KERNEL_KEYS:
        assert _kernels.LAUNCHES[k] == before[k] + 1, k
    read = TriMesh.load(path)
    assert_same(asset_fields(sim.scene_asset), sa.build_scene_arrays(read.vertices, read.triangles))
