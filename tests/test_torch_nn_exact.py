"""The exact 1-NN: the kernel ``csrc/nn_exact.cu`` against its plain
version (``ops/knn.py nearest_neighbor_plain``), and the dispatch by device.

This file imports no jax, so it also runs on the GPU host:
``python -m pytest --noconftest tests/test_torch_nn_exact.py -q``.  The
``cuda`` tests skip without a card.  Kernel and plain version compute the
same float32 distances, every difference, product and sum rounded on its
own, and both resolve ties to the smallest index: indices must be equal.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.ops import _kernels  # noqa: E402
from ipcgen_tpu_torch.ops.grid_nn import LabelGrid  # noqa: E402
from ipcgen_tpu_torch.ops.knn import (  # noqa: E402
    nearest_neighbor_indices,
    nearest_neighbor_plain,
    nearest_neighbor_tensor,
)
from ipcgen_tpu_torch.utils.profiling import Recorder  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the 1-NN kernel has no CPU mode")
    return torch.device("cuda", 0)


def cloud(n: int, seed: int, step: float = 0.0) -> np.ndarray:
    """``n`` points in a 6 x 5 x 2.5 m box; with ``step`` snapped to a grid of
    that pitch, so that many distances tie exactly."""
    p = np.random.default_rng(seed).uniform([0, 0, 0], [6, 5, 2.5], (n, 3))
    if step:
        p = np.round(p / step) * step
    return p.astype(np.float32)


def tied_case(m_unique: int = 700, copies: int = 3, seed: int = 0):
    """References repeated ``copies`` times, the copies far apart in index
    (so in different splits of the kernel's grid), and queries on references
    and near them: (queries, refs)."""
    base = cloud(m_unique, seed, step=0.25)
    base = np.unique(base, axis=0)
    rng = np.random.default_rng(seed + 1)
    refs = np.concatenate([base[rng.permutation(len(base))] for _ in range(copies)])
    q = np.concatenate([refs[rng.choice(len(refs), 300)],
                        refs[rng.choice(len(refs), 300)] + 0.125,
                        cloud(300, seed + 2, step=0.125)])
    return q, refs


def emulate_kernel(q: torch.Tensor, r: torch.Tensor, chunk: int) -> torch.Tensor:
    """The kernel's merge in torch: each split of ``chunk`` references keeps
    its first-index minimum; the splits merge by the minimum of the 64-bit
    key (float bits of d2 << 32) | index, started at (bits of +inf << 32)."""
    keys = torch.full((q.shape[0],), _kernels._NN_NO_MATCH, dtype=torch.int64)
    for c in range(0, r.shape[0], chunk):
        rc = r[c:c + chunk]
        d2 = (q[:, 0:1] - rc[None, :, 0]) ** 2
        d2 = d2 + (q[:, 1:2] - rc[None, :, 1]) ** 2
        d2 = d2 + (q[:, 2:3] - rc[None, :, 2]) ** 2
        dmin, arg = torch.min(d2, dim=1)
        key = (dmin.view(torch.int32).to(torch.int64) << 32) | (arg + c)
        keys = torch.where(dmin < float("inf"), torch.minimum(keys, key), keys)
    return keys & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the dispatch runs the plain loop: no launch counted, the
    plain version's indices, numpy or tensor in."""
    q, r = cloud(257, 1), cloud(3000, 2)
    before = dict(_kernels.LAUNCHES)
    got = nearest_neighbor_tensor(torch.from_numpy(q), torch.from_numpy(r))
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    want = nearest_neighbor_plain(torch.from_numpy(q), torch.from_numpy(r), 64, 1 << 12)
    assert torch.equal(got, want)
    idx = nearest_neighbor_indices(q, r)
    assert idx.dtype == np.int32 and np.array_equal(idx, want.numpy())
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    assert np.array_equal(idx, d.argmin(1))


def test_empty_queries_and_empty_references():
    r = torch.from_numpy(cloud(10, 3))
    assert nearest_neighbor_tensor(torch.zeros((0, 3)), r).shape == (0,)
    assert nearest_neighbor_indices(np.zeros((0, 3), np.float32), r.numpy()).shape == (0,)
    with pytest.raises(ValueError):
        nearest_neighbor_tensor(r, torch.zeros((0, 3)))


def test_plain_version_takes_the_first_of_tied_references():
    q, r = tied_case()
    got = nearest_neighbor_plain(torch.from_numpy(q), torch.from_numpy(r), 128, 1 << 12)
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    assert np.array_equal(got.numpy(), d.argmin(1))  # numpy's argmin: the first


@pytest.mark.parametrize("chunk", [1024, 2048])
def test_packed_key_merge_keeps_the_smaller_index_on_ties(chunk):
    """The splits' merge by 64-bit key minimum gives the plain version's
    indices where equal distances lie in different splits."""
    q, r = tied_case(m_unique=3000, copies=4)
    assert len(r) > 2 * chunk
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = nearest_neighbor_plain(qt, rt)
    assert torch.equal(emulate_kernel(qt, rt, chunk), want)
    # The queries equal to a reference find its first copy, in the first split.
    on = torch.from_numpy(np.arange(300))
    assert bool((want[on] < len(r) // 4).all())


@pytest.mark.parametrize("n,m", [(1, 1), (31, 1025), (1025, 31), (20_000, 1_300_000),
                                 (48_000, 1_300_000), (500_000, 2_600_000),
                                 (1_300_000, 31)])
def test_schedule_splits_cover_the_references(n, m):
    sms = 132
    chunk, splits = _kernels.nn_exact_schedule(n, m, sms)
    assert chunk % _kernels.NN_REF_TILE == 0 and 1 <= splits <= 65535
    assert (splits - 1) * chunk < m <= splits * chunk  # no split empty
    blocks = -(-n // _kernels.NN_QUERY_TILE) * splits
    r_tiles = -(-m // _kernels.NN_REF_TILE)
    if r_tiles >= _kernels.NN_BLOCKS_PER_SM * sms:
        # Enough reference stages: the grid fills the card for its waves.
        assert blocks >= _kernels.NN_BLOCKS_PER_SM * sms / 2


def test_kernel_source_matches_the_wrapper():
    """The .cu's tiles are the wrapper's; it builds without FMA contraction
    and never with an approximate operation."""
    src = (_kernels.CSRC / "nn_exact.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) * int(consts["kQueriesPerThread"]) == _kernels.NN_QUERY_TILE
    assert int(consts["kRefTile"]) == _kernels.NN_REF_TILE
    assert "-fmad=false" in _kernels.nvcc_command("nn_exact", _kernels.BUILD_DIR / "x.so")
    assert "__fdividef" not in src and "__frcp" not in src and "fmaf" not in src
    assert "nn_exact" in _kernels.LAUNCHES


def test_label_grid_residue_on_its_device_copy():
    """Queries far from the cloud reach the residue, which searches the
    grid's own copy of the references (on the CPU here): every index is the
    plain version's over all references."""
    refs = cloud(40_000, 4)
    rng = np.random.default_rng(5)
    near = refs[rng.choice(len(refs), 3000)] + rng.normal(0, 0.003, (3000, 3))
    far = rng.uniform([-4, -4, -3], [10, 9, 6], (400, 3))
    q = np.concatenate([near, far]).astype(np.float32)
    grid = LabelGrid(refs, device="cpu")
    assert grid.refs_dev.device.type == "cpu" and grid.refs_dev.is_contiguous()
    assert np.array_equal(grid.refs_dev.numpy(), refs)
    rec = Recorder()
    got = grid.query(torch.from_numpy(q), rec=rec)
    assert rec.profile["label_nn_residue_rows"] > 0 and rec.profile["label_nn_residue"] > 0
    want = nearest_neighbor_plain(torch.from_numpy(q), torch.from_numpy(refs))
    assert got.dtype == np.int32 and np.array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def on_card(device, q, r):
    qt = torch.from_numpy(np.ascontiguousarray(q)).to(device)
    rt = torch.from_numpy(np.ascontiguousarray(r)).to(device)
    return qt, rt


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1025])
@pytest.mark.parametrize("m", [1, 31, 1025, 1_300_000])
def test_kernel_matches_plain_on_card_ragged(cuda_device, n, m):
    qt, rt = on_card(cuda_device, cloud(n, n, step=0.01), cloud(m, m + 7, step=0.01))
    before = _kernels.LAUNCHES["nn_exact"]
    got = nearest_neighbor_tensor(qt, rt)
    assert _kernels.LAUNCHES["nn_exact"] == before + 1
    assert got.dtype == torch.int64 and got.device == qt.device
    assert torch.equal(got, nearest_neighbor_plain(qt, rt))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_many_queries(cuda_device):
    qt, rt = on_card(cuda_device, cloud(1_300_000, 8), cloud(31, 9))
    assert torch.equal(nearest_neighbor_tensor(qt, rt), nearest_neighbor_plain(qt, rt))


@pytest.mark.cuda
@pytest.mark.parametrize("copies", [2, 5])
def test_kernel_ties_on_card(cuda_device, copies):
    """Duplicated references and queries equal to references: the first
    copy, as the plain version."""
    q, r = tied_case(m_unique=4000, copies=copies, seed=copies)
    qt, rt = on_card(cuda_device, q, r)
    assert torch.equal(nearest_neighbor_tensor(qt, rt), nearest_neighbor_plain(qt, rt))


@pytest.mark.cuda
def test_kernel_on_card_empty_and_refused(cuda_device):
    r = torch.from_numpy(cloud(64, 10)).to(cuda_device)
    before = _kernels.LAUNCHES["nn_exact"]
    assert nearest_neighbor_tensor(torch.zeros((0, 3), device=cuda_device), r).shape == (0,)
    assert _kernels.LAUNCHES["nn_exact"] == before
    with pytest.raises(ValueError):
        nearest_neighbor_tensor(r, torch.zeros((0, 3), device=cuda_device))
    with pytest.raises(ValueError):  # a CPU tensor never reaches the kernel
        _kernels.nn_exact_cuda(r.cpu(), r.cpu())
    with pytest.raises(TypeError):
        _kernels.nn_exact_cuda(r.double(), r.double())
    with pytest.raises(ValueError):  # 12 bytes past an aligned start
        _kernels.nn_exact_cuda(r, r[1:])
    with pytest.raises(ValueError):
        _kernels.nn_exact_cuda(r[:, :2].contiguous(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 2, 3])
def test_row_slice_of_refs_on_card(cuda_device, start):
    """A row slice of the references starts 12, 24 or 36 bytes past an
    aligned allocation: the dispatch copies it to an aligned one, and the
    indices are the plain version's, into the slice."""
    qt, rt = on_card(cuda_device, cloud(1025, 13), cloud(5000, 14, step=0.01))
    r = rt[start:]
    assert r.data_ptr() % 16
    before = _kernels.LAUNCHES["nn_exact"]
    got = nearest_neighbor_tensor(qt, r)
    assert _kernels.LAUNCHES["nn_exact"] == before + 1
    assert torch.equal(got, nearest_neighbor_plain(qt, r))
    assert np.array_equal(nearest_neighbor_indices(qt, r), got.cpu().numpy())


@pytest.mark.cuda
def test_label_grid_residue_on_card(cuda_device):
    refs = cloud(200_000, 11)
    rng = np.random.default_rng(12)
    q = np.concatenate([refs[rng.choice(len(refs), 20_000)]
                        + rng.normal(0, 0.003, (20_000, 3)),
                        rng.uniform([-4, -4, -3], [10, 9, 6], (3000, 3))]).astype(np.float32)
    grid = LabelGrid(refs, device=cuda_device)
    assert grid.refs_dev.device == cuda_device
    rec = Recorder()
    before = _kernels.LAUNCHES["nn_exact"]
    got = grid.query(torch.from_numpy(q).to(cuda_device), rec=rec)
    assert rec.profile["label_nn_residue_rows"] > 0
    assert _kernels.LAUNCHES["nn_exact"] == before + 1
    qt, rt = on_card(cuda_device, q, refs)
    assert np.array_equal(got, nearest_neighbor_plain(qt, rt).cpu().numpy())
