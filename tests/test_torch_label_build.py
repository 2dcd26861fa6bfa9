"""The label prefetch's builds with torch ops (``containers/sim_scene.py``
``_exact_coord_join_tensor``; ``ops/grid_nn.py`` ``_occupancy_counts_tensor``,
``_build_slab_tensor`` and ``LabelGrid``'s card route), each held bit for bit
to the numpy code it replaces on the card: the join's indices and matches,
the cell size ``h0``, both levels' tables, counts and slot ids, and the
indices a grid built either way returns.

This file imports no jax, so it also runs on the GPU host:
``python -m pytest --noconftest tests/test_torch_label_build.py -q``.
The ``cuda`` tests skip without a card.
"""

import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.containers import sim_scene as ss  # noqa: E402
from ipcgen_tpu_torch.ops import grid_nn as gn  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
# (y, z) in 0.1 mm whose terms of the join's hash collide: (x, y, z) and
# (x, -y, -z) hash alike with other coordinates.
COLLIDING_YZ = [(-1213, 1365), (-898, 1438), (-911, 1435), (-747, 1473)]
OFFICE_SEED = 3500000037


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the build's route on the card")
    return torch.device("cuda", 0)


def office_tls(n_points=1_300_000, seed=OFFICE_SEED):
    """The benchmark cells' office: (annotation points, raw points) in
    metres, float64 as the parser reads the millimetre text."""
    from benchmark.rooms import Room, room_rng, scan_room

    rng = room_rng(seed, 0)
    tls = scan_room(Room.draw(rng), rng, n_points, 0.002, 0.005)
    ann = np.vstack([mm for mm, _ in tls.instances.values()]) / 1000.0
    raw = np.vstack([ann, tls.outliers_mm / 1000.0])
    return ann, raw[rng.permutation(len(raw))]


def surface(rng, n):
    """Points on a room's six walls, to the millimetre."""
    size = np.array([6.0, 5.0, 2.5])
    p = rng.uniform(0, 1, (n, 3)) * size
    axis = rng.integers(0, 3, n)
    p[np.arange(n), axis] = rng.integers(0, 2, n) * size[axis]
    return np.round(p, 3)


def cloud(name, rng=None):
    """(M, 3) float32 references."""
    rng = np.random.default_rng(7) if rng is None else rng
    if name == "surface":
        return surface(rng, 30_000).astype(np.float32)
    if name == "cluster":  # 120 tight clusters: p99 over the cap, several shrink rounds
        p = surface(rng, 24_000)
        p[:18_000] = (p[:120].repeat(150, axis=0)
                      + rng.normal(0, 0.003, (18_000, 3)))
        return p.astype(np.float32)
    if name == "flat":  # one z: a zero extent, held at 1e-6
        p = surface(rng, 8_000)
        p[:, 2] = 1.25
        return p.astype(np.float32)
    if name == "volume":
        return rng.uniform(-2, 3, (20_000, 3)).astype(np.float32)
    if name == "duplicates":  # repeated rows: their order in a bucket is the input's
        p = surface(rng, 4_000)
        return np.vstack([p, p[:1_500], p[:300]]).astype(np.float32)
    if name == "tiny":
        return rng.uniform(0, 1, (5, 3)).astype(np.float32)
    if name == "office":
        return np.asarray(office_tls()[0], np.float32)
    raise KeyError(name)


def queries_for(refs, rng):
    """Near-surface, off-surface (level 1) and far (residue) queries."""
    near = refs[rng.choice(len(refs), 3000)] + rng.normal(0, 0.005, (3000, 3))
    off = refs[rng.choice(len(refs), 800)] + rng.normal(0, 0.2, (800, 3))
    far = rng.uniform(-3, 8, (200, 3))
    return np.concatenate([near, off, far]).astype(np.float32)


def join_case(name):
    """(queries, refs), float64 metres."""
    rng = np.random.default_rng(11)
    refs = surface(rng, 6_000)
    if name == "all_matched":
        return refs[rng.permutation(len(refs))[:4_000]], refs
    if name == "some_unmatched":
        q = refs[rng.permutation(len(refs))[:4_000]].copy()
        q[::7] += 0.0007  # off every reference's 0.1 mm grid point
        return q, refs
    if name == "collisions":
        x = np.arange(len(COLLIDING_YZ)) * 0.01 + 0.3
        yz = np.asarray(COLLIDING_YZ, np.float64) / 1e4
        a = np.column_stack([x, yz])
        b = np.column_stack([x, -yz])
        # Both of a pair in the references (a first), one of a pair alone,
        # and queries of every row: b's hash finds a's slot first.
        r = np.vstack([refs[:50], a, refs[50:100], b[:2], refs[100:200]])
        q = np.vstack([b, a, refs[:40], b[::-1]])
        return q, r
    if name == "duplicates":
        r = np.vstack([refs[:500], refs[:200], refs[500:900], refs[100:300]])
        return np.vstack([refs[:900], refs[:100]]), r
    if name == "half_way":  # x * 1e4 exactly k + 0.5: rounds to even
        k = np.arange(-400, 400, dtype=np.float64)
        x = (k + 0.5) / 1e4
        x = x[x * 1e4 == k + 0.5]
        r = np.column_stack([x, x[::-1], np.full(len(x), 0.25)])
        q = np.vstack([r, r + 1e-4])
        return q, np.vstack([r, r[::3] + 2e-4])
    if name == "office":
        return office_tls()
    raise KeyError(name)


def assert_join_equal(queries, refs, device):
    want_idx, want_m = ss._exact_coord_join(queries, refs)
    got_idx, got_m = ss._exact_coord_join_tensor(queries, refs, device)
    assert got_idx.dtype == torch.int64 and got_m.dtype == torch.bool
    assert np.array_equal(got_idx.cpu().numpy(), want_idx)
    assert np.array_equal(got_m.cpu().numpy(), want_m)
    return want_m


def assert_cell_size_equal(refs, cap, device):
    """The same ``h`` by the numpy and the tensor count; returns the
    rounds the rule took."""
    refs_t = torch.from_numpy(refs).to(device)
    lo_t, extent = gn._bounds_tensor(refs_t)
    rounds = []

    def counts_at(h):
        rounds.append(h)
        got = gn._occupancy_counts_tensor(refs_t, lo_t, h)
        assert np.array_equal(got, np.sort(gn._occupancy_counts(refs, refs.min(axis=0), h)))
        return got

    h = gn._shrink_cell_size(extent, len(refs), cap, counts_at)
    assert h == gn._choose_cell_size(refs, cap)
    return rounds


def assert_slab_equal(refs, h, cap, t_bits, device):
    want = gn._build_slab_host(refs, h, cap, t_bits)
    refs_t = torch.from_numpy(refs).to(device)
    lo_t, extent = gn._bounds_tensor(refs_t)
    got = gn._build_slab_tensor(refs_t, lo_t, extent, h, cap, t_bits)
    for k, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        g = np.asarray(g)
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w), k
    return want[1]


def assert_grids_equal(got, want):
    assert got.h0 == want.h0 and got.n_refs == want.n_refs
    assert torch.equal(got.refs_dev.cpu(), want.refs_dev.cpu())
    for a, b in zip(got._lvl, want._lvl):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()), k
            else:
                assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# The CPU: the tensor builds on CPU tensors against the numpy code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["all_matched", "some_unmatched", "collisions",
                                  "duplicates", "half_way"])
def test_join_matches_numpy(name):
    queries, refs = join_case(name)
    matched = assert_join_equal(queries, refs, "cpu")
    if name == "all_matched":
        assert matched.all()
    elif name == "some_unmatched":
        assert 0 < (~matched).sum() < len(matched)
    elif name == "collisions":
        q = np.round(queries * 1e4).astype(np.int64)
        h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)
        n = len(COLLIDING_YZ)
        assert np.array_equal(h[:n], h[n:2 * n])  # the pairs collide
        assert not matched[:n].any() and matched[n:2 * n].all()


@pytest.mark.parametrize("n_queries, n_refs", [(0, 10), (10, 0), (0, 0)])
def test_join_empty(n_queries, n_refs):
    q, r = np.zeros((n_queries, 3)), np.zeros((n_refs, 3))
    assert_join_equal(q, r, "cpu")


@pytest.mark.parametrize("name, cap, min_rounds", [
    ("surface", 24, 1), ("surface", 48, 1), ("cluster", 24, 5), ("flat", 24, 1),
    ("flat", 4, 3), ("volume", 24, 1), ("duplicates", 24, 1), ("duplicates", 4, 6),
    ("tiny", 24, 1), ("surface", 4, 2),
])
def test_cell_size_matches_numpy(name, cap, min_rounds):
    rounds = assert_cell_size_equal(cloud(name), cap, "cpu")
    assert len(rounds) >= min_rounds


@pytest.mark.parametrize("name, cap, t_bits, overflow", [
    ("surface", 24, 16, False), ("surface", 384, 12, False), ("cluster", 24, 14, True),
    ("cluster", 4, 10, True), ("flat", 24, 13, False), ("duplicates", 3, 10, True),
    ("tiny", 24, 10, False), ("volume", 8, 11, True),
])
def test_slab_matches_numpy(name, cap, t_bits, overflow):
    refs = cloud(name)
    h = gn._choose_cell_size(refs, 24)
    counts = assert_slab_equal(refs, h, cap, t_bits, "cpu")
    assert bool((counts > cap).any()) == overflow


@pytest.mark.parametrize("name", ["surface", "cluster", "flat", "duplicates", "tiny"])
def test_grid_from_tensor_matches_host_grid(name, monkeypatch):
    """A grid built with torch ops (the card's route, here on CPU tensors)
    equals the numpy-built one and returns the same indices."""
    refs = cloud(name)
    want = gn.LabelGrid(refs, device="cpu")
    monkeypatch.setattr(gn, "builds_on_card", lambda device: True)
    got = gn.LabelGrid(refs, device="cpu")
    assert got.device_build and not want.device_build
    assert_grids_equal(got, want)
    q = queries_for(refs, np.random.default_rng(3))
    assert np.array_equal(got.query(q), want.query(q))


def test_prefetch_on_the_host_counts_no_device_build():
    """Off the card the prefetch keeps the numpy route: no stream, and the
    scene's counter ``label_device_build`` is 0."""
    pf = ss.LabelPrefetch(str(GOLDEN), "Area_1", "office_1", device="cpu")
    scene = ss.S3DISSimScene("office_1", s3dis_data_root=str(GOLDEN), area="Area_1",
                             room="office_1", label_prefetch=pf, device="cpu")
    assert scene._ensure_label_cache(on_critical_path=False)
    assert pf._stream is None and pf._done is None
    assert scene.profile["label_device_build"] == 0.0
    assert_grids_equal(scene._s3dis_cache["grid"],
                       gn.LabelGrid(np.asarray(pf._data[0], np.float32), device="cpu"))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["all_matched", "some_unmatched", "collisions",
                                  "duplicates", "half_way", "office"])
def test_card_join_matches_numpy(cuda_device, name):
    queries, refs = join_case(name)
    matched = assert_join_equal(queries, refs, cuda_device)
    if name == "office":
        assert matched.all()


@pytest.mark.cuda
@pytest.mark.parametrize("name, cap", [("surface", 24), ("cluster", 24), ("flat", 24),
                                       ("surface", 4), ("office", 24)])
def test_card_cell_size_matches_numpy(cuda_device, name, cap):
    assert_cell_size_equal(cloud(name), cap, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["surface", "cluster", "duplicates", "tiny", "office"])
def test_card_grid_matches_host_grid(cuda_device, name):
    """The card's grid (numpy references, a CUDA device) equals the numpy
    build level for level and returns the same indices."""
    refs = cloud(name)
    want = gn.LabelGrid(refs, device="cpu")
    got = gn.LabelGrid(refs, device=cuda_device)
    assert got.device_build and got.refs_dev.device == cuda_device
    assert_grids_equal(got, want)
    rng = np.random.default_rng(5)
    q = queries_for(refs, rng)
    assert np.array_equal(got.query(torch.from_numpy(q).to(cuda_device)), want.query(q))


@pytest.mark.cuda
def test_card_prefetch_on_its_stream(cuda_device):
    """On the card the prefetch builds on its own stream; ``join`` hands the
    grid over to the caller's stream.  Its data and grid are the host
    prefetch's, and the scene counts ``label_device_build`` 1."""
    host = ss.LabelPrefetch(str(GOLDEN), "Area_1", "office_1", device="cpu")
    pf = ss.LabelPrefetch(str(GOLDEN), "Area_1", "office_1", device=cuda_device)
    scene = ss.S3DISSimScene("office_1", s3dis_data_root=str(GOLDEN), area="Area_1",
                             room="office_1", label_prefetch=pf, device=cuda_device)
    assert scene._ensure_label_cache(on_critical_path=False)
    assert pf._stream is not None and pf._stream != torch.cuda.current_stream(cuda_device)
    assert pf._done is not None and pf._done.query()
    assert scene.profile["label_device_build"] == 1.0
    for got, want in zip(pf._data, host.join()):
        assert np.array_equal(got, want)
    assert_grids_equal(pf.grid, host.grid)
    q = queries_for(np.asarray(host._data[0], np.float32), np.random.default_rng(9))
    assert np.array_equal(pf.grid.query(q), host.grid.query(q))


@pytest.mark.cuda
def test_card_office_build_time(cuda_device):
    """The office's grid and join on the card, timed warm (printed)."""
    ann, raw = office_tls()
    refs = np.asarray(ann, np.float32)
    gn.LabelGrid(refs, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    t0 = time.perf_counter()
    gn.LabelGrid(refs, device=cuda_device)
    ss._exact_coord_join_tensor(ann, raw, cuda_device)
    torch.cuda.synchronize(cuda_device)
    print(f"label build on the card: {(time.perf_counter() - t0) * 1e3:.1f} ms")
