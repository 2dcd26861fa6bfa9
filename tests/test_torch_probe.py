"""The kernel probe (``ipcgen_tpu_torch/kernel_probe.py``,
``ops/raycast_probe.py``) against the JAX package's ``scripts/kernel_probe.py``
run in interpret mode, on the CPU.

Scene: ``synthetic_room(624)`` (624 triangles) and two 1024-ray tiles of the
patch-ordered dense-32 rays, t_max 25; each case once with the prepass's own
lists and once with tile 1 forced to overflow (it then walks every block).
The JAX probe's fp32 modes get ``build_trif``'s panels cast to float32 (what
they were written for; the bf16 panels do not trace with their fp32 scratch)
and its ``bf16`` mode the bf16 panels.

Tolerances, port vs JAX: the JAX panels are bf16 hi/lo splits (about 2^-16
relative), the port's plain float32, so the same packed slot and the same
hit mask on >= 99.9 % of rays, and t within 1e-4 relative where both hit.
The floor modes compute nothing comparable across the two packages; their
plain versions are checked for shape and type and against the definitions
in ``ops/raycast_probe.py``.
"""

import functools
import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops import raycast_mxu as M  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch import kernel_probe  # noqa: E402
from ipcgen_tpu_torch.ops import _kernels  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_probe as rp  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import patch_ordered_scan_rays, synthetic_room  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
T_MAX = 25.0
SLOT_AGREE = 0.999
T_REL = 1e-4


@pytest.fixture(scope="module")
def jax_probe():
    """``scripts/kernel_probe.py`` with every ``pallas_call`` in interpret
    mode (the script has no switch for it)."""
    sys.path.insert(0, str(REPO / "scripts"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        import kernel_probe as jkp

        yield jkp


@pytest.fixture(scope="module")
def scene():
    verts, tris = synthetic_room(624)
    origins, dirs = patch_ordered_scan_rays(1, r=2048)
    return verts, tris, origins, dirs


def jax_inputs(scene, gmax=48):
    verts, tris, origins, dirs = scene
    asset = jax_build(verts, tris)
    o, d = jnp.asarray(origins), jnp.asarray(dirs)
    center = (jnp.nanmin(asset.block_lo, axis=0) + jnp.nanmax(asset.block_hi, axis=0)) * 0.5
    trif = M.build_trif(asset.tri_data, center)
    ids, counts, ovf, _ = M.candidate_blocks(o, d, asset.block_lo, asset.block_hi,
                                             t_max=T_MAX, vmax=M.VMAX, gmax=gmax)
    f = M.ray_features(o - center, d).reshape(-1, M.TILE, 16)
    return dict(trif=trif, ids=ids, counts=counts, ovf=ovf.astype(jnp.int32), f=f,
                nb=asset.num_blocks)


def port_inputs(scene, gmax=48):
    verts, tris, origins, dirs = scene
    asset = build_scene_asset(verts, tris, device="cpu")
    return rp.prepare_probe(torch.from_numpy(origins), torch.from_numpy(dirs),
                            asset.tri_data, asset.block_lo, asset.block_hi, gmax=gmax)


def force_overflow(j, p, overflow):
    if overflow:
        j["ovf"] = j["ovf"].at[1].set(1)
        p["ovf"] = p["ovf"].clone()
        p["ovf"][1] = 1


def assert_close_to_jax(t_port, s_port, t_jax, s_jax, min_hit=0.9):
    t_port, s_port = t_port.numpy(), s_port.numpy()
    t_jax, s_jax = np.asarray(t_jax), np.asarray(s_jax)
    assert t_port.shape == t_jax.shape
    assert np.mean(s_port == s_jax) >= SLOT_AGREE, np.mean(s_port == s_jax)
    assert np.mean((s_port >= 0) == (s_jax >= 0)) >= SLOT_AGREE
    both = (s_port >= 0) & (s_jax >= 0)
    assert both.mean() > min_hit  # the closed room: most rays hit
    rel = np.abs(t_port[both] - t_jax[both]) / np.abs(t_jax[both])
    assert rel.max() <= T_REL, rel.max()
    np.testing.assert_array_equal(t_port[s_port < 0], T_MAX)  # a miss is t_init


def test_prepass_matches_jax(scene):
    j, p = jax_inputs(scene), port_inputs(scene)
    n = p["ids"].shape[0]
    np.testing.assert_array_equal(p["counts"].numpy(), np.asarray(j["counts"]))
    np.testing.assert_array_equal(p["ovf"].numpy(), np.asarray(j["ovf"]))
    for t, c in enumerate(p["counts"].tolist()):
        np.testing.assert_array_equal(p["ids"][:c, t].numpy(), np.asarray(j["ids"])[:c, t])
    assert n <= rp.VMAX and p["n_tiles"] == 2


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("mode", rp.RESULT_MODES)
def test_call_result_modes_match_jax(jax_probe, scene, mode, overflow):
    j, p = jax_inputs(scene), port_inputs(scene)
    force_overflow(j, p, overflow)
    trif_j = j["trif"] if mode == "bf16" else j["trif"].astype(jnp.float32)
    t_j, s_j = jax_probe.call(j["f"], j["ids"], j["counts"], j["ovf"], trif_j, mode=mode,
                              tb=128, nb=j["nb"], vmax=M.VMAX, t_init=T_MAX)
    trif_p = p["trif_bf16"] if mode == "bf16" else p["trif"]
    t_p, s_p = rp.probe_call(p["f"], p["ids"], p["counts"], p["ovf"], trif_p, mode)
    assert t_p.dtype == torch.float32 and s_p.dtype == torch.int32
    assert_close_to_jax(t_p, s_p, t_j, s_j)


@pytest.mark.parametrize("overflow", [False, True])
def test_grid_matches_jax(jax_probe, scene, overflow):
    cap = 4
    j, p = jax_inputs(scene), port_inputs(scene)
    force_overflow(j, p, overflow)  # grid_call ignores overflow: same result
    ids_t = np.asarray(j["ids"]).T
    counts = np.asarray(j["counts"])
    sel = np.minimum(np.arange(cap)[None, :], np.maximum(counts[:, None] - 1, 0))
    ids_flat_j = np.take_along_axis(ids_t[:, :cap], sel, axis=1).reshape(-1)
    ids_flat, counts_c = rp.grid_ids(p["ids"], p["counts"], cap)
    np.testing.assert_array_equal(ids_flat.numpy(), ids_flat_j)
    np.testing.assert_array_equal(counts_c.numpy(), np.minimum(counts, cap))
    t_j, s_j = jax_probe.grid_call(jnp.asarray(ids_flat_j), jnp.minimum(j["counts"], cap),
                                   j["f"], j["trif"].astype(jnp.float32), tb=128,
                                   t_init=T_MAX, cap=cap)
    t_p, s_p = rp.probe_grid(p["f"], ids_flat, counts_c, p["trif"], cap)
    # Lists cut to 4 of 5 blocks: a third of the rays miss.
    assert_close_to_jax(t_p, s_p, t_j, s_j, min_hit=0.5)


@pytest.mark.parametrize("overflow", [False, True])
def test_flat_matches_jax(jax_probe, scene, overflow):
    j, p = jax_inputs(scene, gmax=96), port_inputs(scene, gmax=96)
    force_overflow(j, p, overflow)
    # The JAX script's host pair list (kernel_probe.py:594-614).
    ids_h, counts_h, ovf_h = (np.asarray(j["ids"]).T, np.asarray(j["counts"]),
                              np.asarray(j["ovf"]))
    pt, pb = [], []
    for t in range(len(counts_h)):
        if ovf_h[t]:
            pt += [t] * j["nb"]
            pb += list(range(j["nb"]))
        else:
            pt += [t] * int(counts_h[t])
            pb += ids_h[t, :counts_h[t]].tolist()
    pair_tiles, pair_blocks = rp.flat_pairs(p["ids"], p["counts"], p["ovf"], p["nb"])
    np.testing.assert_array_equal(pair_tiles.numpy(), pt)
    np.testing.assert_array_equal(pair_blocks.numpy(), pb)
    pairs = len(pt)
    n_steps = -(-pairs // 256) * 256
    pt_pad = np.asarray(pt + [pt[-1]] * (n_steps - pairs) + [-1], np.int32)
    pb_pad = np.asarray(pb + [pb[-1]] * (n_steps - pairs), np.int32)
    f = j["f"]
    f_hi = f.astype(jnp.bfloat16).astype(jnp.float32)
    f_cat = jnp.concatenate([f_hi, f_hi, f - f_hi], axis=2)
    t_j, s_j = jax_probe.flat_call(jnp.asarray(pt_pad), jnp.asarray(pb_pad), f_cat,
                                   j["trif"].astype(jnp.float32), tb=128, t_init=T_MAX,
                                   n_steps=n_steps)
    t_p, s_p = rp.probe_flat(p["f"], pair_tiles, pair_blocks, p["n_tiles"], p["trif"])
    assert_close_to_jax(t_p, s_p, t_j, s_j)


@pytest.mark.parametrize("mode", rp.FLOOR_MODES + ("nodma",))
def test_floor_modes_plain(scene, mode):
    p = port_inputs(scene)
    p["ovf"][1] = 1  # tile 1 walks every block
    t, s = rp.probe_call(p["f"], p["ids"], p["counts"], p["ovf"], p["trif"], mode)
    n = p["n_tiles"] * rp.TILE
    assert t.shape == (n,) and s.shape == (n,)
    assert t.dtype == torch.float32 and s.dtype == torch.int32
    init = np.float32(T_MAX).view(np.int32)
    tb = t.view(torch.int32).numpy()
    pt, pb = [x.numpy() for x in rp.flat_pairs(p["ids"], p["counts"], p["ovf"], p["nb"])]
    trif = p["trif"].numpy()
    r = np.arange(rp.TILE)
    if mode in ("dmaonly", "dmaonly4", "smallcarry4"):
        rows = r // rp.THREADS if mode != "smallcarry4" else np.zeros_like(r)
        for tile in range(p["n_tiles"]):
            vals = trif[pb[pt == tile]][:, rows, r % rp.TB].view(np.int32)
            want = np.minimum(init, vals.min(axis=0))
            np.testing.assert_array_equal(tb[tile * rp.TILE:(tile + 1) * rp.TILE], want)
        assert np.all(s.numpy() == (0 if mode == "smallcarry4" else -1))
    elif mode in ("matmul", "quadfloor"):
        assert np.all(tb <= init)
        # quadfloor is the product floor in another loop shape: the same function.
        other = "quadfloor" if mode == "matmul" else "matmul"
        t2, s2 = rp.probe_call(p["f"], p["ids"], p["counts"], p["ovf"], p["trif"], other)
        assert torch.equal(t.view(torch.int32), t2.view(torch.int32)) and torch.equal(s, s2)
    else:  # nodma: block 0's triangles under the walked blocks' slots
        hit = s.numpy() >= 0
        assert hit.any() and np.all(s.numpy()[hit] % rp.TB < rp.TB)


@pytest.mark.parametrize("k", [2, rp.ITEM_PANELS])
def test_probe_items_cover_each_walk_once(k):
    """The kernel's schedule: every tile's walk (trip 0, k - 1, k, k + 1, an
    overflowed tile, a list longer than vmax) is covered once, in list order,
    by items of 1..k panels; the kernel's binary search finds each item's
    tile past the tiles that have none."""
    nb, vmax = 5 * k, 3 * k
    counts = torch.tensor([0, k - 1, k, k + 1, 2, 4 * k, 0, k + 3], dtype=torch.int32)
    ovf = torch.tensor([0, 0, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    trips = [0, k - 1, k, k + 1, nb, vmax, 0, k + 3]
    assert rp.walk_trips(counts, ovf, nb, vmax).tolist() == trips
    offsets, tiles, starts, stops = rp.probe_items(counts, ovf, nb, k, vmax)
    assert offsets.dtype == torch.int32 and offsets.tolist()[0] == 0
    assert torch.equal(offsets, rp.item_offsets(counts, ovf, nb, vmax, k))
    assert offsets[-1] == len(tiles) == sum(-(-t // k) for t in trips)
    assert torch.all(tiles[1:] >= tiles[:-1])  # a tile's items are consecutive
    n = stops - starts
    assert torch.all((n >= 1) & (n <= k))
    for t, trip in enumerate(trips):
        mine = tiles == t
        assert int(mine.sum()) == offsets[t + 1] - offsets[t]
        walked = [p for a, b in zip(starts[mine].tolist(), stops[mine].tolist())
                  for p in range(a, b)]
        assert walked == list(range(trip))
    found = torch.searchsorted(offsets[:-1], torch.arange(len(tiles), dtype=torch.int32),
                               right=True) - 1
    assert torch.equal(found, tiles)


def merge_items(mode, parts):
    """The kernel's merge of its items' results: a 64-bit minimum of
    (t bits << 32) | slot over hits for the packed modes, int32 minima of t's
    bits (and of the product floors' slot) for the floors."""
    init = int(np.float32(T_MAX).view(np.int32))
    n = parts[0][0].shape[0]
    if mode in rp.PACKED_MODES:
        miss = (init << 32) | 0xFFFFFFFF
        best = torch.full((n,), miss, dtype=torch.int64)
        for t, s in parts:
            packed = (t.view(torch.int32).long() << 32) | s.long()
            best = torch.minimum(best, torch.where(s >= 0, packed, torch.full_like(best, miss)))
        hit = best != miss
        return (torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                            torch.full((n,), T_MAX)),
                torch.where(hit, (best & 0xFFFFFFFF).to(torch.int32),
                            torch.full((n,), -1, dtype=torch.int32)))
    key = torch.full((n,), init, dtype=torch.int32)
    slot = torch.full((n,), {"smallcarry4": 0, "matmul": rp._INT32_MAX,
                             "quadfloor": rp._INT32_MAX}.get(mode, -1), dtype=torch.int32)
    for t, s in parts:
        key = torch.minimum(key, t.view(torch.int32))
        if mode in ("matmul", "quadfloor"):
            slot = torch.minimum(slot, s)
    return key.view(torch.float32), slot


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", rp.MODES)
def test_items_walked_apart_merge_to_the_plain_result(scene, mode, k):
    """Each of the kernel's items walked on its own and merged by the
    kernel's rule gives the whole walk's bits, in every mode (tile 1
    overflowed: it walks every block)."""
    p = port_inputs(scene)
    p["ovf"][1] = 1
    trif = p["trif_bf16"] if mode == "bf16" else p["trif"]
    _, tiles, starts, stops = rp.probe_items(p["counts"], p["ovf"], p["nb"], k,
                                             p["ids"].shape[0])
    assert int((stops - starts).max()) <= k and len(tiles) > p["n_tiles"]
    parts = []
    for tile, a, b in zip(tiles.tolist(), starts.tolist(), stops.tolist()):
        pos = torch.arange(a, b)
        blocks = pos if p["ovf"][tile] else p["ids"][pos, tile].long()
        parts.append(rp._walk_plain(p["f"], p["n_tiles"], torch.full_like(pos, tile),
                                    blocks, trif, mode, T_MAX))
    t, s = merge_items(mode, parts)
    want_t, want_s = rp.probe_call_plain(p["f"], p["ids"], p["counts"], p["ovf"], trif, mode)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(s, want_s)


def test_product_floor_fma_emulation():
    """``_fma`` rounds once: fma(1 + 2^-12, 1 + 2^-12, -1) keeps the 2^-24
    term that a separate multiply would round away."""
    a = torch.tensor([1 + 2.0**-12], dtype=torch.float32)
    assert rp._fma(a, a, torch.tensor([-1.0])).item() == 2.0**-11 + 2.0**-24
    assert (a * a - 1.0).item() == 2.0**-11


def test_entry_point_on_the_cpu(capsys):
    kernel_probe.main(["full", "dmaonly", "grid4", "flat", "--device", "cpu",
                       "--waypoints", "1", "--rays", "2048", "--triangles", "624"])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["device"] == "cpu" and summary["rays"] == 2048
    assert set(summary["results"]) == {"full", "dmaonly", "grid4", "flat"}
    assert all(r["ms"] is None for r in summary["results"].values())
    assert summary["results"]["full"]["hit"] > 0.9
    sched = summary["schedule"]
    assert sched["item_panels"] == rp.ITEM_PANELS
    assert sched["walked_panels"] == summary["results"]["full"]["pairs"]
    assert sched["items"] == 2  # two tiles of 5 panels: one item each


@pytest.mark.parametrize("flag", [["--against", "other=other.cu"], ["--ptxas"]])
def test_build_comparisons_need_the_card(flag):
    with pytest.raises(SystemExit, match="need a CUDA device"):
        kernel_probe.main(["full", "--device", "cpu", *flag])


@pytest.mark.parametrize("name, ok", [
    ("full", True), ("smallcarry4", True), ("flat", True), ("grid", True),
    ("grid32", True), ("grid0", False), ("gridx", False), ("fast", False)])
def test_probe_names(name, ok):
    if ok:
        assert kernel_probe.check_names([name]) == [name]
    else:
        with pytest.raises(ValueError):
            kernel_probe.check_names([name])
    assert kernel_probe.check_names([]) == list(kernel_probe.DEFAULT_NAMES)


def test_cpu_tensors_take_the_plain_versions(scene):
    """CPU tensors never reach a kernel; the kernel wrappers refuse them."""
    p = port_inputs(scene)
    before = dict(_kernels.LAUNCHES)
    rp.probe_call(p["f"], p["ids"], p["counts"], p["ovf"], p["trif"], "full")
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        _kernels.raycast_probe_call_cuda(p["f"], p["ids"], p["counts"], p["ovf"],
                                         p["trif"], "full", T_MAX)
    with pytest.raises(ValueError):
        rp.probe_call(p["f"].to("meta"), p["ids"], p["counts"], p["ovf"], p["trif"], "full")


def test_kernel_source_matches_the_plain_constants():
    """The .cu's mode order, tile, threads and guard bits are the module's."""
    src = (_kernels.CSRC / "raycast_probe.cu").read_text()
    enum = re.search(r"enum Mode \{([^}]*)\}", src).group(1)
    names = [e.strip() for e in enum.replace("\n", " ").split(",") if e.strip()]
    assert [n.lower() for n in names[:len(rp.MODES)]] == ["k" + m for m in rp.MODES]
    assert f"constexpr int kTile = {rp.TILE};" in src
    assert f"constexpr int kThreads = {rp.THREADS};" in src
    assert f"constexpr int kTB = {rp.TB};" in src
    assert f"constexpr int kItemPanels = {rp.ITEM_PANELS};" in src
    assert f"kEpsTBits = 0x{rp.EPS_T_BITS:08X};" in src
    assert f"kEpsDenBits = 0x{rp.EPS_DEN_BITS:08X};" in src
    assert "raycast_probe" in _kernels.SOURCES
    assert {k for k, (s, _) in _kernels.KERNELS.items() if s == "raycast_probe"} == {
        "raycast_probe_call", "raycast_probe_grid", "raycast_probe_flat"}
