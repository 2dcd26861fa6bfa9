"""The exact pair prepass and the flat pair walk against the JAX package and
against the capped formulation they replace.

On the CPU the prepass and the walk run their plain versions (the CUDA
kernels have no CPU mode); tests/test_torch_cuda.py holds the kernels to
them on a card.  Tolerances:

- prepass lists: IDENTICAL (integers, the same float32 slab arithmetic):
  the two-level exact prepass against one flat slab test over every block,
  and against JAX ``candidate_blocks`` on every tile its caps do not
  overflow; the overflow predicate derived from (groups, union) against the
  overflow flags of the capped prepass, the port's and JAX's;
- walk on the exact flat list against the capped lists with walk-all
  subtiles: the same slot, t within 1e-6 relative (the same float32
  products over a different set of pairs);
- ``raycast_asset(backend="pairs")`` against JAX ``raycast_asset_mxu`` in
  interpret mode and against the brute oracle: the raycast contract of
  tests/test_tpu_hardware.py:234-258.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops import raycast_mxu as jax_mxu  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_pairs as pairs  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import cluttered_room, synthetic_room  # noqa: E402

from test_torch_cuda import contract, np_res, t_  # noqa: E402


def scene_rays(n: int = 8192, seed: int = 0, room: bool = True):
    """A mesh and ``n`` rays: a quarter from the room's centre, a quarter
    from far outside it, half from random points inside in random
    directions (incoherent).  ``room``: the 9,984-triangle synthetic room
    (6 x 5 x 2.5 m), else the 72-triangle cluttered room (4 x 3 x 2.5 m)."""
    rng = np.random.default_rng(seed)
    if room:
        verts, tris = synthetic_room(10_000, seed=seed)
        size = np.array([6.0, 5.0, 2.5], np.float32)
    else:
        verts, tris = cluttered_room(rng)
        size = np.array([4.0, 3.0, 2.5], np.float32)
    q = n // 4
    origins = np.empty((n, 3), np.float32)
    origins[:q] = size * np.array([0.5, 0.5, 0.45], np.float32)
    origins[q:2 * q] = rng.uniform(-12, -6, (q, 3))
    origins[2 * q:] = rng.uniform(0.05 * size, 0.95 * size, (n - 2 * q, 3))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return verts, tris, origins, dirs


def flat_lists(o, d, block_lo, block_hi, t_max, tile, n_sub):
    """Each subtile's list from one slab test of every ray against every
    block (no groups): (offsets, blocks)."""
    n_tiles = o.shape[0] // tile
    hit = pairs._tile_slab_or(o.view(n_tiles, tile, 3), d.view(n_tiles, tile, 3),
                              block_lo, block_hi, t_max, subtiles=n_sub)
    hit = hit.reshape(n_tiles * n_sub, -1)  # (S, NB), subtiles in ray order
    nz = hit.nonzero()
    offsets = torch.zeros(hit.shape[0] + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(hit.sum(dim=1), 0).to(torch.int32)
    return offsets, nz[:, 1].to(torch.int32)


CASES = [(8, 2048, 8), (16, 2048, 4), (32, 1024, 2), (128, 1024, 1)]


@pytest.mark.parametrize("block_size,tile,group", CASES)
def test_exact_prepass_equals_flat_slab_lists(block_size, tile, group):
    verts, tris, origins, dirs = scene_rays()
    asset = build_scene_asset(verts, tris, block_size=block_size, super_factor=2,
                              device="cpu")
    o, d = t_(origins), t_(dirs)
    n_sub = tile // 256
    offsets, blocks, groups, union = pairs.exact_prepass(
        o, d, asset.block_lo, asset.block_hi, t_max=20.0, group=group, tile=tile,
        n_sub=n_sub)
    want_off, want_blk = flat_lists(o, d, asset.block_lo, asset.block_hi, 20.0, tile,
                                    n_sub)
    assert torch.equal(offsets, want_off) and torch.equal(blocks, want_blk)
    assert blocks.numel() > 0
    # Ascending within each subtile; the union and groups per tile.
    counts = (offsets[1:] - offsets[:-1]).long()
    for s in range(counts.numel()):
        lst = blocks[offsets[s]:offsets[s + 1]]
        assert bool((lst[1:] > lst[:-1]).all())
    n_tiles = o.shape[0] // tile
    per_tile = [torch.unique(blocks[offsets[t * n_sub]:offsets[(t + 1) * n_sub]]).numel()
                for t in range(n_tiles)]
    assert union.tolist() == per_tile
    glo, ghi = pairs.group_boxes(asset.block_lo, asset.block_hi, group)
    want_groups = pairs._tile_slab_or(o.view(n_tiles, tile, 3), d.view(n_tiles, tile, 3),
                                      glo, ghi, 20.0).sum(dim=1)
    assert groups.tolist() == want_groups.tolist()
    # Every tile's blocks lie in the groups it crosses.
    assert bool((groups * group >= union).all())


@pytest.mark.parametrize(
    "kw",
    [
        dict(vmax=8, group=4, gmax=3, tile=1024, n_sub=4),
        dict(vmax=8, group=8, gmax=2, tile=2048, n_sub=8),
        dict(vmax=10, group=2, gmax=4, tile=512, n_sub=2),
        dict(vmax=8, group=1, gmax=12, tile=256, n_sub=1),
    ],
)
def test_exact_prepass_matches_jax_on_tiles_its_caps_keep(kw):
    """Per subtile, the exact lists equal JAX ``candidate_blocks``' lists on
    every tile its caps do not overflow, and the predicate derived from
    (groups, union) flags exactly the tiles it overflows (the cluttered room
    at 8 triangles a block: 12 blocks, caps set so that some tiles
    overflow)."""
    verts, tris, origins, dirs = scene_rays(room=False)
    ja = jax_build(verts, tris, block_size=8, super_factor=2)
    pa = build_scene_asset(verts, tris, block_size=8, super_factor=2, device="cpu")
    ids, counts, ovf, masks = map(np.asarray, jax_mxu.candidate_blocks(
        origins, dirs, ja.block_lo, ja.block_hi, t_max=20.0, **kw))
    offsets, blocks, groups, union = pairs.exact_prepass(
        t_(origins), t_(dirs), pa.block_lo, pa.block_hi, t_max=20.0,
        group=kw["group"], tile=kw["tile"], n_sub=kw["n_sub"])
    n_sub = kw["n_sub"]
    gmax = min(kw["gmax"], -(-pa.num_blocks // kw["group"]))
    derived = ((groups > gmax) | (union > kw["vmax"])).numpy()
    np.testing.assert_array_equal(derived, ovf)
    assert 0 < ovf.sum() < len(ovf)  # both kinds of tile are checked
    offsets, blocks = offsets.numpy(), blocks.numpy()
    for t in np.flatnonzero(~ovf):
        live = ids[:counts[t], t]
        bits = masks[:counts[t], t]
        for s in range(n_sub):
            want = live[(bits >> s) & 1 == 1]
            sub = t * n_sub + s
            np.testing.assert_array_equal(blocks[offsets[sub]:offsets[sub + 1]], want)


@pytest.mark.parametrize("sort_rays", [False, True])
def test_overflow_frac_equals_the_capped_prepass(sort_rays):
    """prepare_pairs' overflow flags (derived from the exact prepass) equal
    the capped ``candidate_blocks`` at prepare_pairs' own sizing, and its
    ``overflow_frac`` equals the capped prepass's share."""
    verts, tris, origins, dirs = scene_rays(n=16384, seed=3)
    asset = build_scene_asset(verts, tris, block_size=8, super_factor=2, device="cpu")
    o, d = t_(origins), t_(dirs)
    p = pairs.prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                            t_max=20.0, sort_rays=sort_rays)
    if sort_rays:
        o, d = o[p["order"]], d[p["order"]]
    _, _, ovf, _ = pairs.candidate_blocks(
        o, d, asset.block_lo, asset.block_hi, t_max=20.0, vmax=p["vmax"],
        group=p["group"], gmax=p["gmax"], tile=p["tile"], n_sub=p["tile"] // 256)
    assert torch.equal(p["overflow"], ovf)
    assert pairs.overflow_frac(p) == float(ovf.float().mean())
    assert p["walk_all"] is None


@pytest.mark.parametrize("block_size", [8, 32, 128])
def test_flat_walk_equals_capped_walk_all_formulation(block_size):
    """The walk over the exact flat list gives the (t, slot) of the capped
    formulation (tiles over a small vmax walk every block), ray for ray."""
    verts, tris, origins, dirs = scene_rays()
    asset = build_scene_asset(verts, tris, block_size=block_size, super_factor=2,
                              device="cpu")
    o, d = t_(origins), t_(dirs)
    p = pairs.prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                            t_max=20.0)
    t_new, s_new = pairs.raycast_pairs_plain(p)
    vmax = max(2, asset.num_blocks // 4)
    ids, counts, ovf, masks = pairs.candidate_blocks(
        o, d, asset.block_lo, asset.block_hi, t_max=20.0, vmax=vmax, group=p["group"],
        gmax=p["gmax"], tile=p["tile"], n_sub=p["tile"] // 256)
    assert bool(ovf.any())
    offsets, blocks, walk_all = pairs.subtile_pairs(ids, counts, ovf, masks,
                                                    p["tile"] // 256)
    t_old, s_old = pairs.intersect_pairs(dict(p, offsets=offsets, blocks=blocks,
                                              walk_all=walk_all))
    assert torch.equal(s_new, s_old)
    hit = s_new >= 0
    assert hit.float().mean().item() > 0.5
    rel = ((t_new - t_old).abs() / t_old.abs())[hit]
    assert rel.max().item() <= 1e-6


def test_expand_walk_all_lists_every_block():
    offsets = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    blocks = torch.tensor([1, 4, 2], dtype=torch.int32)
    walk = torch.tensor([0, 1, 0], dtype=torch.int32)
    off, blk = pairs.expand_walk_all(offsets, blocks, walk, 5)
    assert off.tolist() == [0, 2, 7, 8]
    assert blk.tolist() == [1, 4, 0, 1, 2, 3, 4, 2]
    assert off.dtype == blk.dtype == torch.int32
    off, blk = pairs.expand_walk_all(offsets, blocks, torch.zeros(3, dtype=torch.int32), 5)
    assert off is offsets and blk is blocks
    off, blk = pairs.expand_walk_all(torch.zeros(3, dtype=torch.int32),
                                     torch.zeros(0, dtype=torch.int32),
                                     torch.ones(2, dtype=torch.int32), 3)
    assert off.tolist() == [0, 3, 6] and blk.tolist() == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("block_size,sort_rays", [(8, False), (32, True), (128, "auto")])
def test_pairs_backend_contract_vs_jax_mxu_and_oracle(block_size, sort_rays):
    verts, tris, origins, dirs = scene_rays(n=4096, seed=1, room=False)
    ja = jax_build(verts, tris, block_size=block_size)
    pa = build_scene_asset(verts, tris, block_size=block_size, device="cpu")
    jm = jax_mxu.raycast_asset_mxu(origins, dirs, ja, t_max=20.0, interpret=True)
    po = raycast_asset(t_(origins), t_(dirs), pa, backend="brute", t_max=20.0)
    pp = raycast_asset(t_(origins), t_(dirs), pa, backend="pairs", t_max=20.0,
                       sort_rays=sort_rays)
    hp, ip, xp, _ = np_res(pp)
    ho, io, xo, _ = np_res(po)
    contract(hp, np.asarray(jm.hit), ip, np.asarray(jm.tri_id), xp,
             np.asarray(jm.points))
    contract(hp, ho, ip, io, xp, xo)
    assert hp.sum() > 1024
