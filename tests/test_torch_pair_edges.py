"""The pair walk's edge test: closed triangles, and float64 deciding every
side within the float32 rounding band (``ops/raycast_pairs.py``, "The edge
test").

On the CPU the walk runs its plain version (``raycast_pairs_plain``), which
takes the kernel's decisions: the same band, the same float64 sides bit for
bit.  Tolerances:

- shared-edge wall: every ray hits, from either side, with the hit mask of
  the port's oracle and of the JAX package's ``xla`` backend, t within 1e-6
  relative, and the triangle the walk picks holds the ray's point (float64,
  closed, ``reference_f64.closed_mt64``): on an edge both triangles accept
  and the tie rule may pick either;
- graze set: hit mask and triangle equal to the nearest float64 closed
  Moller-Trumbore hit (``reference_f64.nearest_mt64``) on every ray;
- the band: the float32 side of the walk's panels is within ``side_band``
  of the exact side (rational arithmetic, ``reference_f64.exact_side``) on
  random near-edge rays, so wherever its sign differs from the float64
  side's, it lies within it.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from ipcgen_tpu_torch.ops import raycast_pairs as pairs  # noqa: E402
from ipcgen_tpu_torch.ops import reference_f64 as ref  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402


def t_(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Shared edges and vertices
# ---------------------------------------------------------------------------
def wall():
    """A wall at x = 1: a 4 x 4 grid of unit quads over y, z in [0, 4],
    each split on its diagonal y - i = z - j."""
    g = np.arange(5, dtype=np.float32)
    yy, zz = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([np.ones(25, np.float32), yy.ravel(), zz.ravel()], axis=1)
    vid = lambda i, j: i * 5 + j  # noqa: E731
    tris = []
    for i in range(4):
        for j in range(4):
            tris.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            tris.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    return verts, np.asarray(tris, np.int32)


def edge_points():
    """31 points on the diagonals y = z, 31 on the grid line z = 2 and the
    9 inner grid vertices, where 6 triangles meet."""
    k = np.arange(1, 32, dtype=np.float32) / 8
    diag = np.stack([k, k], axis=1)
    line = np.stack([k, np.full_like(k, 2.0)], axis=1)
    g = np.arange(1, 4, dtype=np.float32)
    vert = np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.concatenate([diag, line, vert])


@pytest.mark.parametrize("direction", [+1.0, -1.0])
def test_shared_edges_and_vertices_hit_from_both_sides(direction):
    from ipcgen_tpu.ops.raycast import raycast_asset as jax_raycast_asset
    from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build

    verts, tris = wall()
    yz = edge_points()
    n = len(yz)
    o = np.concatenate([np.full((n, 1), 1.0 - direction, np.float32), yz], axis=1)
    d = np.tile(np.array([[direction, 0, 0]], np.float32), (n, 1))
    results = {}
    for block_size in (4, 8, 32):  # shared edges within a block and across blocks
        asset = build_scene_asset(verts, tris, block_size=block_size, super_factor=2,
                                  device="cpu")
        for backend in ("pairs", "brute"):
            results[backend, block_size] = raycast_asset(t_(o), t_(d), asset,
                                                         backend=backend, t_max=20.0)
    jx = jax_raycast_asset(o, d, jax_build(verts, tris), backend="xla", t_max=20.0)
    j_hit, j_t = np.asarray(jx.hit), np.asarray(jx.t)
    assert j_hit.all()
    for (backend, _), r in results.items():
        hit, t, tri = r.hit.numpy(), r.t.numpy(), r.tri_id.numpy()
        assert hit.all(), (backend, np.flatnonzero(~hit))
        np.testing.assert_array_equal(hit, j_hit)
        np.testing.assert_allclose(t, j_t, rtol=1e-6)
        np.testing.assert_allclose(t, 1.0, rtol=1e-6)
        # The picked triangle holds the ray's point (closed, in float64).
        c = verts[tris[tri]]
        rows = np.concatenate([c[:, 0], c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]], axis=1)
        assert ref.closed_mt64(o, d, rows)[0].all(), backend


def test_a_zero_side_is_inside_from_either_direction():
    """A ray on the edge b -> c of a = (1, 0, 0), b = a + y, c = a + z: its
    float64 side there is exactly 0, which counts as inside whichever way
    the ray runs (den = +1 or -1); the walk hits from both sides."""
    o = t_([[0.0, 0.5, 0.5], [2.0, 0.5, 0.5]])
    d = t_([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    tri9 = t_([[1, 0, 0, 0, 1, 0, 0, 0, 1]] * 2)
    sides = pairs.sides_f64(o, d, tri9)
    assert (sides[:, 1] == 0).all() and (sides[0, [0, 2]] > 0).all() \
        and (sides[1, [0, 2]] < 0).all()
    assert pairs.inside_f64(sides, torch.tensor([1.0, -1.0])).tolist() == [True, True]
    assert pairs.inside_f64(sides, torch.tensor([-1.0, 1.0])).tolist() == [False, False]
    nan = sides.clone()
    nan[:, 1] = float("nan")
    assert pairs.inside_f64(nan, torch.tensor([1.0, -1.0])).tolist() == [False, False]
    verts = np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], np.float32)
    asset = build_scene_asset(verts, np.array([[0, 1, 2]], np.int32), block_size=4,
                              super_factor=1, device="cpu")
    r = raycast_asset(o, d, asset, backend="pairs", t_max=20.0)
    assert r.hit.tolist() == [True, True]


# ---------------------------------------------------------------------------
# Silhouette grazes
# ---------------------------------------------------------------------------
GRAZE_RAYS = 12_000


def graze_scene(seed: int = 0):
    """200 triangles of 2 cm near x = 3, a backdrop at x = 3.5 and a far
    wall at x = -9 that puts the scene centre about 6 m from them."""
    rng = np.random.default_rng(seed)
    n = 200
    centres = np.stack([3.0 + rng.uniform(-0.01, 0.01, n), rng.uniform(-0.8, 0.8, n),
                        rng.uniform(-0.8, 0.8, n)], axis=1)
    ang = rng.uniform(0, 2 * np.pi, n)[:, None] + np.array([0, 2.1, 4.2])[None]
    r = 0.02 / np.sqrt(3)
    small = np.stack([centres[:, None, 0] + rng.uniform(-2e-3, 2e-3, (n, 3)),
                      centres[:, None, 1] + r * np.cos(ang),
                      centres[:, None, 2] + r * np.sin(ang)], axis=2)
    backdrop = np.array([[[3.5, -2, -2], [3.5, 2, -2], [3.5, 2, 2]],
                         [[3.5, -2, -2], [3.5, 2, 2], [3.5, -2, 2]]])
    far = np.array([[[-9, -1, -1], [-9, 1, -1], [-9, 0, 1]]])
    corners = np.concatenate([small, backdrop, far]).astype(np.float32)
    verts = corners.reshape(-1, 3)
    tris = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, tris, n


def graze_rays(verts, tris, n_small, delta, seed):
    """Rays from near the origin to a point ``delta`` inside an edge of a
    small triangle (towards its third corner, in its plane)."""
    rng = np.random.default_rng(seed)
    c = verts[tris[:n_small]].astype(np.float64)
    k = rng.integers(0, n_small, GRAZE_RAYS)
    e = rng.integers(0, 3, GRAZE_RAYS)
    p, q, w = c[k, e], c[k, (e + 1) % 3], c[k, (e + 2) % 3]
    s = rng.uniform(0.1, 0.9, (GRAZE_RAYS, 1))
    on = p + s * (q - p)
    along = (q - p) / np.linalg.norm(q - p, axis=1, keepdims=True)
    inward = (w - p) - np.einsum("ij,ij->i", w - p, along)[:, None] * along
    inward /= np.linalg.norm(inward, axis=1, keepdims=True)
    target = on + delta * inward
    o = rng.uniform(-0.3, 0.3, (GRAZE_RAYS, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("delta_um", [1, 3, 10, 30, 100])
def test_grazes_equal_the_float64_reference(delta_um):
    verts, tris, n_small = graze_scene()
    asset = build_scene_asset(verts, tris, block_size=32, super_factor=2, device="cpu")
    o, d = graze_rays(verts, tris, n_small, delta_um * 1e-6, seed=delta_um)
    r = raycast_asset(t_(o), t_(d), asset, backend="pairs", t_max=20.0, sort_rays=False)
    hit, tri = ref.nearest_mt64(o, d, *ref.asset_rows(asset.tri_data, asset.tri_index))
    assert hit.all()
    np.testing.assert_array_equal(r.hit.numpy(), hit)
    off = np.flatnonzero(r.tri_id.numpy() != tri)
    assert off.size == 0, (off.size, off[:10])
    assert (tri < n_small).mean() > 0.99  # the rays do land on the small triangles


# ---------------------------------------------------------------------------
# The band
# ---------------------------------------------------------------------------
coord = st.floats(-12, 12, allow_nan=False, width=32)


@settings(max_examples=150, deadline=None)
@given(v0=st.tuples(coord, coord, coord), size=st.floats(1e-3, 3.0),
       ea=st.floats(0, 6.3), eb=st.floats(0.3, 2.8), tilt=st.floats(-1.5, 1.5),
       s=st.floats(0.05, 0.95), log_delta=st.floats(-10, -1), sign=st.sampled_from([-1, 1]),
       origin=st.tuples(coord, coord, coord), center=st.tuples(coord, coord, coord),
       edge=st.integers(0, 2))
def test_float32_side_lies_within_the_band_of_the_exact_side(v0, size, ea, eb, tilt, s,
                                                             log_delta, sign, origin, center,
                                                             edge):
    """Random triangles, rays through a point within 10^log_delta of one of
    their edges (either side), random scene centres: each float32 side of
    the walk's panels (``build_trif``, ``ray_features``, the plain version's
    matmul) and of a left-to-right float32 sum is within ``side_band`` of
    the exact side, and so where its sign differs from the float64 side's
    (``sides_f64``) it lies within the band."""
    v0 = np.array(v0, np.float64)
    u = np.array([np.cos(tilt) * np.cos(ea), np.cos(tilt) * np.sin(ea), np.sin(tilt)])
    w = np.array([-np.sin(ea), np.cos(ea), 0.0])
    e1 = size * u
    e2 = size * (np.cos(eb) * u + np.sin(eb) * w)
    corners = np.stack([v0, v0 + e1, v0 + e2]).astype(np.float32)
    tri9 = np.concatenate([corners[0], corners[1] - corners[0], corners[2] - corners[0]])
    a, b, c = (tri9[0:3].astype(np.float64), tri9[0:3] + tri9[3:6].astype(np.float64),
               tri9[0:3] + tri9[6:9].astype(np.float64))
    p, q = [(a, b), (b, c), (c, a)][edge]
    w_pt = [c, a, b][edge]
    along = (q - p) / np.linalg.norm(q - p)
    inward = (w_pt - p) - ((w_pt - p) @ along) * along
    inward /= np.linalg.norm(inward)
    target = p + s * (q - p) + sign * 10.0 ** log_delta * inward
    o = np.array(origin, np.float32)
    d64 = target - o
    if np.linalg.norm(d64) < 1e-3:
        return
    d = (d64 / np.linalg.norm(d64)).astype(np.float32)

    tri_data = torch.zeros((1, 16, 1))
    tri_data[0, 0:9, 0] = t_(tri9)
    ctr = t_(center)
    trif = pairs.build_trif(tri_data, ctr)  # (1, 10, 5)
    f = pairs.ray_features(t_(o)[None] - ctr, t_(d)[None])
    s32 = (f @ trif[0])[0, :3].numpy()
    # The same products summed left to right in float32, no FMA.
    cols = trif[0, :6, :3].numpy()
    s32_seq = np.zeros(3, np.float32)
    for j in range(6):
        s32_seq = (s32_seq + np.float32(f[0, j]) * cols[j]).astype(np.float32)
    band = pairs.side_band(pairs.block_radius(tri_data, ctr),
                           *pairs.ray_band_terms(f)).item()
    s64 = pairs.sides_f64(t_(o)[None], t_(d)[None], t_(tri9)[None])[0].numpy()
    verts32 = [a, b, c]
    for i, (pp, qq) in enumerate([(0, 1), (1, 2), (2, 0)]):
        exact = ref.exact_side(o, d, verts32[pp], verts32[qq])
        for got in (s32[i], s32_seq[i]):
            assert abs(Fraction(float(got)) - exact) <= Fraction(band), (i, got, exact, band)
            if np.sign(got) != np.sign(s64[i]):
                assert abs(got) <= band
