"""Uniform-grid accelerator (accel/grid.py + ops/grid_walk.py).

The grid must agree with the kd walk (ops/traverse_fast.py, itself
parity-tested against ops/traverse.py and the brute-force oracle) on
hits, t and occlusion booleans across scene types — it is an alternate
accelerator for the same reference traversal semantics
(/root/reference/src/kernel.cl:296-422), not a new intersection rule.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clpathtracer_tpu.accel.grid import build_grid
from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera, cam_matrix, generate_rays
from clpathtracer_tpu.ops.grid_walk import traverse_grid
from clpathtracer_tpu.ops.traverse_fast import pack_quads, traverse_fast
from clpathtracer_tpu.scene.procedural import (
    cornell_box, icosphere, random_tri_soup, terrain_mesh)


def _tv(scene):
    v0, v1, v2 = scene.tri_verts()
    return np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)


def _rays(w, h, pos, fwd=(0.0, 0.0, 1.0)):
    cam = Camera.create(position=list(pos), forward=list(fwd))
    return generate_rays(cam_matrix(cam, h), w, h)


def _kd_rec(tv, orig, dir, **kw):
    tree = build_kd_tree(tv, tri_block=4)
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    quads = pack_quads(tree.tri_indices, jnp.asarray(v0), jnp.asarray(v1),
                       jnp.asarray(v2))
    return jax.jit(lambda o, d: traverse_fast(tree, quads, o, d, **kw))(
        orig, dir)


class TestBuild:
    def test_every_tri_in_its_cells(self):
        """Each triangle appears in every cell its AABB overlaps."""
        scene = random_tri_soup(500, seed=0, extent=2.0, tri_size=0.1)
        tv = _tv(scene)
        g = build_grid(tv, res=(7, 5, 6), layout="split")
        cells = np.asarray(g.cells)
        quads = np.asarray(g.quads).reshape(-1, 16)
        lo, h = np.asarray(g.lo), np.asarray(g.h)
        # reconstruct per-cell member sets
        members = {}
        for cid in range(cells.shape[0]):
            start, cnt = int(cells[cid, 0]) * 4, int(cells[cid, 1])
            ids = quads[start:start + cnt, 9].astype(int)
            members[cid] = set(ids.tolist())
        tmin, tmax = tv.min(1), tv.max(1)
        res = np.asarray(g.res)
        clo = np.clip(np.floor((tmin - lo) / h).astype(int), 0, res - 1)
        chi = np.clip(np.floor((tmax - lo) / h).astype(int), 0, res - 1)
        rng = np.random.default_rng(0)
        for i in rng.choice(tv.shape[0], 60, replace=False):
            for cx in range(clo[i, 0], chi[i, 0] + 1):
                for cy in range(clo[i, 1], chi[i, 1] + 1):
                    for cz in range(clo[i, 2], chi[i, 2] + 1):
                        cid = (cx * res[1] + cy) * res[2] + cz
                        assert i in members[cid], (i, cx, cy, cz)

    def test_counts_and_padding(self):
        scene = icosphere(2)
        g = build_grid(_tv(scene), res=4, layout="split")
        cells = np.asarray(g.cells)
        quads = np.asarray(g.quads).reshape(-1, 16)
        total = int(cells[:, 1].sum())
        real = int((quads[:, 9] >= 0).sum())
        assert total == real
        s = g.stats()
        assert s["cells"] == 64 and s["entries"] == total

    def test_default_resolution_scales(self):
        tv = _tv(random_tri_soup(4000, seed=1, extent=2.0, tri_size=0.02))
        g = build_grid(tv)
        assert np.prod(g.res) >= 1000  # ~1 tri/cell heuristic
        g2 = build_grid(tv, density=8.0)
        assert np.prod(g2.res) < np.prod(g.res)


@pytest.mark.parametrize("layout", ["split", "inline"])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("make,pos", [
    (lambda: cornell_box(light=False), (0.0, 0.0, -1.0)),
    (lambda: icosphere(2), (0.0, 0.0, -1.5)),
    (lambda: random_tri_soup(3000, seed=1, extent=2.0, tri_size=0.05),
     (0.0, 0.0, -3.0)),
    # x offset keeps rays off the exact x=0 crack shared by terrain grid
    # lines and SAH split planes — see test_crack_rays_grid_beats_kd_walk
    (lambda: terrain_mesh(2000, seed=0, extent=3.0), (0.013, 6.0, -3.0)),
])
def test_grid_matches_kd_walk(make, pos, compact, layout):
    scene = make()
    tv = _tv(scene)
    fwd = (0.0, -1.0, 0.5) if pos[1] > 2 else (0.0, 0.0, 1.0)
    orig, dir = _rays(24, 24, pos, fwd)
    ref = _kd_rec(tv, orig, dir)
    g = build_grid(tv, layout=layout)
    rec = jax.jit(lambda o, d: traverse_grid(g, o, d, compact=compact))(
        orig, dir)
    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(rec["hit"]))
    hit = np.asarray(ref["hit"])
    np.testing.assert_allclose(np.asarray(ref["t"])[hit],
                               np.asarray(rec["t"])[hit],
                               rtol=1e-5, atol=1e-6)
    # winners may differ only at fp-equal t ties; require same tri where
    # the grid's t is strictly unique
    same = np.asarray(ref["tri"]) == np.asarray(rec["tri"])
    diff = hit & ~same
    if diff.any():
        np.testing.assert_allclose(np.asarray(ref["t"])[diff],
                                   np.asarray(rec["t"])[diff],
                                   rtol=1e-6, atol=1e-7)


def test_grid_vs_bruteforce_soup():
    from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
    scene = random_tri_soup(1500, seed=3, extent=2.0, tri_size=0.05)
    tv = _tv(scene)
    orig, dir = _rays(16, 16, (0.0, 0.0, -3.0))
    ref = nearest_hit_bruteforce(scene, orig, dir)
    recs = {}
    for layout in ("split", "inline"):
        g = build_grid(tv, layout=layout)
        rec = traverse_grid(g, orig, dir)
        np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                      np.asarray(rec["hit"]))
        hit = np.asarray(ref["hit"])
        np.testing.assert_allclose(np.asarray(ref["t"])[hit],
                                   np.asarray(rec["t"])[hit],
                                   rtol=1e-5, atol=1e-6)
        recs[layout] = rec
    # the two layouts run identical arithmetic on identical records:
    # bit-equal t and identical winners
    np.testing.assert_array_equal(np.asarray(recs["split"]["t"]),
                                  np.asarray(recs["inline"]["t"]))
    np.testing.assert_array_equal(np.asarray(recs["split"]["tri"]),
                                  np.asarray(recs["inline"]["tri"]))


def test_inline_table_build_invariants():
    """Inline layout: every cell's members reachable via its row chain
    (7 inline + spill rows of 8), counts exact."""
    scene = random_tri_soup(800, seed=2, extent=2.0, tri_size=0.12)
    tv = _tv(scene)
    g = build_grid(tv, res=(5, 4, 6), layout="inline")
    t = np.asarray(g.table)
    C = int(np.prod(g.res))
    recs = t.reshape(-1, 8, 16)
    sg = build_grid(tv, res=(5, 4, 6), layout="split")
    cells = np.asarray(sg.cells)
    quads = np.asarray(sg.quads).reshape(-1, 16)
    for cid in range(C):
        cnt = int(recs[cid, 0, 1])
        assert cnt == int(cells[cid, 1])
        ids = [int(recs[cid, 1 + j, 9]) for j in range(min(cnt, 7))]
        spill = int(recs[cid, 0, 0])
        k = cnt - len(ids)
        r = spill
        while k > 0:
            take = min(k, 8)
            ids += [int(recs[r, j, 9]) for j in range(take)]
            k -= take
            r += 1
        want = sorted(
            int(x) for x in
            quads[int(cells[cid, 0]) * 4:int(cells[cid, 0]) * 4
                  + int(cells[cid, 1]), 9])
        assert sorted(ids) == want, cid


def test_crack_rays_grid_beats_kd_walk():
    """Rays with an exactly-zero direction component sitting exactly on a
    split plane ("crack rays"): their slab distance is 0 * inf = NaN.
    The reference's rope walk (src/kernel.cl:325-330) let the NaN in and
    missed them; the walks now treat that slab as unbounded
    (ops/intersect.py::slab_t). Both the DDA grid walk and the kd walk
    must match the brute-force oracle on them.
    """
    from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
    scene = terrain_mesh(2000, seed=0, extent=3.0)
    tv = _tv(scene)
    orig, dir = _rays(24, 24, (0.0, 6.0, -3.0), (0.0, -1.0, 0.5))
    bf = nearest_hit_bruteforce(scene, orig, dir)
    g = build_grid(tv)
    rec = traverse_grid(g, orig, dir)
    kd = _kd_rec(tv, orig, dir)
    bh = np.asarray(bf["hit"])
    np.testing.assert_array_equal(bh, np.asarray(rec["hit"]))
    np.testing.assert_allclose(np.asarray(bf["t"])[bh],
                               np.asarray(rec["t"])[bh],
                               rtol=1e-5, atol=1e-6)
    # the fixture has crack rays (dir.x == 0 at x=0) that hit...
    crack = bh & (np.asarray(dir)[:, 0] == 0.0)
    assert crack.sum() > 0
    # ...and the kd walk no longer misses them
    np.testing.assert_array_equal(bh, np.asarray(kd["hit"]))
    np.testing.assert_allclose(np.asarray(bf["t"])[bh],
                               np.asarray(kd["t"])[bh], rtol=1e-5)


@pytest.mark.parametrize("layout", ["split", "inline"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_occlusion_parity(any_hit, layout):
    """Distance-bounded occlusion: grid == kd walk booleans, with mixed
    active/dead lanes and per-lane bounds (the NEE shadow-wave shape)."""
    scene = random_tri_soup(4000, seed=5, extent=2.0, tri_size=0.08)
    tv = _tv(scene)
    rng = np.random.default_rng(7)
    n = 512
    o = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    t_max = jnp.asarray(rng.uniform(0.2, 4.0, (n,)).astype(np.float32))
    act = jnp.asarray(rng.uniform(size=n) < 0.7)

    ref = _kd_rec(tv, o, d, t_max=t_max, active=act, any_hit=any_hit)
    g = build_grid(tv, layout=layout)
    rec = traverse_grid(g, o, d, t_max=t_max, active=act, any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(rec["hit"]))
    if not any_hit:
        hit = np.asarray(ref["hit"])
        np.testing.assert_allclose(np.asarray(ref["t"])[hit],
                                   np.asarray(rec["t"])[hit],
                                   rtol=1e-5, atol=1e-6)


def test_edge_rays():
    """Axis-aligned rays (zero direction components), rays that miss the
    grid, and origins inside it."""
    scene = cornell_box(light=False)
    tv = _tv(scene)
    g = build_grid(tv, res=3)
    o = jnp.asarray(np.array([
        [0.0, 0.0, -2.0],   # outside, axis-aligned +z
        [0.0, 0.0, 0.0],    # inside the box
        [10.0, 0.0, 0.0],   # outside, pointing away
        [0.0, -2.5, 0.0],   # below, axis-aligned +y
    ], np.float32))
    d = jnp.asarray(np.array([
        [0.0, 0.0, 1.0],
        [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
    ], np.float32))
    ref = _kd_rec(tv, o, d)
    rec = traverse_grid(g, o, d)
    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(rec["hit"]))
    hit = np.asarray(ref["hit"])
    np.testing.assert_allclose(np.asarray(ref["t"])[hit],
                               np.asarray(rec["t"])[hit], rtol=1e-5,
                               atol=1e-6)


def test_fog_likeness_discriminates():
    """The auto-pick heuristic: volumetric fog scores high, surface
    meshes (terrain heightfield) score low."""
    from clpathtracer_tpu.accel.grid import fog_likeness
    fog = _tv(random_tri_soup(20000, seed=0, extent=3.0, tri_size=0.02))
    surf = _tv(terrain_mesh(20000, seed=0, extent=3.0))
    assert fog_likeness(fog) > 0.5
    assert fog_likeness(surf) < 0.3
