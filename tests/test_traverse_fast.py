"""traverse_fast must be output-identical to the reference wavefront
traversal (ops/traverse.py) — same hits, same t (bitwise), same tri ids —
on every fixture, with and without wind-down compaction."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera, cam_matrix, generate_rays
from clpathtracer_tpu.ops.traverse import PackedTris, traverse
from clpathtracer_tpu.ops.traverse_fast import pack_quads, traverse_fast
from clpathtracer_tpu.scene.procedural import (
    cornell_box, icosphere, random_tri_soup)


def _fixture(scene, w=32, h=32, pos=(0.0, 0.0, -1.0)):
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    cam = Camera.create(position=list(pos), forward=[0.0, 0.0, 1.0])
    cam_inv = cam_matrix(cam, h)
    orig, dir = generate_rays(cam_inv, w, h)
    return scene, tree, orig, dir, (v0, v1, v2)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("make", [
    lambda: cornell_box(light=False),
    lambda: icosphere(2),
    lambda: random_tri_soup(3000, seed=1, extent=2.0, tri_size=0.05),
])
def test_fast_matches_reference(make, compact):
    scene, tree, orig, dir, (v0, v1, v2) = _fixture(make())
    assert tree.node_table is not None

    packed = PackedTris.pack(tree, v0, v1, v2)
    ref = traverse(tree, packed, orig, dir, tri_block=4)

    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    fast = jax.jit(lambda q, o, d: traverse_fast(
        tree, q, o, d, compact=compact))(quads, orig, dir)

    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(fast["hit"]))
    np.testing.assert_array_equal(np.asarray(ref["tri"]),
                                  np.asarray(fast["tri"]))
    # t/u re-resolves fuse differently (pre-differenced edges) → allow
    # last-ulp wobble, nothing more
    np.testing.assert_allclose(np.asarray(ref["t"]), np.asarray(fast["t"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref["u"]), np.asarray(fast["u"]),
                               rtol=1e-4, atol=1e-5)


def test_soup_vs_bruteforce():
    """Fast traversal agrees with the linear-scan oracle on hit geometry."""
    from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
    scene = random_tri_soup(2000, seed=3, extent=2.0, tri_size=0.05)
    scene, tree, orig, dir, (v0, v1, v2) = _fixture(scene, pos=(0, 0, -4.0))
    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    fast = traverse_fast(tree, quads, orig, dir)
    bf = nearest_hit_bruteforce(scene, orig, dir)
    np.testing.assert_array_equal(np.asarray(fast["hit"]),
                                  np.asarray(bf["hit"]))
    h = np.asarray(fast["hit"])
    np.testing.assert_allclose(np.asarray(fast["t"])[h],
                               np.asarray(bf["t"])[h], rtol=1e-5)


def test_t_max_boundary_exact():
    """A hit at EXACTLY t_max is ignored (docstring: "hits at or beyond it
    are ignored") — regression for the old `<=` acceptance at the bound."""
    scene = cornell_box(light=False)
    scene, tree, orig, dir, (v0, v1, v2) = _fixture(scene, w=8, h=8)
    quads = pack_quads(tree.tri_indices, v0, v1, v2)

    free = traverse_fast(tree, quads, orig, dir)
    t_hit = np.asarray(free["t"])
    hit = np.asarray(free["hit"])
    assert hit.all()

    # bound exactly at each ray's own hit distance: strictly-before means
    # no lane may report a hit
    at = traverse_fast(tree, quads, orig, dir, t_max=jnp.asarray(t_hit))
    assert not np.asarray(at["hit"]).any()

    # nudge the bound one ulp past the hit: every lane hits again
    above = np.nextafter(t_hit, np.inf).astype(np.float32)
    # float32 nextafter can round back; use a small relative bump instead
    above = t_hit * (1 + 1e-5)
    past = traverse_fast(tree, quads, orig, dir, t_max=jnp.asarray(above))
    assert np.asarray(past["hit"]).all()


def test_t_max_survives_winddown_compaction():
    """Per-ray t_max must be permuted along with the rays by the
    geometric wind-down (it used to be a closed-over full-width array,
    shape-erroring — or worse — after the first halving; hit end-to-end
    by path-mode NEE shadow rays at 512^2, bench.py BENCH_NEE=1)."""
    import numpy as np
    from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
    from clpathtracer_tpu.scene.procedural import random_tri_soup

    scene = random_tri_soup(5000, seed=2, extent=4.0, tri_size=0.1)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(a) for a in (v0, v1, v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    cam = Camera.create(position=[0.0, 0.0, -8.0], forward=[0, 0, 1.0])
    orig, dirs = generate_rays(cam_matrix(cam, 128), 128, 128)
    n = orig.shape[0]
    act = jnp.asarray(np.arange(n) % 16 < 5)   # 70% dead -> compacts
    tmax = jnp.asarray(3.0 + 2.0 * (np.arange(n) % 7), jnp.float32)
    a = traverse_fast(tree, quads, orig, dirs, compact=True,
                      t_max=tmax, active=act)
    b = traverse_fast(tree, quads, orig, dirs, compact=False,
                      t_max=tmax, active=act)
    np.testing.assert_array_equal(np.asarray(a["hit"]),
                                  np.asarray(b["hit"]))
    h = np.asarray(a["hit"])
    np.testing.assert_array_equal(np.asarray(a["t"])[h],
                                  np.asarray(b["t"])[h])


@pytest.mark.parametrize("compact", [False, True])
def test_any_hit_occlusion_matches_nearest(compact):
    """any_hit=True must report the exact same occlusion BOOLEAN as the
    nearest-hit walk with the same t_max (only t/tri may differ: any_hit
    stops on the first accepted hit). Mixed occluded/unoccluded lanes,
    dead lanes, and per-lane bounds all exercised."""
    scene = random_tri_soup(4000, seed=5, extent=3.0, tri_size=0.08)
    scene, tree, orig, dir, (v0, v1, v2) = _fixture(scene, pos=(0, 0, -5.0))
    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    n = orig.shape[0]
    rng = np.random.default_rng(0)
    tmax = jnp.asarray(rng.uniform(0.5, 9.0, n).astype(np.float32))
    act = jnp.asarray(rng.uniform(size=n) < 0.8)

    near = traverse_fast(tree, quads, orig, dir, compact=compact,
                         t_max=tmax, active=act)
    anyh = traverse_fast(tree, quads, orig, dir, compact=compact,
                         t_max=tmax, active=act, any_hit=True)
    occ_near = np.asarray(near["hit"])
    occ_any = np.asarray(anyh["hit"])
    assert occ_near.any() and not occ_near.all()  # non-trivial fixture
    np.testing.assert_array_equal(occ_any, occ_near)
    # any reported hit must be a real one strictly below the lane's bound
    h = occ_any
    assert (np.asarray(anyh["t"])[h] < np.asarray(tmax)[h]).all()
    assert (np.asarray(anyh["tri"])[h] >= 0).all()
    # any_hit must do no MORE work than the nearest walk
    assert np.asarray(anyh["steps"]).sum() <= np.asarray(near["steps"]).sum()


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("make", [
    lambda: cornell_box(light=False),
    lambda: icosphere(2),
    lambda: random_tri_soup(3000, seed=1, extent=2.0, tri_size=0.05),
    lambda: random_tri_soup(20000, seed=3, extent=2.0, tri_size=0.03),
])
def test_walk_table_exact_parity(make, compact):
    """The fused one-gather walk table (build_walk_table) is the same
    traversal with a different memory layout: nearest-hit records must
    be BIT-identical (same nodes visited, same tested set, same global
    last-min tie rule, same slot ids), and any_hit occlusion booleans
    exact (t/tri there describe *a* hit and may legally differ — the
    8-record blocks change which hit lands first)."""
    from clpathtracer_tpu.ops.traverse_fast import build_walk_table

    scene, tree, orig, dir, _ = _fixture(make())
    wt = tree.replace(walk128=jnp.asarray(build_walk_table(
        np.asarray(tree.node_table), np.asarray(tree.quads))))
    assert wt.quads is tree.quads

    a = traverse_fast(tree, tree.quads, orig, dir, compact=compact)
    b = traverse_fast(wt, wt.quads, orig, dir, compact=compact)
    for key in ("hit", "t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(a[key]),
                                      np.asarray(b[key]), err_msg=key)
    # the fused layout takes fewer iterations, never more
    assert np.asarray(b["steps"]).sum() <= np.asarray(a["steps"]).sum()

    tmax = np.asarray(a["t"]).copy()
    tmax[~np.asarray(a["hit"])] = 3.0
    tmax = jnp.asarray(tmax * 1.01)
    at = traverse_fast(tree, tree.quads, orig, dir, compact=compact,
                       t_max=tmax, any_hit=True)
    bt = traverse_fast(wt, wt.quads, orig, dir, compact=compact,
                       t_max=tmax, any_hit=True)
    np.testing.assert_array_equal(np.asarray(at["hit"]),
                                  np.asarray(bt["hit"]))

    # nearest with a bound + dead lanes
    act = jnp.asarray(np.arange(orig.shape[0]) % 3 != 0)
    an = traverse_fast(tree, tree.quads, orig, dir, compact=compact,
                       t_max=tmax, active=act)
    bn = traverse_fast(wt, wt.quads, orig, dir, compact=compact,
                       t_max=tmax, active=act)
    for key in ("hit", "t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(an[key]),
                                      np.asarray(bn[key]), err_msg=key)


@pytest.mark.parametrize("env,chunk", [("CLPT_WALK_CHUNK", "1024"),
                                       ("CLPT_WALK_CHUNK", "512"),
                                       ("CLPT_WALK_CHUNK", "2048")])
def test_wave_chunking_parity(monkeypatch, env, chunk):
    """chunk_wave (the chunking of big waves) must be bit-identical to
    the full-width walk, including per-chunk t_max / active slicing,
    SCALAR t_max broadcasting, and any_hit. Production waves are 262k
    lanes; tests force small chunks on a 4096-lane wave so the path
    stays covered."""
    from clpathtracer_tpu.ops.grid_walk import traverse_grid
    from clpathtracer_tpu.accel.grid import build_grid

    scene = random_tri_soup(3000, seed=1, extent=2.0, tri_size=0.05)
    scene, tree, orig, dir, _ = _fixture(scene, w=64, h=64)
    act = jnp.asarray(np.arange(orig.shape[0]) % 5 != 0)
    tmax_v = jnp.full((orig.shape[0],), 2.5)

    def run():
        out = {}
        out["plain"] = traverse_fast(tree, tree.quads, orig, dir)
        out["bound"] = traverse_fast(tree, tree.quads, orig, dir,
                                     t_max=tmax_v, active=act)
        out["scalar"] = traverse_fast(tree, tree.quads, orig, dir,
                                      t_max=jnp.float32(2.5))
        out["anyhit"] = traverse_fast(tree, tree.quads, orig, dir,
                                      t_max=tmax_v, any_hit=True)
        return out

    monkeypatch.setenv(env, "0")
    full = run()
    monkeypatch.setenv(env, chunk)
    ch = run()
    for name in ("plain", "bound", "scalar"):
        for key in ("hit", "t", "tri", "u", "v"):
            np.testing.assert_array_equal(
                np.asarray(full[name][key]), np.asarray(ch[name][key]),
                err_msg=f"{name}/{key}")
    np.testing.assert_array_equal(np.asarray(full["anyhit"]["hit"]),
                                  np.asarray(ch["anyhit"]["hit"]))

    # grid walk shares the helper: same checks on the DDA
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    g = build_grid(tv, density=1.0)
    monkeypatch.setenv("CLPT_GRID_CHUNK", "0")
    a = traverse_grid(g, orig, dir, t_max=jnp.float32(2.5))
    monkeypatch.setenv("CLPT_GRID_CHUNK", chunk)
    b = traverse_grid(g, orig, dir, t_max=jnp.float32(2.5))
    for key in ("hit", "t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(a[key]),
                                      np.asarray(b[key]), err_msg=key)


def _plane_rays(tree, tv, axis, n=256, seed=0):
    """Rays lying exactly in the tree's split planes on `axis`: origin on
    the plane, direction component along `axis` exactly 0."""
    leaf = np.asarray(tree.is_leaf)
    planes = np.unique(np.asarray(tree.split_value)[
        ~leaf & (np.asarray(tree.split_axis) == axis)])
    lo, hi = tv.min((0, 1)), tv.max((0, 1))
    inner = planes[(planes > lo[axis]) & (planes < hi[axis])]
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    o[:, axis] = inner[r.integers(0, inner.size, n)]
    d = r.normal(size=(n, 3))
    d[:, axis] = 0.0
    if axis != 1:
        d[:, 1] = -np.abs(d[:, 1]) - 0.5  # mostly down onto the surface
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    d[:, axis] = 0.0
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("walk", ["fast", "shadow", "reference"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rays_in_split_planes_match_oracle(axis, walk):
    """A ray lying exactly in a split plane has a zero direction
    component, so its slab distance there is 0 * inf = NaN; the walks
    treat the slab as unbounded (ops/intersect.py::slab_t) and must find
    the same hits as the oracle. Regression: such rays used to miss."""
    from chip_smoke import compare_nearest
    from clpathtracer_tpu.accel.sah import attach_shadow_tree
    from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
    from clpathtracer_tpu.scene.procedural import terrain_mesh

    scene = terrain_mesh(20000, seed=1, extent=10.0)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    if walk == "shadow":
        tree = attach_shadow_tree(tree, tv).shadow
    o, d = _plane_rays(tree, tv, axis)
    if walk == "reference":
        rec = traverse(tree, PackedTris.pack(tree, v0, v1, v2), o, d,
                       tri_block=4)
    else:
        rec = traverse_fast(tree, tree.quads, o, d)
    ref = nearest_hit_bruteforce(scene, o, d)
    assert np.asarray(ref["hit"]).sum() > 50
    out = compare_nearest(f"axis {axis} {walk}", rec, ref)
    assert out["mask_mismatch"] == 0
