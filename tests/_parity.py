"""Shared fixtures for the oracle-parity tests of the per-ray walks.

Scenes x ray kinds, each compared with the brute-force oracle
(ops/intersect.py::nearest_hit_bruteforce) by chip_smoke's comparison
functions — the same checks the GPU smoke run applies at full size.

Scenes: cornell (with its light), terrain (surface mesh), soup (fog),
empty_leaf (two clusters: the kd tree has empty leaves), spheres_tris
(cornell plus spheres; the walks see its triangles), degenerate
(axis-aligned rays: direction components exactly 0, inverse infinite).

Ray kinds, N = 256 each: pinhole primary, jittered (spp subpixel offsets),
bounce (cosine hemisphere from the primary hits), shadow (from the
primary hits toward points on emitters, t_max just short of them) and
masked (primaries with every third lane dead).
"""

import numpy as np
import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import (
    attach_grid, attach_shadow_tree, build_kd_tree)
from clpathtracer_tpu.core.camera import (
    Camera, cam_matrix, generate_rays, generate_rays_jittered)
from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
from clpathtracer_tpu.render.shading import cosine_sample_hemisphere
from clpathtracer_tpu.scene.procedural import (
    cornell_box, icosphere, random_tri_soup, terrain_mesh)
from clpathtracer_tpu.scene.scene import Scene

SCENES = ("cornell", "terrain", "soup", "empty_leaf", "spheres_tris",
          "degenerate")
KINDS = ("primary", "jittered", "bounce", "shadow", "masked")
SIDE = 16
N = SIDE * SIDE


def _two_clusters():
    a, b = icosphere(1, radius=0.7), icosphere(1, radius=0.7)
    va = np.asarray(a.verts) + np.array([-1.0, 0.0, 2.0], np.float32)
    vb = np.asarray(b.verts) + np.array([1.0, 0.3, 3.0], np.float32)
    fa, fb = np.asarray(a.faces).copy(), np.asarray(b.faces).copy()
    fb[:, :, 0] += va.shape[0]
    fa[:, :, 1:] = -1
    fb[:, :, 1:] = -1
    nf = fa.shape[0] + fb.shape[0]
    emission = np.zeros((nf, 3), np.float32)
    emission[:4] = 4.0
    return Scene.create(np.concatenate([va, vb]),
                        np.concatenate([fa, fb]), emission=emission)


def _make(name):
    """(scene for the walks, camera)."""
    if name in ("cornell", "degenerate"):
        return (cornell_box(light=True),
                Camera.create(position=[0.0, 0.0, -1.0],
                              forward=[0.0, 0.0, 1.0]))
    if name == "spheres_tris":
        # the walks trace triangles; spheres join in intersect_scene
        return (cornell_box(light=True),
                Camera.create(position=[0.1, -0.1, -1.2],
                              forward=[0.0, 0.05, 1.0]))
    if name == "terrain":
        return (terrain_mesh(2000, seed=1, extent=2.0, relief=0.5,
                             emissive_frac=0.02),
                Camera.create(position=[0.1, 3.0, 0.2],
                              forward=[0.05, -1.0, 0.1]))
    if name == "soup":
        return (random_tri_soup(3000, seed=2, extent=1.0, tri_size=0.06,
                                emissive_frac=0.01),
                Camera.create(position=[0.0, 0.0, -3.0],
                              forward=[0.0, 0.0, 1.0]))
    if name == "empty_leaf":
        return (_two_clusters(),
                Camera.create(position=[0.0, 0.1, -1.0],
                              forward=[0.0, 0.0, 1.0]))
    raise KeyError(name)


_CACHE = {}


def scene_setup(name):
    """Cached per process: scene, camera, tri verts, kd tree (leaf 4),
    the same tree with a grid attached and with a shadow tree attached."""
    if name not in _CACHE:
        scene, cam = _make(name)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4, leaf_size=4, max_depth=20)
        _CACHE[name] = {
            "scene": scene, "cam": cam, "tv": tv, "tree": tree,
            "grid": attach_grid(tree, tv).grid,
            "shadow": attach_shadow_tree(tree, tv, leaf_size=8,
                                         max_depth=18).shadow,
        }
    return _CACHE[name]


def oracle(scene, orig, dir):
    return jax.jit(nearest_hit_bruteforce)(scene, orig, dir)


def _primary(setup, name):
    if name == "degenerate":
        # axis-aligned rays from a lattice inside the box
        r = np.random.default_rng(0)
        o = r.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9], size=(N, 3))
        axes = np.concatenate([np.eye(3), -np.eye(3)])
        d = axes[np.arange(N) % 6]
        return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))
    return generate_rays(cam_matrix(setup["cam"], SIDE), SIDE, SIDE)


def _from_hits(setup, orig, dir):
    """Primary oracle hits: (hit, point offset off the surface along the
    face-forward normal, that normal)."""
    scene, tv = setup["scene"], setup["tv"]
    rec = oracle(scene, orig, dir)
    hit = np.asarray(rec["hit"])
    tri = np.where(hit, np.asarray(rec["prim_id"]), 0)
    o, d = np.asarray(orig), np.asarray(dir)
    p = o + np.where(hit, np.asarray(rec["t"]), 0.0)[:, None] * d
    n = np.cross(tv[tri, 1] - tv[tri, 0], tv[tri, 2] - tv[tri, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    n = np.where((n * d).sum(1, keepdims=True) > 0, -n, n)
    return hit, p + 1e-4 * n, n


def make_rays(name, kind, seed=0):
    """(orig [N,3], dir [N,3], t_max [N] or None, active [N] bool)."""
    setup = scene_setup(name)
    orig, dir = _primary(setup, name)
    r = np.random.default_rng(seed)
    active = np.ones(N, bool)
    t_max = None
    if kind == "jittered":
        if name == "degenerate":
            orig = orig + jnp.asarray(r.uniform(-1e-3, 1e-3, (N, 3)),
                                      jnp.float32)
        else:
            jit = jnp.asarray(r.uniform(size=(1, N, 2)), jnp.float32)
            o, d = generate_rays_jittered(cam_matrix(setup["cam"], SIDE),
                                          SIDE, SIDE, jit)
            orig, dir = o[0], d[0]
    elif kind in ("bounce", "shadow"):
        hit, p, n = _from_hits(setup, orig, dir)
        o = np.where(hit[:, None], p, np.asarray(orig))
        if kind == "bounce":
            u = r.uniform(size=(N, 2)).astype(np.float32)
            d = np.asarray(cosine_sample_hemisphere(
                jnp.asarray(n, jnp.float32), jnp.asarray(u[:, 0]),
                jnp.asarray(u[:, 1])))
            d = np.where(hit[:, None], d, np.asarray(dir))
        else:
            tv = setup["tv"]
            lit = np.flatnonzero(
                np.asarray(setup["scene"].emission).max(1) > 0)
            f = lit[r.integers(0, lit.size, N)]
            b = r.dirichlet(np.ones(3), N)
            target = (b[:, :, None] * tv[f]).sum(1)
            to = target - o
            dist = np.linalg.norm(to, axis=1)
            d = to / np.maximum(dist, 1e-12)[:, None]
            t_max = jnp.asarray(np.maximum(dist - 1e-3, 1e-4), jnp.float32)
        orig = jnp.asarray(o, jnp.float32)
        dir = jnp.asarray(d, jnp.float32)
    elif kind == "masked":
        active = np.arange(N) % 3 != 0
    if t_max is None:
        lo, hi = (np.asarray(x) for x in setup["scene"].bounds())
        diag = float(np.linalg.norm(hi - lo))
        t_max = jnp.asarray(r.uniform(0.05, 1.0, N) * diag, jnp.float32)
    return orig, dir, t_max, jnp.asarray(active)


def select(rec, mask):
    return {k: np.asarray(v)[mask] for k, v in rec.items()}
