"""On-disk acceleration-structure cache + model loading dispatch.

The reference serializes its built kd-tree as raw length-prefixed C structs
to `<model>.kd` next to the OBJ (src/kd_tree.c:239-274) and reloads it by
extension dispatch in LoadModel (src/model.c:147-176, src/kd_tree.c:278-311)
— skipping parse+build entirely. Same idea here, but portable: one `.npz`
of named SoA arrays (the FlatKdTree columns + the scene geometry), mmap-able
and shardable, instead of ABI-dependent packed structs.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np

from clpathtracer_tpu.accel.sah import FlatKdTree, build_kd_tree
from clpathtracer_tpu.scene.scene import Scene

CACHE_SUFFIX = ".kd.npz"  # the reference's "<model>.kd" (src/model.c:22)

_TREE_FIELDS = ("node_min", "node_max", "is_leaf", "split_axis",
                "split_value", "child_lo", "child_hi", "leaf_start",
                "leaf_count", "ropes", "tri_indices", "node_table", "quads")
_SCENE_FIELDS = ("verts", "faces", "normals", "albedo", "emission",
                 "sphere_pos", "sphere_radius", "sphere_albedo",
                 "sphere_emission", "shade_rows")


def save_scene_cache(path: str, scene: Scene, tree: FlatKdTree,
                     build_params: dict = None) -> None:
    """Serialize scene + built tree (reference: src/kd_tree.c:239-274).

    build_params (tri_block/max_depth/leaf_size) are stored alongside so a
    cache hit can be invalidated when the caller asks for a differently
    tuned tree (ADVICE r1: a --leaf-size retune must not silently return
    the stale tree)."""
    arrays = {}
    for f in _TREE_FIELDS:
        val = getattr(tree, f)
        if val is None:  # node_table absent for non-quad trees
            continue
        arrays["tree_" + f] = np.asarray(val)
    for f in _SCENE_FIELDS:
        val = getattr(scene, f)
        if val is None:  # shade_rows is optional
            continue
        arrays["scene_" + f] = np.asarray(val)
    if build_params:
        items = sorted(build_params.items())
        arrays["build_params"] = np.array(
            [f"{k}={v}" for k, v in items], dtype=np.str_)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def cache_build_params(path: str):
    """The build-params record stored in a cache file (None for caches
    written before params were recorded)."""
    with np.load(path) as z:
        if "build_params" not in z:
            return None
        return dict(kv.split("=", 1) for kv in z["build_params"].tolist())


def load_scene_cache(path: str) -> Tuple[Scene, FlatKdTree]:
    """Deserialize (reference: parse_kd, src/kd_tree.c:278-311)."""
    import jax.numpy as jnp

    with np.load(path) as z:
        tree = FlatKdTree(**{f: jnp.asarray(z["tree_" + f])
                             for f in _TREE_FIELDS
                             if "tree_" + f in z})
        scene = Scene(**{f: jnp.asarray(z["scene_" + f])
                         for f in _SCENE_FIELDS
                         if "scene_" + f in z})
    return scene, tree


def _tri_verts_np(scene: Scene) -> np.ndarray:
    v = np.asarray(scene.verts)
    idx = np.asarray(scene.faces)[:, :, 0]
    return v[idx]  # [F, 3, 3]


def load_model(path: str, tri_block: int = 4, max_depth: int = 24,
               leaf_size: int = 4, use_cache: bool = True,
               **material_kwargs) -> Tuple[Scene, FlatKdTree]:
    """Load a model by extension dispatch, building + caching the kd-tree.

    Mirrors LoadModel (src/model.c:147-176): `.obj` → parse, build tree,
    write `<path>.kd.npz`; `.kd.npz` (or any `.npz`) → load the cache
    directly. Unknown extensions raise ValueError listing supported types
    (reference prints them, src/model.c:162-174).
    """
    if path.endswith(".npz"):
        return load_scene_cache(path)
    if path.endswith(".kd"):
        # the reference's own binary cache format (scene/kdformat.py) —
        # import geometry + its exact tree, then rebuild a packed tree for
        # the gather-packed walk
        from clpathtracer_tpu.scene.kdformat import load_reference_kd
        scene, _ref_tree = load_reference_kd(path)
        scene = scene.bake_shading()
        tree = build_kd_tree(_tri_verts_np(scene), max_depth=max_depth,
                             leaf_size=leaf_size, tri_block=tri_block)
        return scene, tree
    if not path.endswith(".obj"):
        raise ValueError(
            f"{path}: unsupported file type; supported: .obj, .kd, "
            f"{CACHE_SUFFIX}")

    params = {"tri_block": tri_block, "max_depth": max_depth,
              "leaf_size": leaf_size}
    cache = path[:-len(".obj")] + CACHE_SUFFIX
    if use_cache and os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(path)):
        # hit only if the tree was built with the same parameters (a
        # param-less record predates this check: rebuild to be safe)
        cached = cache_build_params(cache)
        want = {k: str(v) for k, v in params.items()}
        if cached == want:
            return load_scene_cache(cache)

    scene = Scene.from_obj(path, **material_kwargs).bake_shading()
    tree = build_kd_tree(_tri_verts_np(scene), max_depth=max_depth,
                         leaf_size=leaf_size, tri_block=tri_block)
    if use_cache:
        save_scene_cache(cache, scene, tree, build_params=params)
    return scene, tree


def merge_scenes(scenes: Iterable[Scene]) -> Scene:
    """Concatenate scenes into one (N-mesh support — the reference only ever
    uploads models[0] and silently drops the rest, src/CLState.c:130; this
    framework renders them all)."""
    import jax.numpy as jnp

    scenes = list(scenes)
    assert scenes, "merge_scenes needs at least one scene"
    if len(scenes) == 1:
        return scenes[0]

    verts, faces, normals = [], [], []
    albedo, emission = [], []
    sp, sr, sa, se = [], [], [], []
    v_off = 0
    n_off = 0
    for s in scenes:
        v = np.asarray(s.verts)
        f = np.asarray(s.faces).copy()
        n = np.asarray(s.normals)
        f[:, :, 0] += v_off
        # normal indices: shift only valid (>= 0) entries
        nidx = f[:, :, 1]
        f[:, :, 1] = np.where(nidx >= 0, nidx + n_off, -1)
        verts.append(v); faces.append(f); normals.append(n)
        albedo.append(np.asarray(s.albedo))
        emission.append(np.asarray(s.emission))
        sp.append(np.asarray(s.sphere_pos))
        sr.append(np.asarray(s.sphere_radius))
        sa.append(np.asarray(s.sphere_albedo))
        se.append(np.asarray(s.sphere_emission))
        v_off += v.shape[0]
        n_off += n.shape[0]

    return Scene(
        verts=jnp.asarray(np.concatenate(verts)),
        faces=jnp.asarray(np.concatenate(faces)),
        normals=jnp.asarray(np.concatenate(normals)),
        albedo=jnp.asarray(np.concatenate(albedo)),
        emission=jnp.asarray(np.concatenate(emission)),
        sphere_pos=jnp.asarray(np.concatenate(sp)),
        sphere_radius=jnp.asarray(np.concatenate(sr)),
        sphere_albedo=jnp.asarray(np.concatenate(sa)),
        sphere_emission=jnp.asarray(np.concatenate(se)),
    )


def load_models(paths: Iterable[str], tri_block: int = 4,
                **kwargs) -> Tuple[Scene, FlatKdTree, list]:
    """Load several models into one merged scene + one tree over all of
    them. A model that fails to load is skipped with a warning, not fatal
    (reference behavior, src/game.c:254-256). Returns (scene, tree,
    skipped_paths)."""
    scenes = []
    skipped = []
    for p in paths:
        try:
            s, _ = load_model(p, tri_block=tri_block, **kwargs)
            scenes.append(s)
        except (OSError, ValueError) as e:  # skip-bad-asset
            import sys
            print(f"warning: skipping {p}: {e}", file=sys.stderr)
            skipped.append(p)
    if not scenes:
        raise ValueError("no loadable models")
    if len(scenes) == 1:
        s, t = scenes[0], None
        # rebuild to get a tree consistent with the (single) scene
        t = build_kd_tree(_tri_verts_np(s), tri_block=tri_block)
        return s, t, skipped
    merged = merge_scenes(scenes)
    tree = build_kd_tree(_tri_verts_np(merged), tri_block=tri_block)
    return merged, tree, skipped
