"""Differentiable rendering: detached-topology hit resolution.

The reference has no gradients at all (it's an interactive C/OpenCL viewer);
this module supplies the differentiable-rendering axis the new framework
adds on top of the reference's capability surface (BASELINE north star:
pixel gradients vs finite differences allclose @ 1e-3).

Strategy — "detach the discrete, differentiate the continuous":

* WHICH triangle a ray hits (the traversal's integer output) is a discrete
  function of the scene: piecewise-constant, gradient zero almost
  everywhere. We compute it under `lax.stop_gradient` with the fast
  wavefront kd traversal (ops/traverse.py), whose `lax.while_loop` is not
  reverse-differentiable anyway.
* Given the hit topology (tri id), the hit point/depth/barycentrics are
  SMOOTH functions of ray origin/direction and the triangle's vertex
  positions. We re-resolve them with one differentiable Möller–Trumbore
  per ray against its winning triangle — gradients flow to camera
  parameters (through ray gen) and to `scene.verts` / normals / materials
  (through shading).

This yields exact interior gradients (correct wherever the hit topology is
locally constant — the standard differentiable-rasterization/path-tracing
decomposition). Visibility-edge gradients (silhouette terms) are a
measure-zero set that finite differences at interior pixels never see; the
FD test harness (tests/test_grad.py) checks interior pixels.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from clpathtracer_tpu.ops.intersect import moller_trumbore, nearest_hit_bruteforce
from clpathtracer_tpu.ops.traverse import PackedTris, traverse

BIG = 3.4e38  # plain float: avoids a hoisted jaxpr constant


def intersect_diff(scene, tree, orig, dir, tri_block: int = 4,
                   max_iters: int = 4096, scene_axis: str = None,
                   coherent: bool = True, active=None,
                   bounce_grid: bool = None):
    """Nearest triangle hit with differentiable t/u/v and detached topology.

    Returns dict(hit [N] bool, tri [N] i32, t [N], u [N], v [N]) where t/u/v
    carry gradients w.r.t. (orig, dir, scene.verts) and hit/tri do not.

    tree may be a parallel.treelet.ShardedTree: topology then comes from the
    (detached) ppermute treelet ring — acceleration data stays sharded over
    `scene_axis` while gradients flow through the replicated verts via the
    same per-winner re-resolve.
    """
    sg = jax.lax.stop_gradient
    if type(tree).__name__ == "ShardedTree":
        from clpathtracer_tpu.parallel.treelet import intersect_ring
        rec = intersect_ring(sg(tree), sg(orig), sg(dir),
                             axis_name=scene_axis, max_iters=max_iters)
        tri = rec["tri"]
        hit = rec["hit"]
    elif tree is not None:
        v0, v1, v2 = scene.tri_verts()
        if tree.node_table is not None and tri_block == 4:
            from clpathtracer_tpu.ops.traverse_fast import (
                pack_quads, traverse_fast)
            if bounce_grid is None:
                # env fallback for direct callers; render paths thread
                # RenderOptions.bounce_grid (resolved at options
                # CONSTRUCTION, so it participates in the jit cache key)
                bounce_grid = os.environ.get(
                    "CLPT_BOUNCE_GRID", "1") == "1"
            if (not coherent and tree.grid is not None and bounce_grid):
                # incoherent bounce wave with a uniform grid attached:
                # same reroute as the primal integrator
                # (render/integrator.py) — topology is detached, so the
                # DDA walk is eligible as the forward intersector; the
                # per-winner re-resolve below restores the gradient path.
                # The grid's baked quads come from build-time verts:
                # detached topology makes that sound (hit *selection* may
                # lag a vertex update by one build, like tree.quads; t/u/v
                # re-resolve from live verts below).
                from clpathtracer_tpu.ops.grid_walk import traverse_grid
                rec = traverse_grid(sg(tree.grid), sg(orig), sg(dir),
                                    max_iters=max_iters, active=active)
            else:
                quads = pack_quads(tree.tri_indices, sg(v0), sg(v1),
                                   sg(v2))
                rec = traverse_fast(tree, quads, sg(orig), sg(dir),
                                    max_iters=max_iters, active=active)
        else:
            packed = PackedTris.pack(tree, sg(v0), sg(v1), sg(v2))
            rec = traverse(tree, packed, sg(orig), sg(dir),
                           tri_block=tri_block, max_iters=max_iters)
        tri = rec["tri"]
        hit = rec["hit"]
    else:
        rec = nearest_hit_bruteforce(
            sg(scene), sg(orig), sg(dir))
        tri = jnp.where(rec["hit"], rec["prim_id"], -1)
        hit = rec["hit"]

    # differentiable re-resolve at the (detached) winning triangle; missed
    # rays resolve against real row-0 geometry (finite values — the guarded
    # inverse-determinant in moller_trumbore keeps everything non-NaN) and
    # are masked out, so no NaN can leak into the backward pass
    v0, v1, v2 = scene.tri_verts()
    safe = jnp.maximum(tri, 0)
    ok, t, u, v = moller_trumbore(v0[safe], v1[safe], v2[safe], orig, dir)
    return {
        "hit": hit,
        "tri": tri,
        "t": jnp.where(hit, t, BIG),
        "u": jnp.where(hit, u, 0.0),
        "v": jnp.where(hit, v, 0.0),
    }
