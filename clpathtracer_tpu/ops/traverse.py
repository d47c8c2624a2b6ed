"""Batched stackless kd-tree traversal — the wavefront reformulation.

The reference walks the rope-linked kd-tree with one divergent scalar loop
per ray (src/kernel.cl:296-422): descend splits by point location, test the
leaf's triangles, hop the exit-face rope. Under XLA this module runs the
SAME algorithm as a *lockstep wavefront* instead: all
rays advance together through masked vector steps inside `lax.while_loop`s,
with per-ray state (current node, query point, best hit) carried as flat
SoA arrays. Every per-ray branch of the reference becomes a `jnp.where`.

Semantics preserved exactly (these are what make images match):
  * root-box gate + entry point p1 = orig + max(tmin,0)*dir
    (src/kernel.cl:311-318),
  * split descent by comparing p1 against the split value, strict `>`
    choosing the hi child (src/kernel.cl:325-330),
  * nearest-hit update rule `!didHit || t <= minHit` — note `<=`: later
    triangles in the leaf list win ties (src/kernel.cl:344-346),
  * early exit when didHit && tmin + 0.001 > minHit (src/kernel.cl:381-383)
    — this is what makes duplicated straddling triangles safe,
  * rope hop via the exit face, advancing p1 to orig + tmax*dir
    (src/kernel.cl:384-388).

The triangle data is pre-packed per leaf (PackedTris): leaf triangle blocks
are contiguous rows, so the inner loop does ONE dense gather per block
instead of the reference's triple indirection
tri_indices[a] → tris[3b+k] → verts[idx] (src/kernel.cl:333-342).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from clpathtracer_tpu.utils import struct

from clpathtracer_tpu.ops.intersect import moller_trumbore, traverse_aabb, hit_aabb

# plain float (weak-typed f32 when used): a jnp scalar here becomes a
# hoisted jaxpr constant, which jax 0.9 mishandles on multi-device meshes
BIG = 3.4e38
# reference early-exit slack (src/kernel.cl:381)
EXIT_EPS = 0.001


@struct.dataclass
class PackedTris:
    """Leaf-contiguous triangle geometry.

    v0/v1/v2: [T, 3] f32 corner positions where T = len(tree.tri_indices);
    row i is triangle tree.tri_indices[i]'s corners (rows for -1 padding
    slots are garbage and masked by `valid`). tri_id: [T] i32 original
    triangle index (-1 padding). Built *inside* jit from scene.verts so
    vertex gradients flow through shading.
    """

    v0: jnp.ndarray
    v1: jnp.ndarray
    v2: jnp.ndarray
    tri_id: jnp.ndarray

    @classmethod
    def pack(cls, tree, v0, v1, v2) -> "PackedTris":
        idx = tree.tri_indices
        safe = jnp.maximum(idx, 0)
        return cls(v0=v0[safe], v1=v1[safe], v2=v2[safe], tri_id=idx)


def traverse(tree, packed: PackedTris, orig: jnp.ndarray, dir: jnp.ndarray,
             tri_block: int = 4, max_iters: int = 4096):
    """Trace a wavefront of rays through the kd-tree.

    orig, dir: [N, 3]. tri_block: triangles intersected per ray per step —
    must match (divide) the tree's leaf padding (`build_kd_tree(...,
    tri_block=...)`); with unpadded trees use tri_block=1.

    Returns dict of [N] arrays: hit (bool), t, tri (original triangle id,
    -1 = miss), u, v. Not differentiated through — callers re-resolve the
    hit differentiably (diff/grad.py) from `tri`.
    """
    n = orig.shape[0]
    invdir = 1.0 / dir
    sign = (invdir < 0).astype(jnp.int32)

    # root gate (src/kernel.cl:311-318)
    root_lo = tree.node_min[0]
    root_hi = tree.node_max[0]
    rhit, rtmin, _, _, _ = hit_aabb(root_lo, root_hi, orig, invdir, sign)
    p = orig + jnp.where(rtmin > 0, rtmin, 0.0)[:, None] * dir

    node = jnp.where(rhit, 0, -1).astype(jnp.int32)
    active = rhit
    best_t = jnp.full((n,), BIG)
    best_slot = jnp.full((n,), -1, jnp.int32)  # row into packed arrays
    offset = jnp.zeros((n,), jnp.int32)        # progress through current leaf
    steps = jnp.zeros((n,), jnp.int32)         # per-ray wavefront iterations
    # (the reference's in-kernel `count` heatmap instrumentation,
    # src/kernel.cl:319-331 — kept as a real output channel here)

    num_tris_packed = packed.tri_id.shape[0]

    def gather_node_f(field, idx):
        return field[jnp.maximum(idx, 0)]

    def descend(state):
        """Inner loop: push every active ray down to a leaf
        (src/kernel.cl:325-330). Bounded by tree depth."""
        node, p, active = state

        def cond(s):
            nd, _, act = s
            at_split = act & ~gather_node_f(tree.is_leaf, nd)
            return jnp.any(at_split)

        def body(s):
            nd, pp, act = s
            at_split = act & ~gather_node_f(tree.is_leaf, nd)
            axis = gather_node_f(tree.split_axis, nd)
            value = gather_node_f(tree.split_value, nd)
            pax = jnp.take_along_axis(pp, axis[:, None], axis=1)[:, 0]
            go_hi = pax > value
            child = jnp.where(go_hi, gather_node_f(tree.child_hi, nd),
                              gather_node_f(tree.child_lo, nd))
            nd = jnp.where(at_split, child, nd)
            return nd, pp, act

        return jax.lax.while_loop(cond, body, (node, p, active))

    node, p, active = descend((node, p, active))

    def cond_fn(state):
        _, _, active, *_rest, it = state
        return jnp.any(active) & (it < max_iters)

    def body_fn(state):
        node, p, active, best_t, best_slot, offset, steps, it = state
        steps = steps + active.astype(jnp.int32)
        nd_safe = jnp.maximum(node, 0)

        # --- leaf triangle block test (src/kernel.cl:332-369) ---
        start = tree.leaf_start[nd_safe]
        count = tree.leaf_count[nd_safe]
        rows = start[:, None] + offset[:, None] + jnp.arange(tri_block, dtype=jnp.int32)[None, :]
        in_leaf = (offset[:, None] + jnp.arange(tri_block, dtype=jnp.int32)[None, :]) < count[:, None]
        rows_safe = jnp.clip(rows, 0, num_tris_packed - 1)
        tv0 = packed.v0[rows_safe]  # [N, B, 3]
        tv1 = packed.v1[rows_safe]
        tv2 = packed.v2[rows_safe]
        tid = packed.tri_id[rows_safe]  # [N, B]
        valid = in_leaf & (tid >= 0) & active[:, None]

        ok, t, u, v = moller_trumbore(tv0, tv1, tv2,
                                      orig[:, None, :], dir[:, None, :])
        ok = ok & valid
        # nearest within the block, reference tie rule `t <= minHit`:
        # later candidates win ties, so scan the block left→right taking <=
        t_m = jnp.where(ok, t, BIG)

        def block_scan(carry, k):
            bt, bs = carry
            tk = t_m[:, k]
            take = ok[:, k] & (tk <= bt)
            bt = jnp.where(take, tk, bt)
            bs = jnp.where(take, rows_safe[:, k], bs)
            return (bt, bs), None

        (best_t, best_slot), _ = jax.lax.scan(
            block_scan, (best_t, best_slot), jnp.arange(tri_block))

        # --- advance within leaf or rope-hop (src/kernel.cl:370-388) ---
        offset_next = offset + tri_block
        leaf_done = offset_next >= count

        lo = tree.node_min[nd_safe]
        hi = tree.node_max[nd_safe]
        tmin, tmax, far = traverse_aabb(lo, hi, orig, invdir, sign)
        did_hit = best_slot >= 0
        early_exit = did_hit & (tmin + EXIT_EPS > best_t)

        rope = tree.ropes[nd_safe, far]
        new_node = jnp.where(early_exit, -1, rope)
        p_new = orig + tmax[:, None] * dir

        hop = active & leaf_done
        node = jnp.where(hop, new_node, node)
        p = jnp.where(hop[:, None], p_new, p)
        offset = jnp.where(hop, 0, offset_next)
        offset = jnp.where(active, offset, 0)
        active = active & jnp.where(hop, new_node >= 0, True)

        # rays that hopped to an interior rope target descend again
        node, p, active = descend((node, p, active))
        return node, p, active, best_t, best_slot, offset, steps, it + 1

    state = (node, p, active, best_t, best_slot, offset, steps, jnp.int32(0))
    _, _, _, best_t, best_slot, _, steps, _ = jax.lax.while_loop(
        cond_fn, body_fn, state)

    hit = best_slot >= 0
    slot_safe = jnp.maximum(best_slot, 0)
    tri = jnp.where(hit, packed.tri_id[slot_safe], -1)

    # recompute u, v, t at the winning triangle (cheaper than carrying them
    # through the loop; also the pattern the differentiable resolve reuses)
    ok, t, u, v = moller_trumbore(
        packed.v0[slot_safe], packed.v1[slot_safe], packed.v2[slot_safe],
        orig, dir)
    return {
        "hit": hit,
        "t": jnp.where(hit, t, BIG),
        "tri": tri.astype(jnp.int32),
        "u": jnp.where(hit, u, 0.0),
        "v": jnp.where(hit, v, 0.0),
        "steps": steps,
    }
