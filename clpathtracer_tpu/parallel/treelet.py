"""Scene-parallel rendering: treelet-sharded triangles across devices.

For scenes too large to replicate per device, the SURVEY §5 design: shard
PRIMITIVES across the mesh "scene" axis. Triangles are partitioned into
spatially coherent treelets (Morton-order chunks), each shard gets its own
kd-tree, every device traverses its resident rays against its local
treelet, and the per-shard nearest hits are combined with XLA collectives
(min-reduction over the "scene" axis inside shard_map) — in place of the
reference's single-device upload (src/CLState.c:124-202) and of
hand-written reductions.

Combination semantics: global nearest hit = min t over shards; on exact
ties the LOWEST shard index wins (cross-shard tie order is arbitrary since
each triangle lives in exactly one shard — within a shard the reference's
later-wins rule still applies via traverse_fast).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from clpathtracer_tpu.utils import struct
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from clpathtracer_tpu.accel.sah import FlatKdTree, build_kd_tree

BIG = 3.4e38


@struct.dataclass
class ShardedTree:
    """S per-shard kd-trees, stacked and padded to common shapes.

    node_table: [S, M, 24] f32 (ops/traverse_fast.py layout)
    tri_slots:  [S, T] i32 — LOCAL slot → ORIGINAL triangle id (-1 pad)
    quads:      [S, T/4, 64] f32 — per-shard baked quad rows whose tri-id
                field holds ORIGINAL (global) triangle ids, so a shard
                traversal needs no replicated vertex table at all (this is
                what makes the ring memory-scale: each chip holds 1/S of
                the acceleration data AND 1/S of the geometry)
    total_blocks: static S — survives shard_map splitting the leading axis
                to 1, so ring code knows how many rotations a full pass is
    """

    node_table: jnp.ndarray
    tri_slots: jnp.ndarray
    quads: jnp.ndarray = None
    total_blocks: int = struct.field(pytree_node=False, default=0)

    @property
    def num_shards(self) -> int:
        return self.node_table.shape[0]


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort order of points along a 30-bit 3-D Morton curve (spatially
    coherent chunks → compact treelet bounding boxes)."""
    lo = centroids.min(0)
    ext = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.minimum((1024 * (centroids - lo) / ext).astype(np.uint64), 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def build_sharded_tree(tri_verts: np.ndarray, n_shards: int,
                       max_depth: int = 22, leaf_size: int = 4,
                       ) -> ShardedTree:
    """Partition triangles into n_shards Morton chunks and build one
    quad-packed kd-tree per chunk.

    tri_verts: [F, 3, 3] corner positions. Returns a ShardedTree whose
    leading axis is meant to be sharded over the mesh "scene" axis.
    """
    f = tri_verts.shape[0]
    order = morton_order(tri_verts.mean(axis=1))
    chunks = np.array_split(order, n_shards)

    tables, slots = [], []
    for chunk in chunks:
        sub = tri_verts[chunk]
        tree = build_kd_tree(sub, max_depth=max_depth, leaf_size=leaf_size,
                             tri_block=4)
        # local slot ids → original triangle ids
        local = np.asarray(tree.tri_indices)
        orig_ids = np.where(local >= 0, chunk[np.maximum(local, 0)], -1)
        tables.append(np.asarray(tree.node_table))
        slots.append(orig_ids.astype(np.int32))

    m = max(t.shape[0] for t in tables)
    tmax = max(s.shape[0] for s in slots)
    node_table = np.zeros((n_shards, m, 24), np.float32)
    tri_slots = np.full((n_shards, tmax), -1, np.int32)
    quads = np.zeros((n_shards, tmax, 16), np.float32)
    quads[:, :, 9] = -1.0  # tid pad sentinel
    for i, (t, s, chunk) in enumerate(zip(tables, slots, chunks)):
        node_table[i, :t.shape[0]] = t
        tri_slots[i, :s.shape[0]] = s
        # bake quad rows from the chunk's OWN geometry, tri-id field =
        # GLOBAL triangle id (so hit records are globally meaningful and
        # no replicated vertex table is needed during traversal)
        tv = tri_verts[np.maximum(s, 0)].astype(np.float32)  # [Ts, 3, 3]
        q = np.zeros((s.shape[0], 16), np.float32)
        q[:, 0:3] = tv[:, 0]
        q[:, 3:6] = tv[:, 1] - tv[:, 0]
        q[:, 6:9] = tv[:, 2] - tv[:, 0]
        q[:, 9] = s.astype(np.float32)               # global ids; -1 pads
        quads[i, :s.shape[0]] = q
    return ShardedTree(node_table=jnp.asarray(node_table),
                       tri_slots=jnp.asarray(tri_slots),
                       quads=jnp.asarray(quads.reshape(
                           n_shards, tmax // 4, 64)),
                       total_blocks=n_shards)


def _block_shim(table, n_slots):
    """traverse_fast's tree interface for one treelet block: node_table +
    a shape-carrier for the slot count (values unused by the walk)."""
    import types
    return types.SimpleNamespace(
        node_table=table,
        tri_indices=jnp.zeros((n_slots,), jnp.int32))


def intersect_ring(stree: ShardedTree, orig, dir, axis_name: str = None,
                   max_iters: int = 16384, compact: bool = False):
    """Ring-rotation treelet intersection — the SURVEY §5 long-context
    analogue (ring attention with rays as tokens): every chip keeps its
    RESIDENT rays; treelet blocks (node table + baked quads) rotate around
    the mesh "scene" axis with `ppermute`, and the rotation of block s+1 is
    issued BEFORE block s is traversed so XLA's scheduler overlaps the
    collective with local traversal compute. Per-ray running (best_t, tri,
    u, v) takes the place of the online-softmax accumulator; each round
    passes the current best_t as traverse_fast's t_max so later blocks walk
    distance-bounded (cheaper as the image resolves).

    axis_name=None runs the same loop sequentially over stree's S local
    blocks on one device — the reference implementation the distributed
    path must bit-match on hit/t (cross-block exact-t ties resolve by
    arrival order, which depends on the device's ring position; hit and t
    are order-independent).

    Replaces: the reference's whole-scene single-device upload
    (src/CLState.c:124-202) for scenes that don't fit one chip.
    """
    from clpathtracer_tpu.ops.traverse_fast import traverse_fast

    n = orig.shape[0]
    S = stree.total_blocks or stree.node_table.shape[0]
    assert stree.quads is not None, "build_sharded_tree bakes quads now"
    table, quads = stree.node_table, stree.quads
    n_slots = stree.quads.shape[1] * 4

    best = {
        "hit": jnp.zeros((n,), bool),
        "t": jnp.full((n,), BIG),
        "tri": jnp.full((n,), -1, jnp.int32),
        "u": jnp.zeros((n,)),
        "v": jnp.zeros((n,)),
    }
    perm = [(i, (i + 1) % S) for i in range(S)]
    for s in range(S):
        cur_table, cur_quads = table, quads
        if axis_name is not None and s < S - 1:
            # issue the rotation of the NEXT block now — independent of the
            # traversal below, so the transfer can hide under compute
            table = jax.lax.ppermute(table, axis_name, perm)
            quads = jax.lax.ppermute(quads, axis_name, perm)
        blk_t = cur_table[0] if axis_name is not None else cur_table[s]
        blk_q = cur_quads[0] if axis_name is not None else cur_quads[s]
        rec = traverse_fast(_block_shim(blk_t, n_slots),
                            blk_q.reshape(-1, 64), orig, dir,
                            max_iters=max_iters, compact=compact,
                            t_max=best["t"])
        take = rec["hit"]  # strictly closer than best by t_max semantics
        best = {
            "hit": best["hit"] | take,
            "t": jnp.where(take, rec["t"], best["t"]),
            "tri": jnp.where(take, rec["tri"], best["tri"]),
            "u": jnp.where(take, rec["u"], best["u"]),
            "v": jnp.where(take, rec["v"], best["v"]),
        }
    return best


def make_treelet_renderer(opts, mesh: Mesh, n_blocks: int = None):
    """Scene-parallel frame renderer: rays sharded over BOTH mesh axes
    (each device owns N/(R·S) rays), treelet blocks sharded over "scene"
    and ring-rotated during intersection (intersect_ring), materials/verts
    replicated (small next to acceleration+geometry data).

    Returns render(stree, scene, camera, key) -> [H, W, 3].
    """
    import dataclasses

    from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
    from clpathtracer_tpu.render.integrator import render_rays
    from jax import shard_map

    S = mesh.shape["scene"]
    n = opts.width * opts.height
    n_dev = S * mesh.shape["rows"]
    assert n % n_dev == 0, (n, n_dev)
    opts_local = dataclasses.replace(opts, scene_axis="scene")

    def local(stree_blk, scene, key, orig, dir):
        if key is not None:
            shard = (jax.lax.axis_index("rows") * S
                     + jax.lax.axis_index("scene"))
            key = jax.random.fold_in(key, shard)
        return render_rays(scene, stree_blk, orig, dir, opts_local, key)

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P("scene"), P(), P(), P(("rows", "scene"), None),
                  P(("rows", "scene"), None)),
        out_specs=P(("rows", "scene"), None),
    )

    @jax.jit
    def render(stree, scene, camera, key):
        cam_inv = cam_matrix(camera, opts.height)
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        img = sharded(stree, scene, key, orig, dir)
        return img.reshape(opts.height, opts.width, 3)

    return render


def intersect_sharded(stree: ShardedTree, scene, orig, dir, mesh: Mesh,
                      max_iters: int = 16384):
    """Nearest hit of row-sharded rays against the scene-sharded treelets.

    orig/dir: [N, 3] (sharded over "rows" by the caller's jit context or
    committed shardings). Returns the usual hit record ([N] arrays,
    replicated over "scene").
    """
    from clpathtracer_tpu.ops.traverse_fast import traverse_fast
    n_shards = stree.num_shards
    assert n_shards == mesh.shape["scene"], (n_shards, mesh.shape)

    v0, v1, v2 = scene.tri_verts()

    def local(table_blk, slots_blk, v0, v1, v2, o, d):
        # one shard's tree (leading axis length 1 inside shard_map)
        table = table_blk[0]
        slots = slots_blk[0]

        # local FlatKdTree shim: traverse_fast only touches node_table +
        # tri_indices
        class _T:
            node_table = table
            tri_indices = slots

        safe = jnp.maximum(slots, 0)
        a = v0[safe]
        e1 = v1[safe] - a
        e2 = v2[safe] - a
        tid = slots.astype(jnp.float32)[:, None]
        pad = jnp.zeros((slots.shape[0], 6), a.dtype)
        quads = jnp.concatenate([a, e1, e2, tid, pad],
                                axis=1).reshape(-1, 64)

        rec = traverse_fast(_T, quads, o, d, max_iters=max_iters,
                            compact=False)

        t_loc = jnp.where(rec["hit"], rec["t"], BIG)
        t_min = jax.lax.pmin(t_loc, "scene")
        my = jax.lax.axis_index("scene").astype(jnp.int32)
        cand = jnp.where(rec["hit"] & (t_loc == t_min), my, n_shards)
        win = jax.lax.pmin(cand, "scene")
        iswin = (win == my) & rec["hit"] & (t_loc == t_min)

        def pick(x, fill):
            return jax.lax.psum(jnp.where(iswin, x, fill), "scene")

        return {
            "hit": win < n_shards,
            "t": jnp.where(win < n_shards, t_min, BIG),
            "tri": pick(rec["tri"], 0) + jnp.where(win < n_shards, 0, -1),
            "u": pick(rec["u"], 0.0),
            "v": pick(rec["v"], 0.0),
        }

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("scene"), P("scene"), P(), P(), P(),
                  P("rows", None), P("rows", None)),
        out_specs={"hit": P("rows"), "t": P("rows"), "tri": P("rows"),
                   "u": P("rows"), "v": P("rows")},
    )
    return fn(stree.node_table, stree.tri_slots, v0, v1, v2, orig, dir)
