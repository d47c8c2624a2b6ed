"""Gather-packed wavefront kd traversal (the XLA route of every ray kind).

Semantics-identical to ops/traverse.py (same rope-walk as the reference
kernel, src/kernel.cl:296-422 — see that module's docstring for the exact
rules preserved), restructured so each walk step reads whole rows: one
per-lane gather of a wide contiguous row instead of a gather per field.

So all per-node state is packed into ONE 24-wide f32 row and each leaf's
triangles into 64-wide "quad rows" of 4 pre-differenced triangles:

  node_table [M, 24] f32:
    0:3 aabb min | 3:6 aabb max | 6 split_value
    7  flags = axis + 4*is_leaf          (small ints exact in f32)
    8  child_lo | 9 child_hi             (node ids as f32)
    10 quad_start | 11 tri_count         (leaf tri list, quad units/tris)
    12:18 ropes (node ids as f32, -1 = exit) | 18:24 pad

  quad_table [Q, 64] f32: 4 x (v0[3], e1[3], e2[3], tri_id, pad[6])
    e1 = v1 - v0, e2 = v2 - v0 precomputed: Moller-Trumbore starts from
    the edge vectors, saving 6 subtractions per test and 2/9 of the bytes.

One iteration of the fused while_loop advances EVERY ray by one step of
the reference's algorithm — one split descent OR one 4-triangle block test
(+ rope hop) — at a cost of exactly two wide gathers. Rays at splits waste
the quad gather (lanes are lockstep; masked) instead of running a second
control loop.

Node/tri ids ride in f32: exact for ids < 2^24 (guarded at pack time) —
a 16M-node tree is ~40x larger than the 1M-tri bench scene needs.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from clpathtracer_tpu.ops.intersect import hit_aabb, slab_t

BIG = 3.4e38
EXIT_EPS = 0.001  # reference early-exit slack (src/kernel.cl:381)
QBLOCK = 4        # triangles per quad row; leaf lists padded to this


def chunk_wave(trace_fn, env_name, orig, dir, t_max, active):
    """Split a big wave into sequential chunks and concat the records.

    Off by default (knob unset or 0): on an NVIDIA H100 80GB HBM3 at its
    700 W limit, the 512² path frame of the 1M-triangle emissive soup (2
    bounces + NEE, grid attached) took 69.8 / 71.8 ms unchunked against
    174.1 / 176.2 ms in 65536-lane chunks, the four runs alternating in
    one process (bench.py --legs path --wave-chunks 0,65536,65536,0).
    Shared by traverse_fast (CLPT_WALK_CHUNK) and ops/grid_walk.py
    (CLPT_GRID_CHUNK).

    Returns None when chunking doesn't apply (knob 0, small wave, or n
    not divisible — those stay full-width). The env knob is read at
    trace time: flipping it between same-shape jitted calls reuses the
    cached program (results are bit-identical either way; sweep it
    across processes or after jax.clear_caches()). Scalar t_max is
    broadcast before slicing."""
    n = orig.shape[0]
    chunk = int(os.environ.get(env_name, "0"))
    if not (chunk > 0 and n > chunk and n % chunk == 0):
        return None
    tm = (None if t_max is None
          else jnp.broadcast_to(jnp.asarray(t_max), (n,)))
    recs = []
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        recs.append(trace_fn(orig[sl], dir[sl],
                             None if tm is None else tm[sl],
                             None if active is None else active[sl]))
    return {k: jnp.concatenate([r[k] for r in recs]) for k in recs[0]}


def pack_node_table(arrays: dict) -> np.ndarray:
    """Build the [M, 24] node table from the builder's SoA dict (host-side
    numpy, called once by build_kd_tree; stored on FlatKdTree.node_table).
    """
    is_leaf = np.asarray(arrays["is_leaf"])
    leaf_start = np.asarray(arrays["leaf_start"])
    m = len(is_leaf)
    assert m < (1 << 24), f"{m} nodes overflows f32-exact int range"
    assert (leaf_start[is_leaf] % QBLOCK == 0).all(), (
        "leaf tri lists must be padded to tri_block=4 (quad rows)")
    t = np.zeros((m, 24), np.float32)
    t[:, 0:3] = np.asarray(arrays["node_min"], np.float32)
    t[:, 3:6] = np.asarray(arrays["node_max"], np.float32)
    t[:, 6] = np.asarray(arrays["split_value"], np.float32)
    t[:, 7] = (np.asarray(arrays["split_axis"])
               + 4 * is_leaf.astype(np.int32)).astype(np.float32)
    t[:, 8] = np.asarray(arrays["child_lo"], np.float32)
    t[:, 9] = np.asarray(arrays["child_hi"], np.float32)
    t[:, 10] = (leaf_start // QBLOCK).astype(np.float32)
    t[:, 11] = np.asarray(arrays["leaf_count"], np.float32)
    t[:, 12:18] = np.asarray(arrays["ropes"], np.float32)
    return t


def build_walk_table(node_table, quads) -> np.ndarray:
    """Fused walk rows: [N + S, 128] f32 — ONE gather per walk step.

    The rope walk pays TWO row gathers per iteration: a 24-wide node
    row plus a 64-wide quad row. This table
    folds them: row i < N is node i's 24 meta lanes (lane 18 repurposed
    as the node's first SPILL row id) plus, for leaves, the leaf's FIRST
    quad row in lanes 64:128 — so a descent step or a <=4-tri leaf costs
    one gather. Leaves with more triangles continue into contiguous
    SPILL rows (two quad rows = 8 triangle records each), the packing
    of the grid walk's inline layout (accel/grid.py). Quad slot ids are
    preserved exactly (slot = leaf_qstart*4
    + offset + lane), so resolve_slot and all tie rules are unchanged.

    Baked from the BUILD-time quads: traverse_fast only engages it when
    the caller passes tree.quads itself (the differentiable path
    re-packs quads from live vertices and must keep the two-gather
    walk)."""
    tb = np.asarray(node_table, np.float32)
    qd = np.asarray(quads, np.float32)
    n = tb.shape[0]
    flags = tb[:, 7].astype(np.int64)
    is_leaf = flags >= 4
    qstart = tb[:, 10].astype(np.int64)
    count = tb[:, 11].astype(np.int64)
    qrows = np.where(is_leaf, -(-count // QBLOCK), 0)   # quad rows used
    extra = np.maximum(qrows - 1, 0)                    # beyond the first
    srows = -(-extra // 2)                              # spill rows
    spill0 = n + _excl_cumsum_i64(srows)
    total = n + int(srows.sum())
    assert total < (1 << 24), f"{total} walk rows overflow f32-exact ids"
    out = np.zeros((total, 128), np.float32)
    # pad triangle ids first (records r at lane 16r+9): split rows' quad
    # half and odd spill halves must read as dead slots; the meta write
    # below re-covers record 0's lane 9 (child_hi) on node rows
    out[:, 9::16] = -1.0
    out[:n, :24] = tb
    out[:n, 18] = spill0.astype(np.float32)
    has_q = is_leaf & (count > 0)
    out[np.nonzero(has_q)[0], 64:128] = qd[
        np.clip(qstart[has_q], 0, qd.shape[0] - 1)]
    li = np.nonzero(extra > 0)[0]
    if li.size:
        reps = extra[li]
        lid = np.repeat(li, reps)
        k = (np.arange(int(reps.sum()), dtype=np.int64)
             - np.repeat(_excl_cumsum_i64(reps), reps))
        src = np.clip(qstart[lid] + 1 + k, 0, qd.shape[0] - 1)
        dest = spill0[lid] + k // 2
        half = (k % 2).astype(np.int64)
        ov = out.reshape(total, 2, 64)
        ov[dest, half] = qd[src]
    return out


def _excl_cumsum_i64(a):
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def pack_quads(tri_slots: jnp.ndarray, v0, v1, v2) -> jnp.ndarray:
    """Build the [Q, 64] quad rows on device from scene vertices.

    tri_slots: [T] i32 (T % 4 == 0); v0/v1/v2: [F, 3] corner positions.
    Recomputed per frame (cheap: a handful of dense gathers) so vertex
    updates during optimization are honored.
    """
    tcount = tri_slots.shape[0]
    assert tcount % QBLOCK == 0, tcount
    safe = jnp.maximum(tri_slots, 0)
    a = v0[safe]                       # [T, 3]
    e1 = v1[safe] - a
    e2 = v2[safe] - a
    tid = tri_slots.astype(jnp.float32)[:, None]
    pad = jnp.zeros((tcount, 6), a.dtype)
    rows16 = jnp.concatenate([a, e1, e2, tid, pad], axis=1)  # [T, 16]
    return rows16.reshape(tcount // QBLOCK, 64)


def _mt_pre(v0, e1, e2, orig, dir, eps=0.0):
    """Moller-Trumbore from pre-differenced edges; identical arithmetic to
    ops.intersect.moller_trumbore after its first two subtractions."""
    pvec = jnp.cross(dir, e2)
    det = jnp.sum(e1 * pvec, -1)
    ok = det > eps
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tvec = orig - v0
    u = jnp.sum(tvec * pvec, -1) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dir * qvec, -1) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = jnp.sum(e2 * qvec, -1) * inv_det
    ok = ok & (t > 0.0)
    return ok, t, u, v


def traverse_fast(tree, quads: jnp.ndarray, orig, dir,
                  max_iters: int = 16384, compact: bool = True,
                  t_max=None, active=None, any_hit: bool = False):
    """Trace a wavefront through the packed kd-tree.

    tree: FlatKdTree with a `node_table` (built by build_kd_tree with
    tri_block=4). quads: [Q, 64] from pack_quads. Returns the same record
    as ops.traverse.traverse: dict of [N] arrays hit/t/tri/u/v/steps.

    `compact=True` adds geometric wind-down: when at most half the rays
    remain active the wavefront is permuted and halved, so stragglers don't
    drag full-width iterations along (mean steps/ray is typically 3x below
    max).

    t_max: optional [N] per-ray distance bound — hits at or beyond it are
    ignored AND the walk early-exits once every reachable node lies beyond
    it. The cheap occlusion/shadow-ray query: pass the light distance and
    read `hit`.

    active: optional [N] bool — dead lanes never enter the walk (they
    start inactive and report no hit). With wind-down compaction they fold
    out on the first round, so a mostly-dead wavefront costs a fraction of
    a full one.

    any_hit=True (requires t_max): occlusion-query semantics — a lane
    stops on the FIRST accepted hit below its bound instead of walking
    on to prove it nearest. `hit` is exact (occluded iff some hit
    < t_max); `t`/`tri`/`u`/`v` describe *a* hit, not necessarily the
    nearest (the reference's shadow query needs only the boolean,
    /root/reference/src/kernel.cl:399-417's bounce loop never shades
    shadow hits). With the fog's ~99.8% occlusion this cuts the mean
    steps/ray several-fold: most lanes die inside their first occupied
    leaf rather than finishing its quad list and walking past the hit.
    """
    assert not any_hit or t_max is not None, "any_hit needs t_max"
    n = orig.shape[0]
    chunked = chunk_wave(
        lambda o, d, tm, act: traverse_fast(
            tree, quads, o, d, max_iters=max_iters, compact=compact,
            t_max=tm, active=act, any_hit=any_hit),
        "CLPT_WALK_CHUNK", orig, dir, t_max, active)
    if chunked is not None:
        return chunked
    table = tree.node_table
    tri_slots = tree.tri_indices
    tcount = tri_slots.shape[0]
    nq = quads.shape[0]

    invdir = 1.0 / dir
    sign = (invdir < 0).astype(jnp.int32)

    root_lo = table[0, 0:3]
    root_hi = table[0, 3:6]
    rhit, rtmin, _, _, _ = hit_aabb(root_lo, root_hi, orig, invdir, sign)
    p = orig + jnp.where(rtmin > 0, rtmin, 0.0)[:, None] * dir

    if active is not None:
        rhit = rhit & active
    node0 = jnp.where(rhit, 0, -1).astype(jnp.int32)
    # derive constants from varying inputs (node0*0) so the while_loop
    # carry stays type-stable under shard_map's varying-axes analysis
    zero_i = node0 * 0
    state = {
        "node": node0,
        "p": p,
        "active": rhit,
        "best_t": (BIG + orig[:, 0] * 0.0 + table[0, 0] * 0.0
                   if t_max is None else
                   t_max + orig[:, 0] * 0.0 + table[0, 0] * 0.0),
        "best_slot": zero_i - 1,
        "offset": zero_i,
        "steps": zero_i,
        "orig": orig,
        "dir": dir,
        "invdir": invdir,
        "sign": sign,
    }
    if t_max is not None:
        # carried in the state so wind-down compaction permutes the
        # per-ray bound along with the rays (a closed-over full-width
        # t_max shape-errors after the first halving)
        state["t_bound"] = t_max + orig[:, 0] * 0.0

    # fused one-gather walk (build_walk_table): engaged only when the
    # caller passes the tree's own baked quads — the table bakes them,
    # and e.g. the differentiable path re-packs quads from live verts
    use128 = (getattr(tree, "walk128", None) is not None
              and quads is tree.quads)
    if use128:
        wt = tree.walk128
        n_nodes = table.shape[0]
        nrows128 = wt.shape[0]
        state.update({
            "row": jnp.maximum(node0, 0),
            "qstart": zero_i,
            "count": zero_i,
            "rope": zero_i - 1,
            "hop_t": orig[:, 0] * 0.0,
            "ent_t": orig[:, 0] * 0.0,
        })

    def body128(s):
        act = s["active"]
        o, d, inv, sg = s["orig"], s["dir"], s["invdir"], s["sign"]
        row = wt[jnp.clip(s["row"], 0, nrows128 - 1)]  # the ONE gather
        at_node = s["row"] < n_nodes
        flags = row[:, 7].astype(jnp.int32)
        axis = flags & 3
        node_leaf = at_node & (flags >= 4)
        leafctx = node_leaf | ~at_node        # spill rows are leaf lists
        at_split = act & at_node & ~(flags >= 4)

        # leaf meta: captured at the leaf's node row, carried through
        # its spill rows
        count = jnp.where(at_node, row[:, 11],
                          s["count"].astype(row.dtype)).astype(jnp.int32)
        qstart = jnp.where(at_node, row[:, 10],
                           s["qstart"].astype(row.dtype)).astype(jnp.int32)
        spill0 = row[:, 18].astype(jnp.int32)

        # --- split descent (same arithmetic as the two-gather body) ---
        pp = s["p"]
        pax = jnp.where(axis == 0, pp[:, 0],
                        jnp.where(axis == 1, pp[:, 1], pp[:, 2]))
        go_hi = pax > row[:, 6]
        child = jnp.where(go_hi, row[:, 9], row[:, 8]).astype(jnp.int32)

        # --- hop precompute at node rows: exit-face slab + rope select
        # from THIS row's AABB, carried so the hop after the last spill
        # row needs no re-gather
        lo3, hi3 = row[:, 0:3], row[:, 3:6]
        sgf = sg.astype(lo3.dtype)
        near_b = lo3 + sgf * (hi3 - lo3)
        far_b = hi3 - sgf * (hi3 - lo3)
        t_near, t_far = slab_t(near_b, far_b, o, inv)
        tmin = t_near[:, 0]
        tmax = t_far[:, 0]
        far_face = 1 - sg[:, 0]
        tmin = jnp.maximum(tmin, t_near[:, 1])
        tk = t_far[:, 1] < tmax
        far_face = jnp.where(tk, 3 - sg[:, 1], far_face)
        tmax = jnp.where(tk, t_far[:, 1], tmax)
        tmin = jnp.maximum(tmin, t_near[:, 2])
        tk = t_far[:, 2] < tmax
        far_face = jnp.where(tk, 5 - sg[:, 2], far_face)
        tmax = jnp.where(tk, t_far[:, 2], tmax)
        rope_f = row[:, 12]
        for f in range(1, 6):
            rope_f = jnp.where(far_face == f, row[:, 12 + f], rope_f)
        ent_t = jnp.where(at_node, tmin, s["ent_t"])
        hop_t = jnp.where(at_node, tmax, s["hop_t"])
        rope = jnp.where(at_node, rope_f.astype(jnp.int32), s["rope"])

        # --- dense tests: 8 records; node rows hold the leaf's first
        # quad row in records 4..7 (records 0..3 re-tested but gated by
        # the j < 4 position mask), spill rows hold 8 records
        r8 = row.reshape(-1, 8, 16)
        blk = jnp.where(at_node[:, None, None],
                        jnp.concatenate([r8[:, 4:8], r8[:, 4:8]], axis=1),
                        r8)
        tid = blk[..., 9].astype(jnp.int32)
        j = jnp.arange(8)[None, :]
        pos = s["offset"][:, None] + j
        valid = ((pos < count[:, None]) & (tid >= 0)
                 & (act & leafctx)[:, None]
                 & (~at_node[:, None] | (j < 4)))
        ok, t, _, _ = _mt_pre(blk[..., 0:3], blk[..., 3:6], blk[..., 6:9],
                              o[:, None, :], d[:, None, :])
        t_m = jnp.where(ok & valid, t, BIG)
        # same global tie rule as the two-gather body: last argmin in
        # the block, `<=` against the carried best → globally-last min
        k = 7 - jnp.argmin(t_m[:, ::-1], axis=1)
        bt = jnp.min(t_m, axis=1)
        bslot = qstart * QBLOCK + s["offset"] + k
        has = bt < BIG
        take = has & (bt <= s["best_t"])
        if t_max is not None:
            take = take & (bt < s["t_bound"])
        best_t = jnp.where(take, bt, s["best_t"])
        best_slot = jnp.where(take, bslot.astype(jnp.int32),
                              s["best_slot"])

        # --- advance ---
        consumed = jnp.where(at_node, QBLOCK, 8)
        offset_next = s["offset"] + consumed
        leaf_done = act & leafctx & (offset_next >= count)
        if t_max is None:
            did_hit = best_slot >= 0
            early_exit = did_hit & (ent_t + EXIT_EPS > best_t)
        else:
            early_exit = ent_t + EXIT_EPS > best_t
        new_node = jnp.where(early_exit, -1, rope)
        p_hop = o + hop_t[:, None] * d
        stay = act & leafctx & ~leaf_done

        row_next = jnp.where(
            at_split, child,
            jnp.where(leaf_done, new_node,
                      jnp.where(stay,
                                jnp.where(at_node, spill0, s["row"] + 1),
                                s["row"])))
        p = jnp.where(leaf_done[:, None], p_hop, pp)
        offset = jnp.where(stay, offset_next, 0)
        active = act & jnp.where(leaf_done, new_node >= 0, True)
        if any_hit:
            active = active & ~take
        return {**s, "row": row_next, "p": p, "active": active,
                "best_t": best_t, "best_slot": best_slot,
                "offset": offset, "count": count, "qstart": qstart,
                "rope": rope, "hop_t": hop_t, "ent_t": ent_t,
                "steps": s["steps"] + act.astype(jnp.int32)}

    def body(s):
        node, act = s["node"], s["active"]
        o, d, inv, sg = s["orig"], s["dir"], s["invdir"], s["sign"]
        row = table[jnp.maximum(node, 0)]              # [n', 24] wide gather
        flags = row[:, 7].astype(jnp.int32)
        axis = flags & 3
        is_leaf = flags >= 4

        # --- split descent (src/kernel.cl:325-330) ---
        # per-lane axis select as arithmetic where-chains instead of a
        # take_along_axis gather
        pp = s["p"]
        pax = jnp.where(axis == 0, pp[:, 0],
                        jnp.where(axis == 1, pp[:, 1], pp[:, 2]))
        go_hi = pax > row[:, 6]
        child = jnp.where(go_hi, row[:, 9], row[:, 8]).astype(jnp.int32)

        # --- leaf: one 4-tri quad row test (src/kernel.cl:332-369) ---
        qstart = row[:, 10].astype(jnp.int32)
        count = row[:, 11].astype(jnp.int32)
        qidx = qstart + s["offset"] // QBLOCK
        qrow = quads[jnp.clip(qidx, 0, nq - 1)]        # [n', 64] wide gather
        qr = qrow.reshape(-1, QBLOCK, 16)
        tv0, te1, te2 = qr[..., 0:3], qr[..., 3:6], qr[..., 6:9]
        tid = qr[..., 9].astype(jnp.int32)             # [n', 4]
        in_leaf = (s["offset"][:, None] + jnp.arange(QBLOCK)[None, :]
                   ) < count[:, None]
        valid = in_leaf & (tid >= 0) & (act & is_leaf)[:, None]
        ok, t, _, _ = _mt_pre(tv0, te1, te2, o[:, None, :], d[:, None, :])
        ok = ok & valid
        t_m = jnp.where(ok, t, BIG)
        # reference tie rule: later tris win ties within the scan order →
        # last argmin in the block, then `<=` against the carried best.
        # bt == row min by construction; lane picked without per-lane
        # gathers (reductions only)
        k = (QBLOCK - 1) - jnp.argmin(t_m[:, ::-1], axis=1)
        bt = jnp.min(t_m, axis=1)
        bslot = (qidx * QBLOCK + k).astype(jnp.int32)
        has = bt < BIG
        take = has & (bt <= s["best_t"])
        if t_max is not None:
            # best_t initializes to the bound, so `<=` alone would accept a
            # hit at exactly t_max; the docstring promises "at or beyond it
            # are ignored" — enforce strictness against the bound itself
            take = take & (bt < s["t_bound"])
        best_t = jnp.where(take, bt, s["best_t"])
        best_slot = jnp.where(take, bslot, s["best_slot"])

        # --- advance: next block, or rope hop (src/kernel.cl:370-388) ---
        offset_next = s["offset"] + QBLOCK
        leaf_done = offset_next >= count
        # exit-face-only slab walk inline (traverse_AABB,
        # src/kernel.cl:146-174) reusing the gathered row
        lo3, hi3 = row[:, 0:3], row[:, 3:6]
        sgf = sg.astype(lo3.dtype)
        near_b = lo3 + sgf * (hi3 - lo3)
        far_b = hi3 - sgf * (hi3 - lo3)
        t_near, t_far = slab_t(near_b, far_b, o, inv)
        tmin = t_near[:, 0]
        tmax = t_far[:, 0]
        far_face = 1 - sg[:, 0]
        tmin = jnp.maximum(tmin, t_near[:, 1])
        tk = t_far[:, 1] < tmax
        far_face = jnp.where(tk, 3 - sg[:, 1], far_face)
        tmax = jnp.where(tk, t_far[:, 1], tmax)
        tmin = jnp.maximum(tmin, t_near[:, 2])
        tk = t_far[:, 2] < tmax
        far_face = jnp.where(tk, 5 - sg[:, 2], far_face)
        tmax = jnp.where(tk, t_far[:, 2], tmax)

        if t_max is None:
            # reference gate: only exit after a real hit (best_t starts at
            # BIG, and degenerate inf tmin must not trigger)
            did_hit = best_slot >= 0
            early_exit = did_hit & (tmin + EXIT_EPS > best_t)
        else:
            # distance-bounded query: any node entered beyond the bound is
            # irrelevant whether or not something was hit yet
            early_exit = tmin + EXIT_EPS > best_t
        # 6-way rope select as a where-chain (no per-lane gather)
        rope_f = row[:, 12]
        for f in range(1, 6):
            rope_f = jnp.where(far_face == f, row[:, 12 + f], rope_f)
        rope = rope_f.astype(jnp.int32)
        new_node = jnp.where(early_exit, -1, rope)
        p_hop = o + tmax[:, None] * d

        at_split = act & ~is_leaf
        hop = act & is_leaf & leaf_done
        stay = act & is_leaf & ~leaf_done

        node = jnp.where(at_split, child, jnp.where(hop, new_node, node))
        p = jnp.where(hop[:, None], p_hop, s["p"])
        offset = jnp.where(stay, offset_next, 0)
        active = act & jnp.where(hop, new_node >= 0, True)
        if any_hit:
            # occlusion settled the moment a hit below the bound lands
            active = active & ~take

        return {**s, "node": node, "p": p, "active": active,
                "best_t": best_t, "best_slot": best_slot, "offset": offset,
                "steps": s["steps"] + act.astype(jnp.int32)}

    if use128:
        body = body128

    def run_loop(s, limit, it0):
        def cond(c):
            s, it = c
            return jnp.any(s["active"]) & (it < it0 + limit) & (
                jnp.sum(s["active"]) > (s["active"].shape[0] // 4
                                        if compact else -1))
        def bd(c):
            s, it = c
            return body(s), it + 1
        return jax.lax.while_loop(cond, bd, (s, it0))

    if not compact:
        def cond(c):
            s, it = c
            return jnp.any(s["active"]) & (it < max_iters)
        def bd(c):
            s, it = c
            return body(s), it + 1
        state, _ = jax.lax.while_loop(cond, bd, (state, jnp.int32(0)))
        out = state
        perm = None
    else:
        # Geometric wind-down: run until ≤ half the lanes are active, then
        # permute actives to the front and halve the wavefront. Straggler
        # rays (deep rope walks) stop costing full-width iterations.
        results_t = jnp.full((n,), BIG)
        results_slot = jnp.full((n,), -1, jnp.int32)
        results_steps = jnp.zeros((n,), jnp.int32)
        idx = jnp.arange(n, dtype=jnp.int32)
        state["ridx"] = idx
        it = jnp.int32(0)
        size = n
        # stop shrinking at ~2k lanes: narrower wavefronts leave the
        # device idle. Quartering (not halving) keeps the python-level
        # round count — and so compile time — low.
        min_size = min(n, max(2048, n // 64))
        while size >= min_size:
            (state, it) = run_loop(state, max_iters, it)
            # fold finished lanes' results out, keep actives
            results_t = results_t.at[state["ridx"]].set(state["best_t"])
            results_slot = results_slot.at[state["ridx"]].set(
                state["best_slot"])
            results_steps = results_steps.at[state["ridx"]].set(
                state["steps"])
            if size <= min_size:
                break
            order = jnp.argsort(~state["active"])  # actives first, stable
            quarter = max(size // 4, min_size)
            state = jax.tree.map(lambda a: a[order[:quarter]], state)
            size = quarter
        # tail: finish remaining stragglers at min width
        def cond(c):
            s, it = c
            return jnp.any(s["active"]) & (it < max_iters)
        def bd(c):
            s, it = c
            return body(s), it + 1
        state, _ = jax.lax.while_loop(cond, bd, (state, it))
        results_t = results_t.at[state["ridx"]].set(state["best_t"])
        results_slot = results_slot.at[state["ridx"]].set(state["best_slot"])
        results_steps = results_steps.at[state["ridx"]].set(state["steps"])
        out = {"best_t": results_t, "best_slot": results_slot,
               "steps": results_steps}

    if any_hit:
        # occlusion query: callers consume `hit` only, so skip the
        # resolve_slot row gather over the whole wave. t is the walk's
        # carried best_t (the accepted hit's exact _mt_pre t); the tri id would
        # need the gather, so hits report the sentinel 0 — any_hit's
        # contract already says t/tri describe *a* hit, not the nearest.
        hit = out["best_slot"] >= 0
        n_l = out["best_slot"].shape[0]
        return {
            "hit": hit,
            "t": jnp.where(hit, out["best_t"], BIG),
            "tri": jnp.where(hit, 0, -1).astype(jnp.int32),
            "u": jnp.zeros((n_l,)),
            "v": jnp.zeros((n_l,)),
            "steps": out["steps"],
        }
    rec = resolve_slot(quads, out["best_slot"], orig, dir, tcount)
    rec["steps"] = out["steps"]
    return rec


def resolve_slot(quads, best_slot, orig, dir, tcount: int = None):
    """Differentiable-friendly re-resolve at the winning triangle slot,
    matching ops.traverse.traverse's output exactly. Lane extraction as a
    4-way select (per-lane fancy indexing would be a slow narrow gather);
    the triangle id comes from the quad row itself — no extra gather.
    Shared by the kd walk above and the grid DDA walk (ops/grid_walk.py).
    """
    if tcount is None:
        tcount = quads.shape[0] * QBLOCK
    hit = best_slot >= 0
    slot_safe = jnp.clip(best_slot, 0, tcount - 1)
    qsel = quads[slot_safe // QBLOCK].reshape(-1, QBLOCK, 16)
    lane = slot_safe % QBLOCK
    sel = qsel[:, 0, :]
    for j in range(1, QBLOCK):
        sel = jnp.where((lane == j)[:, None], qsel[:, j, :], sel)
    v0s, e1s, e2s = sel[:, 0:3], sel[:, 3:6], sel[:, 6:9]
    ok, t, u, v = _mt_pre(v0s, e1s, e2s, orig, dir)
    tri = jnp.where(hit, sel[:, 9].astype(jnp.int32), -1)
    return {
        "hit": hit,
        "t": jnp.where(hit, t, BIG),
        "tri": tri.astype(jnp.int32),
        "u": jnp.where(hit, u, 0.0),
        "v": jnp.where(hit, v, 0.0),
    }
