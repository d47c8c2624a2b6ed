"""3D-DDA uniform-grid traversal (lockstep wavefront, XLA).

The grid twin of ops/traverse_fast.py: every ray advances one step per
iteration — one 4-triangle quad-row test, then (when the cell's list is
done) one DDA cell advance. The payoff vs the kd rope walk on fog-like
scenes (accel/grid.py's docstring): no root descent, no node-row gather —
the cell advance is pure vector arithmetic on per-lane state (cell
coords + per-axis next-crossing t), so an iteration costs ONE wide
gather (the quad row; the [C, 8] cell row re-fetch is folded into the
same step) instead of the kd walk's two, and dense fog settles nearest /
any-hit queries within a handful of cells where the kd walk pays tens of
descent+rope steps (src/kernel.cl:323-389's structure, lifted to a grid).

Semantics match traverse_fast: Möller–Trumbore with `det > 0` backface
cull (src/kernel.cl:227-255 convention), nearest hit with the per-cell
t-window termination rule — a lane stops once its best hit is at or
inside the current cell's exit (every later cell starts at t >= that
exit, so nothing closer can appear; duplicated straddling triangles are
harmless exactly as the reference's early-exit slack makes kd leaf
duplicates harmless, src/kernel.cl:381-383). `t_max`/`any_hit` give the
distance-bounded occlusion query (NEE shadow rays).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from clpathtracer_tpu.ops.traverse_fast import _mt_pre

BIG = 3.4e38
QBLOCK = 4


def traverse_grid(grid, orig, dir, max_iters: int = 16384,
                  compact: bool = True, t_max=None, active=None,
                  any_hit: bool = False):
    """Trace a wavefront through a UniformGrid (accel/grid.py).

    Returns the traverse_fast record: dict of [N] arrays
    hit/t/tri/u/v/steps. Options mirror traverse_fast:

    t_max: per-ray bound — hits at or beyond it are ignored, and a lane
    exits once its current cell's exit reaches the bound.
    active: lanes that start dead never walk (fold out on the first
    wind-down round).
    any_hit: occlusion semantics — stop on the FIRST accepted hit below
    the bound (requires t_max); `hit` is exact, t/tri describe *a* hit.
    """
    assert not any_hit or t_max is not None, "any_hit needs t_max"
    n = orig.shape[0]
    # optional wave chunking (ops/traverse_fast.py::chunk_wave — shared
    # helper, measured in its docstring; off by default)
    from clpathtracer_tpu.ops.traverse_fast import chunk_wave
    chunked = chunk_wave(
        lambda o, d, tm, act: traverse_grid(
            grid, o, d, max_iters=max_iters, compact=compact,
            t_max=tm, active=act, any_hit=any_hit),
        "CLPT_GRID_CHUNK", orig, dir, t_max, active)
    if chunked is not None:
        return chunked
    inline = getattr(grid, "table", None) is not None
    if inline:
        table = grid.table
        nrows = table.shape[0]
    else:
        cells = grid.cells
        quads = grid.quads
        nq = quads.shape[0]
    rx, ry, rz = grid.res
    ncells = rx * ry * rz

    # grid geometry as traced values (pass-through from the grid pytree:
    # keeping the jaxpr constant-free — CLAUDE.md jax 0.9 note)
    glo, gh = grid.lo, grid.h
    inv_d = 1.0 / dir

    # slab test against the grid AABB → entry distance. dir==0 axes get
    # the origin-in-slab answer directly: (b - orig) * inv_d is 0 * inf
    # = NaN when the origin sits exactly on a slab plane (the grid pad
    # is only 1e-4*ext, so that happens), which would silently void
    # `inside` below.
    t_lo = (glo[None, :] - orig) * inv_d
    t_hi = (grid.hi[None, :] - orig) * inv_d
    d0 = dir == 0
    in_slab = (orig >= glo[None, :]) & (orig <= grid.hi[None, :])
    t_near = jnp.where(d0, jnp.where(in_slab, -BIG, BIG),
                       jnp.minimum(t_lo, t_hi))
    t_far = jnp.where(d0, jnp.where(in_slab, BIG, -BIG),
                      jnp.maximum(t_lo, t_hi))
    t_en = jnp.max(t_near, axis=1)
    t_ex = jnp.min(t_far, axis=1)
    t0 = jnp.maximum(t_en, 0.0)
    inside = (t_ex >= t0) & (t_ex > 0.0)

    act0 = inside
    if active is not None:
        act0 = act0 & active
    if t_max is not None:
        act0 = act0 & (t0 < t_max)

    p = orig + t0[:, None] * dir
    # per-axis clip with python-scalar bounds (no literal arrays in traced
    # code — the jax 0.9 hoisted-constant hazard, CLAUDE.md)
    cellf = jnp.floor((p - glo[None, :]) / gh[None, :])
    cell = jnp.stack([jnp.clip(cellf[:, 0], 0, rx - 1),
                      jnp.clip(cellf[:, 1], 0, ry - 1),
                      jnp.clip(cellf[:, 2], 0, rz - 1)],
                     axis=1).astype(jnp.int32)
    step = jnp.where(dir > 0, 1, jnp.where(dir < 0, -1, 0)).astype(
        jnp.int32)
    # t at the next boundary crossing per axis (BIG when dir == 0)
    next_b = glo[None, :] + (cell + (dir > 0)).astype(jnp.float32) \
        * gh[None, :]
    t_next = jnp.where(dir != 0, (next_b - orig) * inv_d, BIG)
    dt = jnp.where(dir != 0, gh[None, :] * jnp.abs(inv_d), BIG)

    zero_i = cell[:, 0] * 0
    cid0 = (cell[:, 0] * ry + cell[:, 1]) * rz + cell[:, 2]
    # the walk carries the winner's (t, tri, u, v) through the loop — the
    # in-loop _mt_pre already computes them exactly, so no post-walk
    # resolve gather over the whole wave is needed
    state = {
        "cell": cell,
        "t_next": t_next,
        "offset": zero_i,
        "active": act0,
        "best_t": (BIG + orig[:, 0] * 0.0 if t_max is None
                   else t_max + orig[:, 0] * 0.0),
        "best_tri": zero_i - 1,
        "best_u": orig[:, 0] * 0.0,
        "best_v": orig[:, 0] * 0.0,
        "steps": zero_i,
        "orig": orig,
        "dir": dir,
        "step3": step,
        "dt": dt,
    }
    if t_max is not None:
        state["t_bound"] = t_max + orig[:, 0] * 0.0
    if inline:
        # row: the absolute table row this iteration gathers (cell row or
        # spill row); count/spill: the current cell's meta, captured on
        # its cell-row iteration and carried through its spill rows
        state["row"] = cid0
        state["count"] = zero_i
        state["spill"] = zero_i

    def finish(s, act, count, offset_next, best_t, best_tri, take):
        """Shared tail: per-cell termination test + DDA advance. Returns
        (cell2, t_next2, adv, cid_new, active2, cell_done)."""
        c, tn = s["cell"], s["t_next"]
        cell_done = offset_next >= count
        t_exit = jnp.min(tn, axis=1)
        # settled: nothing in a later cell (entry >= t_exit) can beat the
        # best; with a bound, later cells are irrelevant past it
        settled = (best_tri >= 0) & (best_t <= t_exit)
        if t_max is not None:
            settled = settled | (t_exit >= s["t_bound"])
        # step the min-t axis (where-chains; no per-lane gathers, no
        # literal index arrays)
        on0 = tn[:, 0] <= jnp.minimum(tn[:, 1], tn[:, 2])
        on1 = ~on0 & (tn[:, 1] <= tn[:, 2])
        on2 = ~on0 & ~on1
        c_new = jnp.stack(
            [c[:, 0] + jnp.where(on0, s["step3"][:, 0], 0),
             c[:, 1] + jnp.where(on1, s["step3"][:, 1], 0),
             c[:, 2] + jnp.where(on2, s["step3"][:, 2], 0)], axis=1)
        tn_new = jnp.stack(
            [tn[:, 0] + jnp.where(on0, s["dt"][:, 0], 0.0),
             tn[:, 1] + jnp.where(on1, s["dt"][:, 1], 0.0),
             tn[:, 2] + jnp.where(on2, s["dt"][:, 2], 0.0)], axis=1)
        out = ((c_new[:, 0] < 0) | (c_new[:, 0] >= rx)
               | (c_new[:, 1] < 0) | (c_new[:, 1] >= ry)
               | (c_new[:, 2] < 0) | (c_new[:, 2] >= rz))
        adv = act & cell_done
        cell2 = jnp.where(adv[:, None], c_new, c)
        t_next2 = jnp.where(adv[:, None], tn_new, tn)
        cid_new = (c_new[:, 0] * ry + c_new[:, 1]) * rz + c_new[:, 2]
        active2 = act & ~(cell_done & (settled | out))
        if any_hit:
            active2 = active2 & ~take
        return cell2, t_next2, adv, cid_new, active2, cell_done

    def take_best(s, t_m, tid, u_m, v_m):
        """Fold this block's best (t, tri, u, v) into the carried winner.
        The winning column is selected with a static where-chain (last
        min, matching the old slot rule) — no per-lane gather."""
        kk = t_m.shape[1]
        k_last = kk - 1 - jnp.argmin(t_m[:, ::-1], axis=1)
        bt = jnp.min(t_m, axis=1)
        take = (bt < BIG) & (bt <= s["best_t"])
        if t_max is not None:
            take = take & (bt < s["t_bound"])
        sel_tri, sel_u, sel_v = tid[:, 0], u_m[:, 0], v_m[:, 0]
        for j in range(1, kk):
            at = k_last == j
            sel_tri = jnp.where(at, tid[:, j], sel_tri)
            sel_u = jnp.where(at, u_m[:, j], sel_u)
            sel_v = jnp.where(at, v_m[:, j], sel_v)
        best_t = jnp.where(take, bt, s["best_t"])
        best_tri = jnp.where(take, sel_tri, s["best_tri"])
        best_u = jnp.where(take, sel_u, s["best_u"])
        best_v = jnp.where(take, sel_v, s["best_v"])
        return take, best_t, best_tri, best_u, best_v

    def body_split(s):
        act = s["active"]
        o, d = s["orig"], s["dir"]
        c = s["cell"]
        cid = (c[:, 0] * ry + c[:, 1]) * rz + c[:, 2]
        row = cells[jnp.clip(cid, 0, ncells - 1)]      # [n', 8] wide gather
        qstart = row[:, 0].astype(jnp.int32)
        count = row[:, 1].astype(jnp.int32)

        qidx = qstart + s["offset"] // QBLOCK
        qrow = quads[jnp.clip(qidx, 0, nq - 1)]        # [n', 64] wide gather
        qr = qrow.reshape(-1, QBLOCK, 16)
        tid = qr[..., 9].astype(jnp.int32)
        in_cell = (s["offset"][:, None] + jnp.arange(QBLOCK)[None, :]
                   ) < count[:, None]
        valid = in_cell & (tid >= 0) & act[:, None]
        ok, t, u, v = _mt_pre(qr[..., 0:3], qr[..., 3:6], qr[..., 6:9],
                              o[:, None, :], d[:, None, :])
        t_m = jnp.where(ok & valid, t, BIG)
        take, best_t, best_tri, best_u, best_v = take_best(
            s, t_m, tid, u, v)

        offset_next = s["offset"] + QBLOCK
        cell2, t_next2, adv, _, active2, cell_done = finish(
            s, act, count, offset_next, best_t, best_tri, take)
        offset2 = jnp.where(act & ~cell_done, offset_next, 0)
        return {**s, "cell": cell2, "t_next": t_next2, "offset": offset2,
                "active": active2, "best_t": best_t,
                "best_tri": best_tri, "best_u": best_u, "best_v": best_v,
                "steps": s["steps"] + act.astype(jnp.int32)}

    def body_inline(s):
        act = s["active"]
        o, d = s["orig"], s["dir"]
        ridx = jnp.clip(s["row"], 0, nrows - 1)
        row = table[ridx]                            # [n', 128] — the ONLY
        #   gather this iteration: cell rows carry meta + 7 inline tris,
        #   spill rows 8 tris (accel/grid.py inline layout)
        at_cell = s["row"] < ncells
        count = jnp.where(at_cell, row[:, 1], s["count"].astype(
            row.dtype)).astype(jnp.int32)
        spill = jnp.where(at_cell, row[:, 0], s["spill"].astype(
            row.dtype)).astype(jnp.int32)
        r8 = row.reshape(-1, 8, 16)
        # test block: inline rows use slots 1..7 (7 tris; 8th lane
        # masked), spill rows slots 0..7
        blk = jnp.where(at_cell[:, None, None],
                        jnp.concatenate([r8[:, 1:8], r8[:, 7:8]], axis=1),
                        r8)
        tid = blk[..., 9].astype(jnp.int32)
        j = jnp.arange(8)[None, :]
        pos = s["offset"][:, None] + j
        valid = ((pos < count[:, None]) & (tid >= 0) & act[:, None]
                 & (~at_cell[:, None] | (j < 7)))
        ok, t, u, v = _mt_pre(blk[..., 0:3], blk[..., 3:6], blk[..., 6:9],
                              o[:, None, :], d[:, None, :])
        t_m = jnp.where(ok & valid, t, BIG)
        take, best_t, best_tri, best_u, best_v = take_best(
            s, t_m, tid, u, v)

        consumed = jnp.where(at_cell, 7, 8)
        offset_next = s["offset"] + consumed
        cell2, t_next2, adv, cid_new, active2, cell_done = finish(
            s, act, count, offset_next, best_t, best_tri, take)
        # next row: this cell's next spill row, or the next cell's row
        row_stay = spill + (offset_next - 7) // 8
        row2 = jnp.where(adv, cid_new, jnp.where(act, row_stay, s["row"]))
        offset2 = jnp.where(act & ~cell_done, offset_next, 0)
        return {**s, "cell": cell2, "t_next": t_next2, "offset": offset2,
                "row": row2, "count": count, "spill": spill,
                "active": active2, "best_t": best_t,
                "best_tri": best_tri, "best_u": best_u, "best_v": best_v,
                "steps": s["steps"] + act.astype(jnp.int32)}

    body = body_inline if inline else body_split

    if not compact:
        def cond(carry):
            s, it = carry
            return jnp.any(s["active"]) & (it < max_iters)

        def bd(carry):
            s, it = carry
            return body(s), it + 1
        state, _ = jax.lax.while_loop(cond, bd, (state, jnp.int32(0)))
        out = state
    else:
        # geometric wind-down, as in traverse_fast: run until <= 1/4 of
        # the lanes are active, fold finished results out, quarter the
        # wavefront; stragglers stop costing full-width iterations
        results_t = jnp.full((n,), BIG)
        results_tri = jnp.full((n,), -1, jnp.int32)
        results_u = jnp.zeros((n,))
        results_v = jnp.zeros((n,))
        results_steps = jnp.zeros((n,), jnp.int32)
        state["ridx"] = jnp.arange(n, dtype=jnp.int32)
        it = jnp.int32(0)
        size = n
        # the DDA's stragglers are the rays that miss everything and walk
        # the whole grid (~sum(res) cells), so the tail floor is a real
        # cost knob, sweepable via CLPT_GRID_MIN (default not measured on
        # the GPU yet)
        floor = int(os.environ.get("CLPT_GRID_MIN", "2048"))
        min_size = min(n, max(floor, n // 64))
        # wind-down aggressiveness: shrink the wavefront F-fold once
        # active lanes drop below 1/F (CLPT_GRID_FRAC). Fog active
        # fractions decay fast (most lanes settle in their first occupied
        # cells), so eager halving is the default; not measured on the
        # GPU yet
        frac = int(os.environ.get("CLPT_GRID_FRAC", "2"))

        def run_loop(s, it0):
            def cond(carry):
                s, it = carry
                return (jnp.any(s["active"]) & (it < it0 + max_iters)
                        & (jnp.sum(s["active"])
                           > s["active"].shape[0] // frac))

            def bd(carry):
                s, it = carry
                return body(s), it + 1
            return jax.lax.while_loop(cond, bd, (s, it0))

        while size >= min_size:
            state, it = run_loop(state, it)
            results_t = results_t.at[state["ridx"]].set(state["best_t"])
            results_tri = results_tri.at[state["ridx"]].set(
                state["best_tri"])
            results_u = results_u.at[state["ridx"]].set(state["best_u"])
            results_v = results_v.at[state["ridx"]].set(state["best_v"])
            results_steps = results_steps.at[state["ridx"]].set(
                state["steps"])
            if size <= min_size:
                break
            order = jnp.argsort(~state["active"])
            shrunk = max(size // frac, min_size)
            state = jax.tree.map(lambda a: a[order[:shrunk]], state)
            size = shrunk

        def cond(carry):
            s, it = carry
            return jnp.any(s["active"]) & (it < max_iters)

        def bd(carry):
            s, it = carry
            return body(s), it + 1
        state, _ = jax.lax.while_loop(cond, bd, (state, it))
        results_t = results_t.at[state["ridx"]].set(state["best_t"])
        results_tri = results_tri.at[state["ridx"]].set(state["best_tri"])
        results_u = results_u.at[state["ridx"]].set(state["best_u"])
        results_v = results_v.at[state["ridx"]].set(state["best_v"])
        results_steps = results_steps.at[state["ridx"]].set(state["steps"])
        out = {"best_t": results_t, "best_tri": results_tri,
               "best_u": results_u, "best_v": results_v,
               "steps": results_steps}

    # the carried winner IS the record — no resolve gather (the in-loop
    # _mt_pre already produced the exact f32 t/u/v for the winning tri)
    hit = out["best_tri"] >= 0
    return {
        "hit": hit,
        "t": jnp.where(hit, out["best_t"], BIG),
        "tri": jnp.where(hit, out["best_tri"], -1),
        "u": jnp.where(hit, out["best_u"], 0.0),
        "v": jnp.where(hit, out["best_v"], 0.0),
        "steps": out["steps"],
    }
