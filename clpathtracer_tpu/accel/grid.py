"""Uniform-grid accelerator for fog-like scenes (host-side numpy build).

The kd-tree (accel/sah.py — the reference's structure, src/kd_tree.c) is
the right accelerator for SURFACE meshes, where geometry density varies
by orders of magnitude. The adversarial bench soup is the opposite: 1M
*uniformly* scattered tiny triangles — the textbook case for a uniform
grid, because cell lookup is pure arithmetic (`floor((p - lo) / h)`), the
3D-DDA walk needs no per-step node-table gather and no root descent, and
occlusion/nearest queries in dense fog terminate within a handful of
cells. Every kd walk step costs a row gather just to learn the node's
shape, while the DDA's cell advance is vector arithmetic on state the
lane already holds.

Layout mirrors ops/traverse_fast.py's conventions so the walk kernel
(ops/grid_walk.py) reuses the same quad-row Möller–Trumbore:

  cells [C, 8] f32 rows: 0 quad-row start | 1 tri count | 2:8 pad
  quads [Q, 64] f32: 4 x (v0[3], e1[3], e2[3], tri_id, pad[6])
    (accel/sah.py::pack_quads_host format; tri_id -1 = pad slot)

Triangles are binned into every cell their AABB overlaps (the grid twin
of the kd builder's straddler duplication, src/kd_tree.c:166-183); the
walk's per-cell t-window makes duplicate hits harmless exactly as the
reference's early-exit slack does for duplicated kd leaves.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from clpathtracer_tpu.utils import struct

from clpathtracer_tpu.accel.sah import pack_quads_host

QBLOCK = 4  # triangles per quad row (ops/traverse_fast.py)


@struct.dataclass
class UniformGrid:
    """Device-resident uniform grid (SoA, gather-friendly rows).

    Two interchangeable device layouts (ops/grid_walk.py walks both):

    * split (cells + quads): [C, 8] meta rows + [Q, 64] quad rows — two
      gathers per walk iteration.
    * inline (table): ONE unified [C + S, 128] row table. Row `cid`
      (cid < C) is that cell's row: 16-lane slot 0 carries
      (spill_row, count) and slots 1..7 carry the cell's first 7
      triangles inline; rows >= C are 8-triangle spill rows for cells
      with more. Most cells then complete in a single one-gather
      iteration.

    Triangle records are 16 lanes each, pack_quads_host's layout:
    (v0[3], e1[3], e2[3], tri_id, pad[6]); tri_id -1 = pad slot.
    """

    cells: jnp.ndarray = None   # [C, 8] f32 (quad_start, tri_count, pad…)
    quads: jnp.ndarray = None   # [Q, 64] f32 quad rows (pack_quads_host)
    table: jnp.ndarray = None   # [C + S, 128] f32 unified inline layout
    lo: jnp.ndarray = None      # [3] f32 grid AABB min
    hi: jnp.ndarray = None      # [3] f32 grid AABB max
    h: jnp.ndarray = None       # [3] f32 cell size
    res: tuple = struct.field(pytree_node=False, default=(1, 1, 1))

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.res))

    def stats(self) -> dict:
        if self.cells is not None:
            counts = np.asarray(self.cells[:, 1])
            extra = {"quad_rows": int(self.quads.shape[0]),
                     "mem_mb": float((self.quads.size + self.cells.size)
                                     * 4 / 1e6)}
        else:
            c = self.num_cells
            counts = np.asarray(self.table[:c, 1])
            extra = {"spill_rows": int(self.table.shape[0] - c),
                     "mem_mb": float(self.table.size * 4 / 1e6)}
        occupied = counts > 0
        entries = float(counts.sum())
        return {
            "res": tuple(self.res),
            "cells": int(counts.shape[0]),
            "occupied_frac": float(occupied.mean()),
            "entries": int(entries),
            "avg_tris_per_occupied_cell": float(
                entries / max(occupied.sum(), 1)),
            "max_tris_per_cell": int(counts.max(initial=0)),
            **extra,
        }


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros_like(a)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _records16(idx: np.ndarray, tv: np.ndarray) -> np.ndarray:
    """Per-triangle 16-lane records (pack_quads_host's element layout,
    without the 4-per-row padding requirement): v0, e1, e2, tri_id."""
    a = tv[idx, 0]
    r = np.zeros((idx.shape[0], 16), np.float32)
    r[:, 0:3] = a
    r[:, 3:6] = tv[idx, 1] - a
    r[:, 6:9] = tv[idx, 2] - a
    r[:, 9] = idx.astype(np.float32)
    return r


def fog_likeness(tri_verts: np.ndarray, res: int = 24) -> float:
    """Cheap scene-uniformity score in [0, 1]: the fraction of coarse
    grid cells occupied by triangle centroids. Volumetric fog fills most
    of its AABB (score near 1); surface meshes sweep a 2-D sheet through
    the 3-D volume (score ~ 1/res). Used to auto-pick the per-ray
    accelerator: uniform grid for fog-like scenes, walk-tuned kd tree
    for surfaces (cli/main.py).
    """
    tv = np.asarray(tri_verts, np.float32)
    c = tv.mean(axis=1)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-6)
    cell = np.clip((c - lo) / ext * res, 0, res - 1).astype(np.int64)
    cid = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
    return float(np.unique(cid).size / res ** 3)


def build_grid(tri_verts: np.ndarray, res=None, density: float = 1.0,
               layout: str = "inline") -> UniformGrid:
    """Bin triangles into a uniform grid (vectorized numpy, host-side).

    tri_verts: [F, 3, 3]. res: per-axis cell counts; default picks
    roughly `density` triangles per cell with cells as close to cubical
    as the scene AABB allows (the classic lambda-heuristic with
    lambda = 1/density). layout: "inline" (one unified 128-wide row
    table, one gather per step; the default) or "split" (meta + quad
    tables).
    """
    tv = np.asarray(tri_verts, np.float32)
    f = tv.shape[0]
    assert f > 0, "empty scene"
    tmin = tv.min(axis=1)
    tmax = tv.max(axis=1)
    lo = tmin.min(axis=0)
    hi = tmax.max(axis=0)
    ext = np.maximum(hi - lo, 1e-6)
    pad = 1e-4 * ext
    lo = (lo - pad).astype(np.float32)
    hi = (hi + pad).astype(np.float32)
    ext = hi - lo

    if res is None:
        # cells ~ f / density, shaped to the AABB: r_a = ext_a * k where
        # prod(r) = f/density  =>  k = (f / (density * V))^(1/3)
        k = (f / (density * float(np.prod(ext)))) ** (1.0 / 3.0)
        res = np.maximum(1, np.minimum(
            512, np.round(ext * k))).astype(np.int64)
        # cap TOTAL cells too: the per-axis cap alone admits up to 512^3
        # = 1.3e8 cells (a multi-GB table) when density is tiny or the
        # extents are skewed — a mis-tuned density should hit the loud
        # f32-exactness assert below, not an allocation OOM first
        cap = min(1 << 23, max(8 * f, 1 << 12))
        over = float(np.prod(res)) / cap
        if over > 1.0:
            res = np.maximum(1, np.floor(
                res / over ** (1.0 / 3.0))).astype(np.int64)
    res = tuple(int(r) for r in np.broadcast_to(res, (3,)))
    rx, ry, rz = res
    ncells = rx * ry * rz
    assert ncells < (1 << 24), (
        f"{res} = {ncells} grid cells overflow f32-exact row ids — "
        "lower the grid resolution/density")
    h = (ext / np.asarray(res, np.float32)).astype(np.float32)
    inv_h = 1.0 / h

    # per-tri overlapped cell ranges from the tri AABB (conservative)
    clo = np.clip(np.floor((tmin - lo) * inv_h).astype(np.int64), 0,
                  np.asarray(res) - 1)
    chi = np.clip(np.floor((tmax - lo) * inv_h).astype(np.int64), 0,
                  np.asarray(res) - 1)
    spans = chi - clo + 1                       # [F, 3]
    counts = spans.prod(axis=1)                 # [F]
    total = int(counts.sum())

    # expand to (tri, cell) entries without a python loop: entry j of
    # triangle i enumerates the span box in z-fastest order
    tid = np.repeat(np.arange(f, dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        _exclusive_cumsum(counts), counts)
    sy = np.repeat(spans[:, 1], counts)
    sz = np.repeat(spans[:, 2], counts)
    oz = within % sz
    oy = (within // sz) % sy
    ox = within // (sz * sy)
    cx = np.repeat(clo[:, 0], counts) + ox
    cy = np.repeat(clo[:, 1], counts) + oy
    cz = np.repeat(clo[:, 2], counts) + oz
    cellid = (cx * ry + cy) * rz + cz

    order = np.argsort(cellid, kind="stable")
    cellid_s = cellid[order]
    tid_s = tid[order]

    starts = np.searchsorted(cellid_s, np.arange(ncells, dtype=np.int64))
    ccount = np.diff(np.append(starts, total))
    geom = dict(lo=jnp.asarray(lo), hi=jnp.asarray(hi), h=jnp.asarray(h),
                res=res)

    if layout == "inline":
        # unified [C + S, 128] table: row cid = slot0 meta (spill_row,
        # count) + 7 inline tris; spill rows of 8 tris for the rest
        inl = np.minimum(ccount, 7)
        spill_rows = -(-np.maximum(ccount - 7, 0) // 8)
        srow0 = ncells + _exclusive_cumsum(spill_rows)
        nrows = int(ncells + spill_rows.sum())
        assert nrows < (1 << 24), (
            f"{nrows} grid rows overflow f32-exact row ids — lower the "
            "grid resolution/density")
        # per-entry destination record (table viewed as [nrows*8, 16])
        within = np.arange(total, dtype=np.int64) - starts[cellid_s]
        is_inl = within < 7
        rec = np.where(
            is_inl,
            cellid_s * 8 + within + 1,                       # slots 1..7
            (srow0[cellid_s] + (within - 7) // 8) * 8 + (within - 7) % 8)
        records = np.zeros((nrows * 8, 16), np.float32)
        records[:, 9] = -1.0                                  # pad tri_id
        records[rec] = _records16(tid_s.astype(np.int32), tv)
        records[np.arange(ncells) * 8, 0] = srow0.astype(np.float32)
        records[np.arange(ncells) * 8, 1] = ccount.astype(np.float32)
        table = records.reshape(nrows, 128)
        return UniformGrid(table=jnp.asarray(table), **geom)

    # split layout: pad each cell's list to a QBLOCK multiple and
    # scatter into quad-row slots
    padded = -(-ccount // QBLOCK) * QBLOCK
    pstart = _exclusive_cumsum(padded)
    total_padded = int(padded.sum())
    assert total_padded // QBLOCK < (1 << 24), (
        f"{total_padded} grid entries overflow f32-exact quad ids — "
        "lower the grid resolution/density")
    tri_slots = np.full(total_padded, -1, np.int32)
    dest = pstart[cellid_s] + (np.arange(total, dtype=np.int64)
                               - starts[cellid_s])
    tri_slots[dest] = tid_s.astype(np.int32)

    cells = np.zeros((ncells, 8), np.float32)
    cells[:, 0] = (pstart // QBLOCK).astype(np.float32)
    cells[:, 1] = ccount.astype(np.float32)

    quads = pack_quads_host(tri_slots, tv)
    return UniformGrid(cells=jnp.asarray(cells), quads=jnp.asarray(quads),
                       **geom)
