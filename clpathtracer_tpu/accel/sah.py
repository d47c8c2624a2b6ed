"""SAH kd-tree builder with ropes — host-side, vectorized numpy.

Re-implements the reference's acceleration structure as data-parallel numpy
(the reference builds it with scalar C loops, src/kd_tree.c:94-200):

* binned SAH over 25 uniform candidate planes per axis
  (NBINS, src/kd_tree.c:9,118-120),
* the reference's *area-augmented* cost variant: each side's surface area
  term also accumulates member triangle areas (src/kd_tree.c:138-145),
* straddling triangles duplicated into both children (src/kd_tree.c:166-183),
* leaves at ≤ `leaf_size` triangles or depth exhaustion
  (DEPTH=15, src/kd_tree.c:8,97) or degenerate split (src/kd_tree.c:158),
* post-pass rope construction: 6 neighbor links per leaf, pushed down the
  neighbor subtree while provably non-straddling
  (add_ropes / optimize_rope, src/kd_tree.c:43-83).

Output is a `FlatKdTree` of flat SoA arrays — already the device layout
(the reference's packed 68-byte kdnode, include/kd_tree.h:31-50, exploded
into columns so the device can gather each field as a dense vector). Node
order is preorder (split, left subtree, right subtree), matching the
reference's append order (src/kd_tree.c:187-199), so node 0 is the root.

Defaults match the reference; `max_depth`/`leaf_size` are configurable
because DEPTH=15 produces pathologically fat leaves at 1M triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
from clpathtracer_tpu.utils import struct

NBINS = 25          # candidate planes per axis (src/kd_tree.c:9)
DEFAULT_DEPTH = 15  # reference DEPTH (src/kd_tree.c:8)
EPS = 1e-9          # reference EPS (src/kd_tree.c:10)


@struct.dataclass
class FlatKdTree:
    """Device-resident kd-tree as SoA columns.

    For split nodes child_lo/child_hi are node indices; for leaves
    leaf_start/leaf_count index into tri_indices and ropes[6] are the
    per-face neighbor links (-1 = exit the tree), face order
    (L, R, D, U, B, F) = (-x, +x, -y, +y, -z, +z) as in the reference's
    KD_SIDE enum (src/kernel.cl:39-46).
    """

    node_min: jnp.ndarray     # [N, 3] f32
    node_max: jnp.ndarray     # [N, 3] f32
    is_leaf: jnp.ndarray      # [N] bool
    split_axis: jnp.ndarray   # [N] i32 (0 for leaves)
    split_value: jnp.ndarray  # [N] f32
    child_lo: jnp.ndarray     # [N] i32
    child_hi: jnp.ndarray     # [N] i32
    leaf_start: jnp.ndarray   # [N] i32
    leaf_count: jnp.ndarray   # [N] i32
    ropes: jnp.ndarray        # [N, 6] i32
    tri_indices: jnp.ndarray  # [T] i32 (concatenated leaf lists; -1 = pad)
    node_table: jnp.ndarray = None  # [N, 24] f32 gather-packed mirror of
    #   the columns above (ops/traverse_fast.py); present when the tree was
    #   built with tri_block=4
    quads: jnp.ndarray = None  # [T/4, 64] f32 pre-packed leaf triangle
    #   rows (v0, e1, e2, tri_id x4) baked at build time from the build
    #   vertices — saves a 3x full-scene gather per frame; the
    #   differentiable path ignores it and re-packs from live verts
    grid: "object" = None  # optional accel/grid.py::UniformGrid — the
    #   fog-scene accelerator (attach_grid). The DDA walk (ops/
    #   grid_walk.py) needs no root descent and no node-row gather;
    #   _occluded prefers it over `shadow` when present.
    walk128: jnp.ndarray = None  # optional [N + S, 128] f32 fused walk
    #   rows (ops/traverse_fast.py::build_walk_table): node meta + first
    #   leaf quad row per row, 8-tri spill rows — one gather per walk
    #   step instead of two. Baked from build-time quads; traverse_fast
    #   engages it only when called with tree.quads itself.
    shadow: "object" = None  # optional second FlatKdTree with small
    #   leaves for the per-ray walks of path mode (attach_shadow_tree):
    #   the t_max rope walk tests 4 tris per step, so a fat-leaf tree
    #   spends ~leaf/2 quad steps inside the first occupied leaf. Used by
    #   render/integrator.py for NEE occlusion and surface-scene bounces.

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def stats(self) -> dict:
        """Tree-quality stats (the reference printf, src/kd_tree.c:232-235)."""
        is_leaf = np.asarray(self.is_leaf)
        counts = np.asarray(self.leaf_count)[is_leaf]
        leaves = int(is_leaf.sum())
        leaf_tris = int(counts.sum())
        return {
            "leaf_tris": leaf_tris,
            "leaves": leaves,
            "avg_tris_per_leaf": leaf_tris / max(leaves, 1),
            "max_tris_per_leaf": int(counts.max()) if leaves else 0,
            "nodes": self.num_nodes,
        }


@dataclasses.dataclass
class _Builder:
    """Mutable build state (host-side numpy, converted to jnp at the end)."""

    node_min: list
    node_max: list
    is_leaf: list
    split_axis: list
    split_value: list
    child_lo: list
    child_hi: list
    leaf_start: list
    leaf_count: list
    tri_indices: list
    leaf_size: int
    vmin_c: np.ndarray  # [F, 3] per-tri min corner, per axis
    vmax_c: np.ndarray  # [F, 3] per-tri max corner, per axis
    area: np.ndarray    # [F] triangle surface areas

    def add_leaf(self, tri_ids: np.ndarray, lo, hi) -> int:
        idx = len(self.node_min)
        self.node_min.append(lo)
        self.node_max.append(hi)
        self.is_leaf.append(True)
        self.split_axis.append(0)
        self.split_value.append(0.0)
        self.child_lo.append(-1)
        self.child_hi.append(-1)
        self.leaf_start.append(len(self.tri_indices))
        self.leaf_count.append(len(tri_ids))
        self.tri_indices.extend(int(t) for t in tri_ids)
        return idx

    def add_split(self, lo, hi, value, axis) -> int:
        idx = len(self.node_min)
        self.node_min.append(lo)
        self.node_max.append(hi)
        self.is_leaf.append(False)
        self.split_axis.append(int(axis))
        self.split_value.append(float(value))
        self.child_lo.append(-1)
        self.child_hi.append(-1)
        self.leaf_start.append(0)
        self.leaf_count.append(0)
        return idx


def _best_plane(b: _Builder, tri_ids: np.ndarray, lo: np.ndarray,
                hi: np.ndarray):
    """Vectorized SAH sweep: 3 axes x NBINS planes at once.

    Cost per plane = NL*SL + NR*SR where SL/SR are the child box surface
    areas *plus* the summed areas of the triangles assigned to that side —
    the reference's nonstandard augmentation (src/kd_tree.c:121-145).
    Returns (axis, value) or None if no valid plane exists.
    """
    ext = hi - lo
    vmin = b.vmin_c[tri_ids]  # [n, 3]
    vmax = b.vmax_c[tri_ids]  # [n, 3]
    sa = b.area[tri_ids]      # [n]

    best = None  # (cost, axis, value)
    d = (np.arange(NBINS, dtype=np.float64) + 1.0) / (NBINS + 1.0)  # [B]
    for axis in range(3):
        e = ext[axis]
        if e < EPS:
            continue
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        v = lo[axis] + d * e  # [B]
        base = ext[a1] * ext[a2]
        perim = ext[a1] + ext[a2]
        sl_box = 2.0 * (base + e * d * perim)          # [B]
        sr_box = 2.0 * (base + e * (1.0 - d) * perim)  # [B]

        is_l = vmin[:, axis][:, None] <= v[None, :]  # [n, B]
        is_r = vmax[:, axis][:, None] >= v[None, :]
        nl = is_l.sum(0)
        nr = is_r.sum(0)
        sl = sl_box + sa @ is_l
        sr = sr_box + sa @ is_r
        cost = nl * sl + nr * sr  # [B]

        k = int(np.argmin(cost))
        if best is None or cost[k] < best[0]:
            best = (cost[k], axis, float(v[k]))

    if best is None:
        return None
    cost, axis, value = best
    # degenerate-split guard (src/kd_tree.c:158)
    if value <= lo[axis] or hi[axis] <= value:
        return None
    # leaf-cost termination (NOT in the reference, which splits to depth
    # exhaustion and duplicates straddlers ~5x on big scenes): keep the
    # node a leaf when splitting isn't cheaper, in the same area-augmented
    # cost family: C_leaf = N * (S_box + sum tri areas).
    s_box = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if cost >= len(tri_ids) * (s_box + sa.sum()):
        return None
    return axis, value


def _build_recursive(b: _Builder, tri_ids: np.ndarray, lo: np.ndarray,
                     hi: np.ndarray, depth: int) -> int:
    if len(tri_ids) <= b.leaf_size or depth == 0:
        return b.add_leaf(tri_ids, lo, hi)

    plane = _best_plane(b, tri_ids, lo, hi)
    if plane is None:
        return b.add_leaf(tri_ids, lo, hi)
    axis, value = plane

    # duplicate-into-both partition with EPS slack (src/kd_tree.c:166-183)
    vmin = b.vmin_c[tri_ids][:, axis]
    vmax = b.vmax_c[tri_ids][:, axis]
    l_ids = tri_ids[vmin <= value + EPS]
    r_ids = tri_ids[vmax >= value - EPS]
    if len(l_ids) == len(tri_ids) and len(r_ids) == len(tri_ids):
        # split separates nothing — every triangle straddles; stop here
        return b.add_leaf(tri_ids, lo, hi)

    l_hi = hi.copy(); l_hi[axis] = value
    r_lo = lo.copy(); r_lo[axis] = value

    idx = b.add_split(lo, hi, value, axis)
    l_index = _build_recursive(b, l_ids, lo, l_hi, depth - 1)
    r_index = _build_recursive(b, r_ids, r_lo, hi, depth - 1)
    b.child_lo[idx] = l_index
    b.child_hi[idx] = r_index
    return idx


def _optimize_rope(rope: int, node_lo, node_hi, axis_arr, value_arr,
                   is_leaf_arr, cl_arr, ch_arr, face: int) -> int:
    """Push a rope down its subtree while it can't straddle the face
    (reference optimize_rope, src/kd_tree.c:43-62)."""
    if rope == -1:
        return -1
    while not is_leaf_arr[rope]:
        ax = axis_arr[rope]
        if face // 2 == ax:
            break
        value = value_arr[rope]
        if value >= node_hi[ax]:
            rope = cl_arr[rope]
        elif value <= node_lo[ax]:
            rope = ch_arr[rope]
        else:
            break
    return rope


def _add_ropes(b_arrays: dict) -> np.ndarray:
    """Attach 6 neighbor links to every leaf (reference add_ropes,
    src/kd_tree.c:64-83). Iterative preorder walk with an explicit stack."""
    n = len(b_arrays["is_leaf"])
    is_leaf = b_arrays["is_leaf"]
    axis_arr = b_arrays["split_axis"]
    value_arr = b_arrays["split_value"]
    cl = b_arrays["child_lo"]
    ch = b_arrays["child_hi"]
    nmin = b_arrays["node_min"]
    nmax = b_arrays["node_max"]

    ropes_out = np.full((n, 6), -1, np.int32)
    stack = [(0, [-1] * 6)]
    while stack:
        index, ropes = stack.pop()
        if is_leaf[index]:
            ropes_out[index] = ropes
            continue
        opt = [
            _optimize_rope(ropes[f], nmin[index], nmax[index], axis_arr,
                           value_arr, is_leaf, cl, ch, f)
            for f in range(6)
        ]
        ax = axis_arr[index]
        ropes0 = list(opt)
        ropes0[2 * ax + 1] = ch[index]  # left child's +axis face → right child
        ropes1 = list(opt)
        ropes1[2 * ax] = cl[index]      # right child's -axis face → left child
        stack.append((ch[index], ropes1))
        stack.append((cl[index], ropes0))
    return ropes_out


def pack_quads_host(tri_indices: np.ndarray,
                    tri_verts: np.ndarray) -> np.ndarray:
    """Host-side quad-row packing (numpy twin of traverse_fast.pack_quads):
    [T/4, 64] rows of 4 x (v0, e1, e2, tri_id, pad)."""
    idx = np.asarray(tri_indices)
    safe = np.maximum(idx, 0)
    tv = np.asarray(tri_verts, np.float32)
    a = tv[safe, 0]
    e1 = tv[safe, 1] - a
    e2 = tv[safe, 2] - a
    rows16 = np.zeros((idx.shape[0], 16), np.float32)
    rows16[:, 0:3] = a
    rows16[:, 3:6] = e1
    rows16[:, 6:9] = e2
    rows16[:, 9] = idx.astype(np.float32)
    return rows16.reshape(-1, 64)


def tree_from_node_table(table: np.ndarray, tri_indices: np.ndarray,
                         tri_verts: np.ndarray = None) -> FlatKdTree:
    """Reconstruct the full column layout from a packed [M, 24] node table
    (the native builder's output; inverse of traverse_fast.pack_node_table).
    """
    # node/tri ids ride the table as f32: enforce the same exactness guard
    # the Python packer applies (pack_node_table) — the native path must
    # fail loudly, not round ids silently (ADVICE r1)
    m = table.shape[0]
    assert m < (1 << 24), f"{m} nodes overflows f32-exact int range"
    assert tri_indices.shape[0] < (1 << 24), (
        f"{tri_indices.shape[0]} tri slots overflows f32-exact int range")
    flags = table[:, 7].astype(np.int32)
    is_leaf = flags >= 4
    leaf_start = table[:, 10].astype(np.int32) * 4
    leaf_count = table[:, 11].astype(np.int32)
    return FlatKdTree(
        node_min=jnp.asarray(table[:, 0:3]),
        node_max=jnp.asarray(table[:, 3:6]),
        is_leaf=jnp.asarray(is_leaf),
        split_axis=jnp.asarray(flags & 3),
        split_value=jnp.asarray(table[:, 6]),
        child_lo=jnp.asarray(table[:, 8].astype(np.int32)),
        child_hi=jnp.asarray(table[:, 9].astype(np.int32)),
        leaf_start=jnp.asarray(leaf_start),
        leaf_count=jnp.asarray(leaf_count),
        ropes=jnp.asarray(table[:, 12:18].astype(np.int32)),
        tri_indices=jnp.asarray(tri_indices),
        node_table=jnp.asarray(table),
        quads=(jnp.asarray(pack_quads_host(tri_indices, tri_verts))
               if tri_verts is not None else None),
    )


def build_kd_tree(tri_verts: np.ndarray, max_depth: int = DEFAULT_DEPTH,
                  leaf_size: int = 1, tri_block: int = 1,
                  backend: str = "auto") -> FlatKdTree:
    """Build the SAH kd-tree with ropes.

    tri_verts: [F, 3, 3] f32 triangle corner positions (host numpy).
    max_depth: recursion cap (reference DEPTH=15).
    leaf_size: stop splitting at ≤ this many triangles (reference: 1).
    tri_block: pad each leaf's triangle list to a multiple of this with -1
      sentinels — lets the device intersector test fixed-size blocks with
      no tail logic. 1 = reference-exact compact layout.
    backend: "auto" (native C++ when available for tri_block=4, else
      numpy), "native", or "python".

    Mirrors build_kd's precompute (src/kd_tree.c:212-228): per-triangle
    area = |cross(B-A, C-A)| / 2 and the world AABB from vertex extremes.
    """
    if backend in ("auto", "native") and tri_block == 4:
        from clpathtracer_tpu.accel import native
        try:
            table, tri_indices = native.build_kd_native(
                np.asarray(tri_verts, np.float32), max_depth,
                max(1, leaf_size), tri_block)
            return tree_from_node_table(table, tri_indices,
                                        tri_verts=tri_verts)
        except native.NativeBuildError:
            if backend == "native":
                raise
    tri_verts = np.asarray(tri_verts, np.float64)
    assert tri_verts.ndim == 3 and tri_verts.shape[1:] == (3, 3), tri_verts.shape
    nf = tri_verts.shape[0]

    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    vmin_c = tri_verts.min(axis=1)
    vmax_c = tri_verts.max(axis=1)
    lo = vmin_c.min(axis=0)
    hi = vmax_c.max(axis=0)

    b = _Builder(
        node_min=[], node_max=[], is_leaf=[], split_axis=[], split_value=[],
        child_lo=[], child_hi=[], leaf_start=[], leaf_count=[],
        tri_indices=[], leaf_size=max(1, leaf_size),
        vmin_c=vmin_c, vmax_c=vmax_c, area=area,
    )
    _build_recursive(b, np.arange(nf, dtype=np.int64), lo.copy(), hi.copy(),
                     max_depth)

    arrays = {
        "node_min": np.asarray(b.node_min, np.float32),
        "node_max": np.asarray(b.node_max, np.float32),
        "is_leaf": np.asarray(b.is_leaf, bool),
        "split_axis": np.asarray(b.split_axis, np.int32),
        "split_value": np.asarray(b.split_value, np.float32),
        "child_lo": np.asarray(b.child_lo, np.int32),
        "child_hi": np.asarray(b.child_hi, np.int32),
        "leaf_start": np.asarray(b.leaf_start, np.int32),
        "leaf_count": np.asarray(b.leaf_count, np.int32),
    }
    arrays["ropes"] = _add_ropes(arrays)
    tri_indices = np.asarray(b.tri_indices, np.int32)

    if tri_block > 1:
        tri_indices, arrays = _pad_leaves(tri_indices, arrays, tri_block)

    node_table = None
    quads = None
    if tri_block == 4:
        from clpathtracer_tpu.ops.traverse_fast import pack_node_table
        node_table = jnp.asarray(pack_node_table(arrays))
        quads = jnp.asarray(pack_quads_host(tri_indices, tri_verts))

    return FlatKdTree(
        node_table=node_table,
        quads=quads,
        node_min=jnp.asarray(arrays["node_min"]),
        node_max=jnp.asarray(arrays["node_max"]),
        is_leaf=jnp.asarray(arrays["is_leaf"]),
        split_axis=jnp.asarray(arrays["split_axis"]),
        split_value=jnp.asarray(arrays["split_value"]),
        child_lo=jnp.asarray(arrays["child_lo"]),
        child_hi=jnp.asarray(arrays["child_hi"]),
        leaf_start=jnp.asarray(arrays["leaf_start"]),
        leaf_count=jnp.asarray(arrays["leaf_count"]),
        ropes=jnp.asarray(arrays["ropes"]),
        tri_indices=jnp.asarray(tri_indices),
    )


def _pad_leaves(tri_indices: np.ndarray, arrays: dict, block: int):
    """Re-lay leaf triangle lists padded to multiples of `block` with -1."""
    is_leaf = arrays["is_leaf"]
    starts = arrays["leaf_start"]
    counts = arrays["leaf_count"]
    new_indices = []
    new_starts = starts.copy()
    for i in np.flatnonzero(is_leaf):
        s, c = int(starts[i]), int(counts[i])
        new_starts[i] = len(new_indices)
        seg = list(tri_indices[s:s + c])
        pad = (-c) % block
        seg += [-1] * pad
        new_indices.extend(seg)
    arrays = dict(arrays)
    arrays["leaf_start"] = new_starts.astype(np.int32)
    return np.asarray(new_indices, np.int32), arrays


def attach_shadow_tree(tree: FlatKdTree, tri_verts: np.ndarray,
                       leaf_size: int = 16,
                       max_depth: int = 26) -> FlatKdTree:
    """Attach a second kd-tree tuned for the per-ray walks of path mode
    (traverse_fast any_hit + t_max for NEE shadow rays, nearest-hit for
    surface-scene bounces).

    The walk's cost is quad steps until the first hit, so small leaves
    (16 tris, depth 26) suit it far better than the fat leaves a
    primary-ray tree may be built with. Costs ~1x the triangle bytes of
    device memory.
    """
    sub = build_kd_tree(np.asarray(tri_verts, np.float32),
                        max_depth=max_depth, leaf_size=leaf_size,
                        tri_block=4)
    return tree.replace(shadow=sub)


def attach_walk_table(tree: FlatKdTree) -> FlatKdTree:
    """Attach fused one-gather walk rows (ops/traverse_fast.py::
    build_walk_table): the same traversal with one 128-wide row gather
    per step instead of a node row plus a quad row. The table is ~10x
    the node table's bytes, so whether it pays depends on how gathers
    scale with table size on the device; not attached by default."""
    from clpathtracer_tpu.ops.traverse_fast import build_walk_table
    if tree.node_table is None or tree.quads is None:
        return tree
    return tree.replace(walk128=jnp.asarray(
        build_walk_table(np.asarray(tree.node_table),
                         np.asarray(tree.quads))))


def attach_grid(tree: FlatKdTree, tri_verts: np.ndarray, res=None,
                density: float = 1.0) -> FlatKdTree:
    """Attach a uniform grid (accel/grid.py) for per-ray DDA queries.

    The right accelerator for fog-like scenes (uniform triangle density):
    render/integrator.py::_occluded prefers it over the shadow kd-tree,
    and intersect_scene's incoherent-wave branch can route bounce
    nearest-hit queries through it (CLPT_BOUNCE_GRID). Like the shadow
    tree this is a per-scene tuning choice, not a default — surface
    meshes with wildly varying density stay on the kd walk.
    """
    from clpathtracer_tpu.accel.grid import build_grid
    sub = build_grid(np.asarray(tri_verts, np.float32), res=res,
                     density=density)
    return tree.replace(grid=sub)
