"""Reader/writer for the reference's binary `.kd` cache format.

The reference serializes its built tree as raw packed C structs
(src/kd_tree.c:239-274): five sections, each a little-endian size_t count
followed by `count` elements —

  1. kdnode[]      68 B packed (include/kd_tree.h:31-50 under
                   #pragma pack(1)): min/max as cl_float4 (16 B each),
                   int type (0 split / 1 leaf), then a 32 B union —
                   split {f32 value, i32 axis, i32 children[2], 16 B pad}
                   or leaf {i32 tris, i32 tri_count, i32 ropes[6]}
  2. cl_float4[]   vertex positions (xyz used)
  3. cl_float4[]   vertex normals
  4. i32[]         tri_indices (concatenated leaf triangle lists)
  5. cl_int3[]     per-corner (v, vn, vt) index triples, 16 B each
                   (cl_int3 is padded to int4), three per triangle

This module reads those files into Scene + FlatKdTree (the reference
wavefront engine consumes the imported tree directly; tri_block=1 layout,
so the gather-packed walk rebuilds if wanted) and writes our trees back
out so the reference renderer can load caches produced here.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_NODE_DTYPE = np.dtype([
    ("min", "<f4", (4,)),
    ("max", "<f4", (4,)),
    ("type", "<i4"),
    ("u0", "<i4"), ("u1", "<i4"),
    ("u2", "<i4", (6,)),
], align=False)
assert _NODE_DTYPE.itemsize == 68, _NODE_DTYPE.itemsize


def load_reference_kd(path: str):
    """Parse a reference-generated `.kd` file → (Scene, FlatKdTree).

    The tree is the reference's exact structure (compact tri_block=1
    layout, ropes included); pair it with the reference wavefront engine,
    or rebuild with build_kd_tree for the gather-packed walk.
    """
    from clpathtracer_tpu.accel.sah import FlatKdTree
    from clpathtracer_tpu.scene.scene import Scene

    with open(path, "rb") as fh:
        data = fh.read()
    buf = memoryview(data)
    off = 0

    def section(dtype):
        nonlocal off
        count = int(np.frombuffer(buf, "<u8", count=1, offset=off)[0])
        off += 8
        arr = np.frombuffer(buf, dtype, count=count, offset=off).copy()
        off += count * np.dtype(dtype).itemsize
        return arr

    nodes = section(_NODE_DTYPE)
    verts4 = section(np.dtype(("<f4", (4,))))
    norms4 = section(np.dtype(("<f4", (4,))))
    tri_indices = section(np.dtype("<i4"))
    corners = section(np.dtype(("<i4", (4,))))

    verts = verts4[:, :3]
    normals = norms4[:, :3]
    faces = corners[:, :3].reshape(-1, 3, 3)  # [F, corner, (v, vn, vt)]

    is_leaf = nodes["type"] == 1
    node_min = nodes["min"][:, :3]
    node_max = nodes["max"][:, :3]
    split_value = nodes["u0"].view("<f4").copy()
    split_value[is_leaf] = 0.0
    split_axis = np.where(is_leaf, 0, nodes["u1"]).astype(np.int32)
    child_lo = np.where(is_leaf, -1, nodes["u2"][:, 0]).astype(np.int32)
    child_hi = np.where(is_leaf, -1, nodes["u2"][:, 1]).astype(np.int32)
    leaf_start = np.where(is_leaf, nodes["u0"], 0).astype(np.int32)
    leaf_count = np.where(is_leaf, nodes["u1"], 0).astype(np.int32)
    ropes = np.where(is_leaf[:, None], nodes["u2"], -1).astype(np.int32)

    scene = Scene.create(verts, faces, normals if len(normals) else None)
    tree = FlatKdTree(
        node_min=jnp.asarray(node_min), node_max=jnp.asarray(node_max),
        is_leaf=jnp.asarray(is_leaf),
        split_axis=jnp.asarray(split_axis),
        split_value=jnp.asarray(split_value),
        child_lo=jnp.asarray(child_lo), child_hi=jnp.asarray(child_hi),
        leaf_start=jnp.asarray(leaf_start),
        leaf_count=jnp.asarray(leaf_count),
        ropes=jnp.asarray(ropes),
        tri_indices=jnp.asarray(tri_indices.astype(np.int32)),
    )
    return scene, tree


def save_reference_kd(path: str, scene, tree) -> None:
    """Write a `.kd` file the reference renderer can load (parse_kd,
    src/kd_tree.c:278-311). The tree must be compact (tri_block=1 —
    padded -1 slots would crash the reference's double indirection)."""
    tri_indices = np.asarray(tree.tri_indices)
    if (tri_indices < 0).any():
        raise ValueError("tree has padded leaf lists; build with "
                         "tri_block=1 for reference interop")
    is_leaf = np.asarray(tree.is_leaf)
    m = len(is_leaf)
    nodes = np.zeros(m, _NODE_DTYPE)
    nodes["min"][:, :3] = np.asarray(tree.node_min)
    nodes["max"][:, :3] = np.asarray(tree.node_max)
    nodes["type"] = is_leaf.astype(np.int32)
    sv = np.asarray(tree.split_value, np.float32).view("<i4")
    nodes["u0"] = np.where(is_leaf, np.asarray(tree.leaf_start), sv)
    nodes["u1"] = np.where(is_leaf, np.asarray(tree.leaf_count),
                           np.asarray(tree.split_axis))
    ch2 = np.zeros((m, 6), np.int32)
    ch2[:, 0] = np.asarray(tree.child_lo)
    ch2[:, 1] = np.asarray(tree.child_hi)
    nodes["u2"] = np.where(is_leaf[:, None], np.asarray(tree.ropes), ch2)

    v = np.asarray(scene.verts)
    verts4 = np.zeros((len(v), 4), "<f4")
    verts4[:, :3] = v
    nrm = np.asarray(scene.normals)
    norms4 = np.zeros((len(nrm), 4), "<f4")
    norms4[:, :3] = nrm
    corners = np.full((scene.num_tris * 3, 4), 0, "<i4")
    corners[:, :3] = np.asarray(scene.faces).reshape(-1, 3)

    with open(path, "wb") as fh:
        for arr in (nodes, verts4, norms4,
                    tri_indices.astype("<i4"), corners):
            fh.write(np.uint64(len(arr)).tobytes())
            fh.write(arr.tobytes())
