"""Diagnostics: traversal-cost heatmaps and tree-quality metrics.

The reference carries a per-ray traversal step counter whose only consumer
is commented-out heatmap shading (src/kernel.cl:319-331, 373-380, 390-394).
Here it is a first-class output channel: per-pixel wavefront iteration
counts for tree-quality diagnostics, plus a colorized rendering of them.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np

from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu.ops.traverse import PackedTris, traverse
from clpathtracer_tpu.render.integrator import RenderOptions


@partial(jax.jit, static_argnames=("opts",))
def traversal_steps_image(scene, camera, opts: RenderOptions, tree):
    """[H, W] i32 image of wavefront traversal iterations per primary ray."""
    cam_inv = cam_matrix(camera, opts.height)
    orig, dir = generate_rays(cam_inv, opts.width, opts.height)
    v0, v1, v2 = scene.tri_verts()
    packed = PackedTris.pack(tree, v0, v1, v2)
    rec = traverse(tree, packed, orig, dir, tri_block=opts.tri_block,
                   max_iters=opts.max_iters)
    return rec["steps"].reshape(opts.height, opts.width)


def colorize_heatmap(steps: np.ndarray, max_steps: int = None) -> np.ndarray:
    """Steps → RGB: black (0) through red to yellow/white (hot spots) —
    the shading the reference sketched at src/kernel.cl:373-380."""
    s = np.asarray(steps, np.float32)
    m = float(max_steps if max_steps is not None else max(s.max(), 1.0))
    x = np.clip(s / m, 0.0, 1.0)
    r = np.clip(3.0 * x, 0, 1)
    g = np.clip(3.0 * x - 1.0, 0, 1)
    b = np.clip(3.0 * x - 2.0, 0, 1)
    return np.stack([r, g, b], axis=-1)


def traversal_report(scene, camera, opts: RenderOptions, tree) -> dict:
    """Aggregate traversal-cost metrics for a view (rays/s denominators:
    steps/ray and the tree stats the reference printfs,
    src/kd_tree.c:232-235)."""
    steps = np.asarray(traversal_steps_image(scene, camera, opts, tree))
    return {
        "mean_steps_per_ray": float(steps.mean()),
        "max_steps_per_ray": int(steps.max()),
        "p99_steps_per_ray": float(np.percentile(steps, 99)),
        **{f"tree_{k}": v for k, v in tree.stats().items()},
    }
