"""Device mesh + sharded rendering.

The reference's only parallelism is a width x height NDRange on ONE OpenCL
device (src/CLState.c:209-211); there is no multi-device anything. This
module lifts the per-pixel data parallelism across devices the XLA way:
a `jax.sharding.Mesh`, sharding annotations on the ray wavefront, and GSPMD
partitioning of the (embarrassingly ray-parallel) render — collectives are
inserted by the compiler, never hand-written (SURVEY.md §2/§5).

Axes:
  "rows": image scanline axis — pure data parallelism over pixels (the
          NDRange analogue, lifted across chips).
  "scene": treelet/primitive sharding for scenes too large to replicate
          (parallel/treelet.py) — kept in the same mesh so both modes
          compose.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu.render.integrator import RenderOptions, render_rays


def default_mesh(devices=None, scene_parallel: int = 1,
                 axis_names=("rows", "scene")) -> Mesh:
    """A (rows, scene) mesh over all (or the given) devices.

    scene_parallel: how many ways to split the scene axis (1 = replicate
    the scene everywhere, the common case — matches the reference, which
    uploads the whole scene to its one device, src/CLState.c:124-202).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    assert n % scene_parallel == 0, (n, scene_parallel)
    grid = np.array(devices).reshape(n // scene_parallel, scene_parallel)
    return Mesh(grid, axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, rank: int = 3) -> NamedSharding:
    """Sharding that splits the leading (row) axis over the "rows" axis."""
    return NamedSharding(mesh, P(*(("rows",) + (None,) * (rank - 1))))


def make_sharded_renderer(opts: RenderOptions, mesh: Mesh):
    """Compile a data-parallel renderer: rows of the image sharded over the
    mesh "rows" axis, scene/tree/camera replicated.

    Returns render(scene, camera, tree, key) -> [H, W, 3] image sharded
    over rows. One XLA program per frame; GSPMD splits every per-ray op
    across chips because the output carries a row sharding and every op in
    between is per-ray.
    """
    n_rows = mesh.shape["rows"]
    assert opts.height % n_rows == 0, (
        f"height {opts.height} not divisible by rows axis {n_rows}")

    def impl(scene, camera, tree, key):
        cam_inv = cam_matrix(camera, opts.height)
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        # [H*W, 3] row-major — constrain the wavefront axis so the whole
        # per-ray pipeline partitions without resharding
        spec = NamedSharding(mesh, P("rows", None))
        orig = jax.lax.with_sharding_constraint(orig, spec)
        dir = jax.lax.with_sharding_constraint(dir, spec)
        img = render_rays(scene, tree, orig, dir, opts, key)
        return img.reshape(opts.height, opts.width, 3)

    return jax.jit(impl, out_shardings=row_sharded(mesh, rank=3))


def render_image_sharded(scene, camera, opts: RenderOptions, tree=None,
                         mesh: Mesh = None, key=None):
    """One-shot data-parallel render (see make_sharded_renderer; prefer that
    for render loops so the compiled function is reused)."""
    if mesh is None:
        mesh = default_mesh()
    repl = replicated(mesh)
    scene = jax.device_put(scene, repl)
    camera = jax.device_put(camera, repl)
    if tree is not None:
        tree = jax.device_put(tree, repl)
    if key is not None:
        key = jax.device_put(key, repl)
    return make_sharded_renderer(opts, mesh)(scene, camera, tree, key)
