"""Silhouette fitting: recover an occluder's depth from a target image
using edge-aware (silhouette-reparameterized) gradients.

With normals-as-color shading the interior gradient of this scene is
exactly zero — ALL signal comes from the silhouette sweeping across
pixels, which a detached-topology renderer cannot see. Setting
`RenderOptions.edge_aware=True` blends a one-pixel band at visibility
edges toward the continuation ray's shading, so jax.grad carries the
boundary term (diff/edges.py rationale; implementation:
render/integrator.py::shade_edgeaware) and the standard train step
moves the occluder.

Usage: python examples/silhouette_fitting.py [--cpu]
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if "--cpu" in sys.argv:  # as the CLI: pin to the CPU only when asked
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from clpathtracer_tpu import Camera  # noqa: E402
from clpathtracer_tpu.parallel import default_mesh, make_train_step  # noqa: E402
from clpathtracer_tpu.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu.scene.procedural import _quad  # noqa: E402
from clpathtracer_tpu.scene.scene import Scene  # noqa: E402
from clpathtracer_tpu.utils.device import enable_compile_cache  # noqa: E402


def occluder_scene(dz):
    """A tilted backdrop plus a floating occluder quad at z = 1 + dz."""
    verts = jnp.asarray([
        [-4.0, -4.0, 2.0], [4.0, -4.0, 2.0],
        [4.0, 4.0, 3.0], [-4.0, 4.0, 3.0],
        [-0.35, -0.35, 1.0], [0.35, -0.35, 1.0],
        [0.35, 0.35, 1.0], [-0.35, 0.35, 1.0],
    ], jnp.float32)
    verts = verts.at[4:, 2].add(dz)
    faces = _quad(3, 2, 1, 0) + _quad(7, 6, 5, 4)
    normals = jnp.asarray([[0.0, 0.124, -0.992],
                           [0.0, 0.0, -1.0]], jnp.float32)
    f = jnp.asarray([[[i, 0 if k < 2 else 1, 0] for i in tri]
                     for k, tri in enumerate(faces)], jnp.int32)
    return Scene.create(verts, f, normals=normals)


def main():
    enable_compile_cache()
    opts = dataclasses.replace(
        RenderOptions(width=48, height=48, mode="normal", use_tree=False,
                      background=1.0),
        differentiable=True, edge_aware=True)
    cam = Camera.create(position=[0.011, 0.007, -1.0],
                        forward=[0.0, 0.0, 1.0])
    target_dz = 0.25
    target = np.asarray(render_image(occluder_scene(target_dz), cam, opts))

    mesh = default_mesh(jax.devices()[:1])
    scene0 = occluder_scene(0.0)
    # rigid-z fit: mask the update to the occluder's z coordinates (the
    # full-vertex problem is ill-conditioned on purpose-built fixtures
    # like this; real meshes would use a pose/deformation basis). The
    # silhouette band is ~1 px of 48^2 pixels, so per-vertex gradients
    # are ~1e-4 -- hence the large lr on the masked direction.
    # the mask is BUILT inside the traced update from the gradient
    # itself (zeros_like + .at[].set) rather than closure-captured as a
    # jnp constant — the repo's constant-free-jaxpr rule (CLAUDE.md:
    # jax 0.9 drops hoisted constants when re-executing cached
    # multi-device grad computations)
    def masked_sgd(lr):
        def init_fn(params):
            return optax.EmptyState()

        def update_fn(updates, state, params=None):
            def rigid_z(g):
                return jnp.zeros_like(g).at[4:, 2].set(-lr * g[4:, 2])
            return jax.tree.map(rigid_z, updates), state
        return optax.GradientTransformation(init_fn, update_fn)

    step, init = make_train_step(scene0, opts, mesh, masked_sgd(150.0),
                                 tree=None, param_fields=("verts",))
    state = init()
    key = jax.random.PRNGKey(0)
    for i in range(60):
        state, loss = step(state, cam, jnp.asarray(target), key)
        if i % 10 == 0:
            dz_now = float(np.asarray(state.params["verts"])[4:, 2].mean()
                           - 1.0)
            print(f"step {i:3d}  loss {float(loss):.3e}  "
                  f"occluder dz {dz_now:+.4f} (target {target_dz:+.4f})")
    dz_final = float(np.asarray(state.params["verts"])[4:, 2].mean() - 1.0)
    print(f"final occluder dz {dz_final:+.4f} (target {target_dz:+.4f}); "
          f"moved {'toward' if dz_final > 0 else 'AWAY FROM'} the target "
          "purely on silhouette gradient")


if __name__ == "__main__":
    main()
