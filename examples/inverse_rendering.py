"""Inverse rendering: recover the Cornell walls' albedo from a target
image by gradient descent through the differentiable renderer — the
capability axis the reference (forward-only OpenCL viewer) doesn't have.

(Albedo is fully identifiable from a path-traced image; vertex positions
are too, but only along directions that change visible shading — the
FD-validated vertex gradients live in tests/test_grad.py.)

Runs on every local device (rows-sharded pixels, gradient all-reduce);
with --cpu, on a simulated 8-device CPU mesh.

Usage: python examples/inverse_rendering.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if "--cpu" in sys.argv:  # as the CLI: pin to the CPU only when asked
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from clpathtracer_tpu import Camera  # noqa: E402
from clpathtracer_tpu.accel.sah import build_kd_tree  # noqa: E402
from clpathtracer_tpu.parallel import default_mesh, make_train_step  # noqa: E402
from clpathtracer_tpu.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu.scene.procedural import cornell_box  # noqa: E402
from clpathtracer_tpu.utils.device import enable_compile_cache  # noqa: E402


def main():
    enable_compile_cache()
    scene = cornell_box(light=True)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0.0, 0.0, 1.0])
    opts = RenderOptions(width=48, height=48, mode="path", bounces=2,
                         background=0.0, differentiable=True)
    key = jax.random.PRNGKey(0)

    # ground truth image with the true materials, then start from grey
    target = render_image(scene, cam, opts, tree=tree, key=key)
    truth = np.asarray(scene.albedo)
    grey = scene.replace(albedo=np.full_like(truth, 0.5))

    mesh = default_mesh()  # (rows, scene) over all local devices
    step, init = make_train_step(grey, opts, mesh, optax.adam(3e-2),
                                 tree=tree, param_fields=("albedo",))
    state = init()
    target = jax.device_put(
        target, NamedSharding(mesh, P("rows", None, None)))

    for i in range(80):
        # fixed key: same MC sample per step → deterministic convergence
        state, loss = step(state, cam, target, key)
        if i % 20 == 0:
            err = float(np.abs(np.clip(
                np.asarray(state.params["albedo"]), 0, 1) - truth).mean())
            print(f"step {i:3d}: loss {float(loss):.6f}  "
                  f"mean albedo error {err:.4f}")
    err = float(np.abs(np.clip(
        np.asarray(state.params["albedo"]), 0, 1) - truth).mean())
    print(f"final mean albedo error: {err:.4f} (started at ~0.25)")


if __name__ == "__main__":
    main()
