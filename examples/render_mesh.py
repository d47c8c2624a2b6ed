"""Render a mesh to PNG — the reference's core loop as six lines of API.

Usage:
    python examples/render_mesh.py [model.obj] [out.png]

Without a model argument, renders the procedural terrain (1M-triangle
version of this scene is the surface perf fixture). Runs on the default
device; pass --cpu to pin to the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:  # as the CLI: pin to the CPU only when asked
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from clpathtracer_tpu import Camera  # noqa: E402
from clpathtracer_tpu.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu.utils.device import enable_compile_cache  # noqa: E402
from clpathtracer_tpu.utils.png import tonemap, write_png  # noqa: E402


def main():
    enable_compile_cache()
    out = sys.argv[2] if len(sys.argv) > 2 else "out.png"
    if len(sys.argv) > 1:
        from clpathtracer_tpu.scene.cache import load_model
        scene, tree = load_model(sys.argv[1], leaf_size=64, max_depth=18)
        cam = Camera.create(position=[0.0, 0.1, -0.4],
                            forward=[0.0, 0.0, 1.0])
    else:
        from clpathtracer_tpu.accel.sah import build_kd_tree
        from clpathtracer_tpu.scene.procedural import terrain_mesh
        scene = terrain_mesh(50_000)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, leaf_size=64, max_depth=16, tri_block=4)
        cam = Camera.create(position=[6.0, 12.0, -10.0],
                            forward=[-0.4, -0.8, 0.8])

    opts = RenderOptions(width=256, height=256, mode="normal")
    img = render_image(scene, cam, opts, tree=tree)
    write_png(out, tonemap(np.asarray(img)))
    print(f"wrote {out} ({scene.num_tris} tris)")


if __name__ == "__main__":
    main()
