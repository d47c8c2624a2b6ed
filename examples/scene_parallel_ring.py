"""Scene-parallel rendering with the treelet ppermute ring.

For scenes too large to replicate per chip: triangles Morton-partition
into treelet blocks that live sharded over the mesh "scene" axis; during
intersection the blocks rotate around the ring with `ppermute`, the
collective overlapped with local traversal (parallel/treelet.py). This
example shards the scene over up to 4 local devices (with --cpu, over a
simulated 8-device CPU mesh) and checks the image is bit-identical to
the replicated single-tree render.

Usage: python examples/scene_parallel_ring.py [--cpu]
"""

import math
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
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from clpathtracer_tpu import Camera  # noqa: E402
from clpathtracer_tpu.accel.sah import build_kd_tree  # noqa: E402
from clpathtracer_tpu.parallel.mesh import default_mesh  # noqa: E402
from clpathtracer_tpu.parallel.treelet import (  # noqa: E402
    build_sharded_tree, make_treelet_renderer)
from clpathtracer_tpu.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu.scene.procedural import random_tri_soup  # noqa: E402
from clpathtracer_tpu.utils.device import enable_compile_cache  # noqa: E402


def main():
    enable_compile_cache()
    scene = random_tri_soup(20_000, seed=2, extent=2.0, tri_size=0.05)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    cam = Camera.create(position=[0.0, 0.0, -4.0], forward=[0.0, 0.0, 1.0])
    opts = RenderOptions(width=64, height=64, mode="normal")

    # replicated reference render
    tree = build_kd_tree(tv, tri_block=4)
    ref = np.asarray(render_image(scene, cam, opts, tree=tree))

    # up to 4-way scene shard (rows=2, scene=4 on 8 devices): each device
    # holds its share of the acceleration data + geometry
    shards = math.gcd(4, len(jax.devices()))
    mesh = default_mesh(scene_parallel=shards)
    stree = build_sharded_tree(tv, n_shards=shards)
    stree = jax.device_put(stree, NamedSharding(mesh, P("scene")))
    render = make_treelet_renderer(opts, mesh)
    img = np.asarray(render(stree, scene, cam, None))

    print("mesh:", dict(mesh.shape))
    print("blocks:", stree.total_blocks,
          "— per-device quads:", tuple(stree.quads.shape[1:]))
    print("bit-identical to replicated render:", bool((ref == img).all()))


if __name__ == "__main__":
    main()
