"""Scene-parallel (treelet-sharded) intersection must agree with the
single-tree renderer on the simulated mesh (SURVEY §5: primitives sharded
over the "scene" axis, hits min-reduced with collectives)."""

import numpy as np
import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera, cam_matrix, generate_rays
from clpathtracer_tpu.ops.traverse_fast import pack_quads, traverse_fast
from clpathtracer_tpu.parallel.mesh import default_mesh
from clpathtracer_tpu.parallel.treelet import (
    build_sharded_tree, intersect_sharded, morton_order)
from clpathtracer_tpu.scene.procedural import icosphere, random_tri_soup


def test_morton_order_is_permutation():
    pts = np.random.default_rng(0).random((1000, 3))
    order = morton_order(pts)
    assert sorted(order) == list(range(1000))


def _rays(scene, w=32, h=32, pos=(0.0, 0.0, -4.0)):
    cam = Camera.create(position=list(pos), forward=[0.0, 0.0, 1.0])
    cam_inv = cam_matrix(cam, h)
    return generate_rays(cam_inv, w, h)


def test_sharded_matches_single_tree():
    scene = random_tri_soup(4000, seed=2, extent=2.0, tri_size=0.05)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    orig, dir = _rays(scene)

    # single-tree reference
    tree = build_kd_tree(tv, tri_block=4)
    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    ref = traverse_fast(tree, quads, orig, dir)

    # 2-way scene shard on a (rows=4, scene=2) mesh
    mesh = default_mesh(scene_parallel=2)
    stree = build_sharded_tree(tv, n_shards=2)
    rec = jax.jit(lambda o, d: intersect_sharded(
        stree, scene, o, d, mesh))(orig, dir)

    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(rec["hit"]))
    h = np.asarray(ref["hit"])
    np.testing.assert_allclose(np.asarray(ref["t"])[h],
                               np.asarray(rec["t"])[h], rtol=1e-5)
    # triangle ids agree wherever the hit is unambiguous (t strictly
    # unique); exact-tie winners may differ across shard boundaries
    t_ref = np.asarray(ref["t"])
    np.testing.assert_array_equal(np.asarray(ref["tri"])[h],
                                  np.asarray(rec["tri"])[h])


def test_sharded_icosphere_image_parity():
    scene = icosphere(2)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    orig, dir = _rays(scene, pos=(0.0, 0.0, -1.0))

    tree = build_kd_tree(tv, tri_block=4)
    quads = pack_quads(tree.tri_indices, v0, v1, v2)
    ref = traverse_fast(tree, quads, orig, dir)

    mesh = default_mesh(scene_parallel=4)  # rows=2, scene=4
    stree = build_sharded_tree(tv, n_shards=4)
    rec = jax.jit(lambda o, d: intersect_sharded(
        stree, scene, o, d, mesh))(orig, dir)
    np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                  np.asarray(rec["hit"]))
    h = np.asarray(ref["hit"])
    np.testing.assert_allclose(np.asarray(ref["t"])[h],
                               np.asarray(rec["t"])[h], rtol=1e-5)


class TestTreeletRing:
    """ppermute ring rotation (intersect_ring / make_treelet_renderer /
    scene-parallel train step) — SURVEY §5's ring-attention analogue."""

    def _soup(self, n=4000):
        scene = random_tri_soup(n, seed=2, extent=2.0, tri_size=0.05)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        return scene, tv, (v0, v1, v2)

    def test_sequential_ring_matches_single_tree(self):
        from clpathtracer_tpu.parallel.treelet import intersect_ring
        scene, tv, (v0, v1, v2) = self._soup()
        orig, dir = _rays(scene)
        tree = build_kd_tree(tv, tri_block=4)
        quads = pack_quads(tree.tri_indices, v0, v1, v2)
        ref = traverse_fast(tree, quads, orig, dir)
        stree = build_sharded_tree(tv, n_shards=4)
        rec = jax.jit(lambda o, d: intersect_ring(stree, o, d))(orig, dir)
        np.testing.assert_array_equal(np.asarray(ref["hit"]),
                                      np.asarray(rec["hit"]))
        h = np.asarray(ref["hit"])
        np.testing.assert_allclose(np.asarray(ref["t"])[h],
                                   np.asarray(rec["t"])[h], rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(ref["tri"])[h],
                                      np.asarray(rec["tri"])[h])

    def test_distributed_ring_bit_matches_sequential(self):
        """8-device (rows=4, scene=2) ppermute ring vs the sequential loop:
        hit/t must match bitwise (VERDICT r1 'done' criterion)."""
        from clpathtracer_tpu.parallel.treelet import intersect_ring
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        scene, tv, _ = self._soup()
        orig, dir = _rays(scene)
        stree = build_sharded_tree(tv, n_shards=2)
        seq = jax.jit(lambda o, d: intersect_ring(stree, o, d))(orig, dir)

        mesh = default_mesh(scene_parallel=2)
        ring = shard_map(
            lambda st, o, d: intersect_ring(st, o, d, axis_name="scene"),
            mesh=mesh,
            in_specs=(P("scene"), P(("rows", "scene"), None),
                      P(("rows", "scene"), None)),
            out_specs=P(("rows", "scene")),
        )
        dist = jax.jit(lambda st, o, d: ring(st, o, d))(stree, orig, dir)
        np.testing.assert_array_equal(np.asarray(seq["hit"]),
                                      np.asarray(dist["hit"]))
        h = np.asarray(seq["hit"])
        np.testing.assert_array_equal(np.asarray(seq["t"])[h],
                                      np.asarray(dist["t"])[h])

    def test_treelet_renderer_matches_replicated_image(self):
        """make_treelet_renderer (full frame through the ring inside
        shard_map) vs the replicated single-device render: bit parity on
        the soup scene (no cross-block exact-t ties there)."""
        from clpathtracer_tpu.parallel.treelet import make_treelet_renderer
        from clpathtracer_tpu.render.integrator import (
            RenderOptions, render_image)
        scene, tv, _ = self._soup()
        tree = build_kd_tree(tv, tri_block=4)
        stree = build_sharded_tree(tv, n_shards=2)
        cam = Camera.create(position=[0.0, 0.0, -4.0],
                            forward=[0.0, 0.0, 1.0])
        opts = RenderOptions(width=32, height=32, mode="normal")
        ref = np.asarray(render_image(scene, cam, opts, tree=tree))
        mesh = default_mesh(scene_parallel=2)
        render = make_treelet_renderer(opts, mesh)
        img = np.asarray(render(stree, scene, cam, None))
        np.testing.assert_array_equal(ref, img)

    def test_scene_parallel_train_step(self):
        """make_train_step with a ShardedTree: one step on the (rows=4,
        scene=2) mesh — finite loss, nonzero vert gradient flow."""
        import optax
        from clpathtracer_tpu.parallel.train import make_train_step
        from clpathtracer_tpu.render.integrator import (
            RenderOptions, render_image)
        scene, tv, _ = self._soup(1000)
        tree = build_kd_tree(tv, tri_block=4)
        stree = build_sharded_tree(tv, n_shards=2)
        cam = Camera.create(position=[0.0, 0.0, -4.0],
                            forward=[0.0, 0.0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="normal",
                             differentiable=True)
        target = render_image(scene, cam, opts, tree=tree)
        mesh = default_mesh(scene_parallel=2)
        step, init = make_train_step(scene, opts, mesh, optax.adam(1e-3),
                                     tree=stree,
                                     param_fields=("verts",))
        state = init()
        from jax.sharding import NamedSharding, PartitionSpec as P
        target = jax.device_put(
            target, NamedSharding(mesh, P(None, None, None)))
        state2, loss = step(state, cam, target, jax.random.PRNGKey(0))
        assert np.isfinite(float(loss))
        moved = np.abs(np.asarray(state2.params["verts"])
                       - np.asarray(state.params["verts"])).max()
        assert moved > 0.0


def test_ring_rotation_is_compute_independent_in_hlo():
    """Evidence for the "rotation issued ahead of compute" claim
    (intersect_ring docstring): in the OPTIMIZED HLO of the 8-device
    ring, every treelet collective-permute consumes only a parameter or
    the previous collective-permute — never a product of the traversal
    loops. The whole rotation chain is dataflow-independent of compute,
    which is exactly the property that lets the scheduler run the
    transfer of block s+1 under block s's traversal (async collective
    start/done pairs wrap these same ops)."""
    import re

    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from clpathtracer_tpu.parallel.treelet import intersect_ring
    scene = random_tri_soup(2000, seed=3, extent=2.0, tri_size=0.05)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    stree = build_sharded_tree(tv, n_shards=8)
    orig, dir = _rays(scene)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 8),
                ("rows", "scene"))

    def local(stree_blk, o, d):
        return intersect_ring(stree_blk, o, d, axis_name="scene")["t"]

    f = shard_map(local, mesh=mesh,
                  in_specs=(P("scene"), P(("rows", "scene")),
                            P(("rows", "scene"))),
                  out_specs=P(("rows", "scene")))
    txt = jax.jit(f).lower(stree, orig, dir).compile().as_text()
    ops = re.findall(r"(%[\w.-]+) = [^=]*collective-permute\((%[\w.-]+)\)",
                     txt)
    # 7 rotations x 2 arrays (node table + quads)
    assert len(ops) == 14, len(ops)
    names = {name for name, _ in ops}
    for name, operand in ops:
        assert ("param" in operand) or (operand in names), (
            f"{name} consumes {operand}: the rotation chain depends on "
            "compute — the overlap property is broken")
