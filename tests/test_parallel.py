"""Distributed tests on the simulated 8-device CPU mesh (conftest.py).

SURVEY.md §4 layer (4): the same render on 1 vs N devices must be
bit-identical after gather, and the sharded train step must run and reduce
loss — validating that GSPMD partitions the whole per-ray pipeline and
inserts the gradient all-reduce.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera
from clpathtracer_tpu.parallel import (
    default_mesh, make_train_step, render_image_sharded)
from clpathtracer_tpu.render.integrator import RenderOptions, render_image
from clpathtracer_tpu.scene.procedural import cornell_box, icosphere


def _tree_for(scene, tri_block=4):
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    return build_kd_tree(tv, tri_block=tri_block)


class TestShardedRender:
    def test_8dev_matches_1dev_bitwise(self):
        scene = cornell_box(light=False)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=32, height=32, mode="normal")

        img_1 = np.asarray(render_image(scene, cam, opts, tree=tree))
        mesh = default_mesh()  # all 8 simulated devices on "rows"
        assert mesh.shape["rows"] == 8
        img_8 = np.asarray(render_image_sharded(
            scene, cam, opts, tree=tree, mesh=mesh))
        np.testing.assert_array_equal(img_1, img_8)

    def test_scene_axis_mesh(self):
        """rows x scene mesh (4x2): scene replicated across the scene axis,
        rows split 4 ways — still bit-identical."""
        scene = icosphere(1)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="normal")
        img_1 = np.asarray(render_image(scene, cam, opts, tree=tree))
        mesh = default_mesh(scene_parallel=2)
        assert mesh.shape == {"rows": 4, "scene": 2}
        img_s = np.asarray(render_image_sharded(
            scene, cam, opts, tree=tree, mesh=mesh))
        np.testing.assert_array_equal(img_1, img_s)

    def test_path_mode_sharded(self):
        scene = cornell_box()
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             background=0.0)
        key = jax.random.PRNGKey(5)
        img_1 = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
        img_8 = np.asarray(render_image_sharded(
            scene, cam, opts, tree=tree, mesh=default_mesh(), key=key))
        np.testing.assert_array_equal(img_1, img_8)

    def test_path_mode_sharded_with_grid(self):
        """The uniform-grid DDA walk is pure XLA — GSPMD must partition a
        grid-accelerated path+NEE render bit-identically across 8
        devices (the inline 128-wide table replicates; ray state
        shards)."""
        from clpathtracer_tpu.accel.sah import attach_grid
        from clpathtracer_tpu.scene.procedural import random_tri_soup
        scene = random_tri_soup(2000, seed=8, extent=2.0, tri_size=0.08,
                                emissive_frac=0.02).bake_shading()
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = attach_grid(build_kd_tree(tv, tri_block=4), tv)
        cam = Camera.create(position=[0.0, 0.0, -3.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             nee=True, background=0.0)
        key = jax.random.PRNGKey(6)
        img_1 = np.asarray(render_image(scene, cam, opts, tree=tree,
                                        key=key))
        img_8 = np.asarray(render_image_sharded(
            scene, cam, opts, tree=tree, mesh=default_mesh(), key=key))
        np.testing.assert_array_equal(img_1, img_8)


def _sharded_scene(name):
    from clpathtracer_tpu.accel.sah import attach_grid, attach_shadow_tree
    from clpathtracer_tpu.scene.procedural import (
        random_tri_soup, terrain_mesh)
    if name == "cornell":
        return (cornell_box(), None,
                Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0]))
    if name == "soup":
        scene = random_tri_soup(2000, seed=3, extent=1.0, tri_size=0.08,
                                emissive_frac=0.02)
        attach = attach_grid
        cam = Camera.create(position=[0.0, 0.0, -3.0], forward=[0, 0, 1.0])
    else:
        scene = terrain_mesh(1500, seed=2, extent=1.5, relief=0.4,
                             emissive_frac=0.02)
        attach = attach_shadow_tree
        cam = Camera.create(position=[0.0, 2.5, 0.1],
                            forward=[0.0, -1.0, 0.2])
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    return scene, attach(build_kd_tree(tv, tri_block=4), tv), cam


@pytest.mark.parametrize("mode", ["normal", "mirror", "path"])
@pytest.mark.parametrize("name", ["cornell", "soup", "terrain"])
def test_sharded_wavefront_matches_single(name, mode):
    """make_sharded_renderer over the 8-device mesh against the
    single-device render, per scene (plain tree, grid, shadow tree) and
    shading mode: GSPMD splits the per-ray walks without changing a bit."""
    scene, tree, cam = _sharded_scene(name)
    if tree is None:
        tree = _tree_for(scene)
    opts = RenderOptions(width=16, height=16, mode=mode, bounces=2,
                         nee=(mode == "path"), background=0.0)
    key = jax.random.PRNGKey(9)
    img_1 = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
    img_8 = np.asarray(render_image_sharded(
        scene, cam, opts, tree=tree, mesh=default_mesh(), key=key))
    assert np.isfinite(img_1).all() and np.abs(img_1).sum() > 0
    np.testing.assert_array_equal(img_1, img_8)


class TestDistributedTrain:
    def test_train_step_reduces_loss(self):
        """Inverse rendering: recover perturbed wall albedo from a target
        image (path mode, fixed key → deterministic, near-linear in albedo),
        data-parallel over 8 devices."""
        scene = cornell_box(light=True)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             background=0.0, differentiable=True)
        mesh = default_mesh()
        key = jax.random.PRNGKey(1)

        target = render_image(scene, cam, opts, tree=tree, key=key)
        perturbed = scene.replace(
            albedo=jnp.clip(scene.albedo + 0.2 * jax.random.normal(
                jax.random.PRNGKey(0), scene.albedo.shape), 0.05, 0.95))

        step, init = make_train_step(
            perturbed, opts, mesh, optax.adam(3e-2), tree=tree,
            param_fields=("albedo",))
        state = init()
        target_sharded = jax.device_put(
            target, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("rows", None, None)))

        losses = []
        for i in range(30):
            state, loss = step(state, cam, target_sharded, key)
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


class TestMultihostInit:
    """parallel/multihost.py fail-fast policy, exercised with a mocked
    jax.distributed.initialize: the timeout path is tested without a
    cluster."""

    def test_init_passes_timeout_and_rendezvous_kwargs(self, monkeypatch):
        from clpathtracer_tpu.parallel import multihost
        seen = {}

        def fake_init(**kwargs):
            seen.update(kwargs)
        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        monkeypatch.setattr(jax.distributed, "is_initialized",
                            lambda: False)
        out = multihost.init_distributed(
            coordinator_address="10.0.0.1:1234", num_processes=4,
            process_id=2, initialization_timeout=17)
        assert seen == {"coordinator_address": "10.0.0.1:1234",
                        "num_processes": 4, "process_id": 2,
                        "initialization_timeout": 17}
        assert out["process_count"] == jax.process_count()

    def test_init_failure_raises_immediately(self, monkeypatch):
        """Rendezvous timeout must propagate (fail-fast), never hang or
        be swallowed."""
        from clpathtracer_tpu.parallel import multihost

        def fake_init(**kwargs):
            raise TimeoutError("rendezvous timed out")
        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        monkeypatch.setattr(jax.distributed, "is_initialized",
                            lambda: False)
        with pytest.raises(TimeoutError):
            multihost.init_distributed(initialization_timeout=1)

    def test_init_is_idempotent_with_live_client(self, monkeypatch):
        """A formed process group must not be re-initialized (calling
        initialize twice is a JAX error)."""
        from clpathtracer_tpu.parallel import multihost

        def boom(**kwargs):
            raise AssertionError("initialize called on a live group")
        monkeypatch.setattr(jax.distributed, "initialize", boom)
        monkeypatch.setattr(jax.distributed, "is_initialized",
                            lambda: True)
        out = multihost.init_distributed()
        assert out["local_devices"] >= 1
