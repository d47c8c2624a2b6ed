"""Differentiable-rendering tests: jax.grad vs central finite differences.

BASELINE north star: pixel gradients w.r.t. camera pose, vertex positions
and materials must match finite differences (the reference has no gradient
capability at all — this axis is new). FD is only valid where the hit
topology is locally constant, so every loss below averages an interior
pixel crop away from silhouettes/edges.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera
from clpathtracer_tpu.diff.fd import fd_grad
from clpathtracer_tpu.render.integrator import RenderOptions, render_image
from clpathtracer_tpu.scene.procedural import cornell_box, icosphere


def _tree_for(scene, tri_block=4):
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    return build_kd_tree(tv, tri_block=tri_block)


class TestCameraGrad:
    """d(loss)/d(camera position): smooth-normal icosphere, central crop."""

    @pytest.mark.parametrize("use_tree", [False, True])
    def test_position_grad_matches_fd(self, use_tree):
        scene = icosphere(2)
        tree = _tree_for(scene) if use_tree else None
        opts = RenderOptions(width=24, height=24, mode="normal",
                             use_tree=use_tree, differentiable=True)

        def loss_fn(pos):
            cam = Camera.create(position=pos, forward=[0.0, 0.0, 1.0])
            img = render_image(scene, cam, opts, tree=tree)
            # central crop: strictly inside the sphere's projection
            return jnp.mean(img[9:15, 9:15])

        pos0 = jnp.array([0.0, 0.0, -1.0], jnp.float32)
        g = jax.grad(loss_fn)(pos0)
        fd = fd_grad(lambda p: loss_fn(jnp.asarray(p, jnp.float32)),
                     np.array(pos0, np.float64), eps=1e-3)
        assert np.isfinite(np.asarray(g)).all()
        np.testing.assert_allclose(np.asarray(g), fd, rtol=0.05, atol=2e-4)


class TestVertexGrad:
    """d(loss)/d(vertex position): flat-shaded wall normal tilts as the
    vertex moves — smooth in the triangle interior."""

    def test_vertex_grad_matches_fd(self):
        scene = cornell_box(light=False)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=24, height=24, mode="normal",
                             use_tree=True, differentiable=True)

        # vertex 0 = back-wall corner (-1,-1,2); crop pixels strictly inside
        # one of the back wall's triangles
        def loss_fn(v0):
            verts = scene.verts.at[0].set(v0)
            s = scene.with_verts(verts)
            img = render_image(s, cam, opts, tree=tree)
            return jnp.mean(img[10:13, 10:13])

        v0 = scene.verts[0]
        g = jax.grad(loss_fn)(v0)
        fd = fd_grad(lambda v: loss_fn(jnp.asarray(v, jnp.float32)),
                     np.array(v0, np.float64), eps=1e-3)
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(fd).max() > 1e-4  # the test must actually test something
        np.testing.assert_allclose(np.asarray(g), fd, rtol=0.05, atol=2e-4)


class TestMaterialGrad:
    """d(loss)/d(albedo, emission) through the path integrator (linear in
    both at one bounce → FD is exact up to float noise)."""

    def test_albedo_emission_grad_matches_fd(self):
        scene = cornell_box(light=True)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             spp=1, background=0.0, use_tree=True,
                             differentiable=True)
        key = jax.random.PRNGKey(3)

        def loss_fn(params):
            s = scene.replace(albedo=params["albedo"],
                              emission=params["emission"])
            img = render_image(s, cam, opts, tree=tree, key=key)
            return jnp.mean(img)

        params = {"albedo": scene.albedo, "emission": scene.emission}
        g = jax.grad(loss_fn)(params)
        # FD over a few scalar entries only (full FD would be 2*F*3 renders)
        jl = jax.jit(lambda a_val, e_val: loss_fn({
            "albedo": scene.albedo.at[0, 0].set(a_val),
            "emission": scene.emission.at[10, 1].set(e_val)}))
        eps = 1e-2
        a0 = float(scene.albedo[0, 0]); e0 = float(scene.emission[10, 1])
        fd_a = (jl(a0 + eps, e0) - jl(a0 - eps, e0)) / (2 * eps)
        fd_e = (jl(a0, e0 + eps) - jl(a0, e0 - eps)) / (2 * eps)
        np.testing.assert_allclose(float(g["albedo"][0, 0]), float(fd_a),
                                   rtol=0.05, atol=3e-4)
        np.testing.assert_allclose(float(g["emission"][10, 1]), float(fd_e),
                                   rtol=0.05, atol=3e-4)


class TestTreeVsBruteforceGrad:
    """The kd-tree path and the linear-scan path must produce the SAME
    gradients (same math, different intersector)."""

    def test_grad_consistency(self):
        scene = icosphere(2)
        tree = _tree_for(scene)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])

        def make_loss(use_tree):
            opts = RenderOptions(width=16, height=16, mode="normal",
                                 use_tree=use_tree, differentiable=True)

            def loss_fn(verts):
                s = scene.with_verts(verts)
                img = render_image(s, cam, opts,
                                   tree=tree if use_tree else None)
                return jnp.mean(img[6:10, 6:10])
            return loss_fn

        g_bf = jax.grad(make_loss(False))(scene.verts)
        g_kd = jax.grad(make_loss(True))(scene.verts)
        np.testing.assert_allclose(np.asarray(g_bf), np.asarray(g_kd),
                                   rtol=1e-4, atol=1e-6)


class TestSilhouetteGrad:
    """Edge-aware gradients (diff/edges.py): the case diff/grad.py scopes
    out. An occluder quad floats in front of a backdrop; the loss crop
    STRADDLES the occluder's silhouette, and the occluder moves along z
    (toward/away from the camera) — with normals-as-color shading the
    interior gradient is exactly zero, so ALL signal is the silhouette
    sweeping across pixels. jax.grad of the edge-aware render must match
    FD within 10% (VERDICT r2 #6); the detached-only renderer's gradient
    is ~0 on the same loss."""

    def _scene(self, dz):
        from clpathtracer_tpu.scene.scene import Scene
        # backdrop: big quad at z=2 tilted so its normal differs from the
        # occluder's (normal-color contrast across the silhouette)
        verts = jnp.asarray([
            # backdrop (tilted 30 deg about x)
            [-4.0, -4.0, 2.0], [4.0, -4.0, 2.0],
            [4.0, 4.0, 3.0], [-4.0, 4.0, 3.0],
            # occluder quad, centered, at z = 1 + dz
            [-0.35, -0.35, 1.0], [0.35, -0.35, 1.0],
            [0.35, 0.35, 1.0], [-0.35, 0.35, 1.0],
        ], jnp.float32)
        verts = verts.at[4:, 2].add(dz)
        from clpathtracer_tpu.scene.procedural import _quad
        # wound so the geometric normal faces the camera (-z): the
        # Moller-Trumbore det>0 cull drops back-facing triangles
        faces = _quad(3, 2, 1, 0) + _quad(7, 6, 5, 4)
        # explicit shading normals with CONTRAST across the silhouette
        # (without normals the scene shades constant gray and the image
        # carries no edge signal at all)
        normals = jnp.asarray([[0.0, 0.124, -0.992],   # backdrop
                               [0.0, 0.0, -1.0]],      # occluder
                              jnp.float32)
        f = jnp.asarray(
            [[[i, 0 if k < 2 else 1, 0] for i in tri]
             for k, tri in enumerate(faces)], jnp.int32)
        return Scene.create(verts, f, normals=normals)

    def test_occluder_depth_grad_matches_fd(self):
        from clpathtracer_tpu.diff.edges import render_edgeaware
        opts = RenderOptions(width=32, height=32, mode="normal",
                             use_tree=False, background=1.0)
        # generic camera position: a perfectly centered camera on this
        # axis-aligned fixture sends pixel-center rays EXACTLY through
        # the occluder's edge (m = 0 -> alpha = 0 -> the pixel shows the
        # continuation), and that continuation then threads the backdrop
        # quad's shared-diagonal seam, where fp watertightness pinholes
        # open or close with XLA's fusion choices — a measure-zero ray
        # set no real scene hits, but one that flips this test's FD by
        # whole pixels
        cam = Camera.create(position=[0.011, 0.007, -1.0],
                            forward=[0.0, 0.0, 1.0])

        def loss_fn(dz):
            img = render_edgeaware(self._scene(dz), cam, opts)
            # crop straddling the occluder's RIGHT silhouette edge
            return jnp.mean(img[8:24, 12:28, :])

        g = float(jax.grad(loss_fn)(jnp.float32(0.0)))
        # FD step sized to sweep the silhouette a fraction of a pixel
        # (inside the blend band, where the smoothed renderer is linear;
        # measured: rel-err < 1% for eps in [2e-3, 2e-2])
        eps = 1e-2
        fd = (float(loss_fn(jnp.float32(eps)))
              - float(loss_fn(jnp.float32(-eps)))) / (2 * eps)
        assert np.isfinite(g) and abs(fd) > 1e-4, (g, fd)
        assert abs(g - fd) <= 0.10 * abs(fd), (g, fd)

        # the detached-topology renderer has (near-)zero gradient on the
        # same loss — the gap this estimator exists to close
        opts_d = RenderOptions(width=32, height=32, mode="normal",
                               use_tree=False, differentiable=True,
                               background=1.0)

        def loss_plain(dz):
            img = render_image(self._scene(dz), cam, opts_d)
            return jnp.mean(img[8:24, 12:28, :])

        g_plain = float(jax.grad(loss_plain)(jnp.float32(0.0)))
        assert abs(g_plain) < 0.05 * abs(fd), (g_plain, fd)

    def test_edgeaware_matches_hard_render_away_from_edges(self):
        """Outside the one-pixel blend band the edge-aware image equals
        the plain render bit-for-bit wherever alpha saturates."""
        from clpathtracer_tpu.diff.edges import render_edgeaware
        opts = RenderOptions(width=32, height=32, mode="normal",
                             use_tree=False, background=1.0)
        cam = Camera.create(position=[0.011, 0.007, -1.0],
                            forward=[0.0, 0.0, 1.0])
        scene = self._scene(0.0)
        a = np.asarray(render_edgeaware(scene, cam, opts))
        b = np.asarray(render_image(scene, cam, opts))
        # the blend may only touch pixels whose hit sits near a triangle
        # boundary (occluder silhouette, or either quad's interior
        # diagonal seam — both fixtures' diagonals cross this view):
        # everywhere the min-barycentric is comfortably above the band,
        # alpha saturates and the images are IDENTICAL
        from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
        from clpathtracer_tpu.render.integrator import intersect_scene
        orig, dirs = generate_rays(cam_matrix(cam, 32), 32, 32)
        rec = intersect_scene(scene, None, orig, dirs, opts)
        u, v = np.asarray(rec["u"]), np.asarray(rec["v"])
        m = np.where(np.asarray(rec["tri"]) >= 0,
                     np.minimum(np.minimum(u, v), 1.0 - u - v), 1.0)
        far = (m > 0.2).reshape(32, 32)
        np.testing.assert_allclose(a[far], b[far], atol=1e-6)
        # non-vacuity: the mask covers a meaningful share of the image
        # (m is in barycentric units, so the backdrop's huge triangles
        # keep wide screen bands below 0.2) and the blend fired somewhere
        assert far.mean() > 0.25
        assert (np.abs(a - b) > 1e-6).any()
        # and the images agree everywhere within the band's reach
        assert (np.abs(a - b) > 1e-6).mean() < 0.30

    def test_path_mode_edge_grad_matches_fd(self):
        """RenderOptions.edge_aware in PATH mode: the blend uses the
        continuation ray's full radiance, and jax.grad of the public
        render_image matches FD on the occluder-depth loss (normals-as-
        albedo contrast; 0 bounces of randomness — bounces=1 makes the
        path integrator deterministic, isolating the silhouette term)."""
        import dataclasses
        opts = dataclasses.replace(
            RenderOptions(width=32, height=32, mode="path", bounces=1,
                          use_tree=False, background=1.0),
            differentiable=True, edge_aware=True)
        cam = Camera.create(position=[0.011, 0.007, -1.0],
                            forward=[0.0, 0.0, 1.0])
        key = jax.random.PRNGKey(3)

        def loss_fn(dz):
            scene = self._scene(dz)
            # albedo contrast across the silhouette (path mode shades
            # albedo*bg radiance at bounce-1 terminations)
            scene = scene.replace(albedo=jnp.asarray(
                [[0.9, 0.1, 0.1]] * 2 + [[0.1, 0.1, 0.9]] * 2,
                jnp.float32))
            img = render_image(scene, cam, opts, key=key)
            return jnp.mean(img[8:24, 12:28, :])

        g = float(jax.grad(loss_fn)(jnp.float32(0.0)))
        eps = 1e-2
        fd = (float(loss_fn(jnp.float32(eps)))
              - float(loss_fn(jnp.float32(-eps)))) / (2 * eps)
        assert np.isfinite(g) and abs(fd) > 1e-4, (g, fd)
        assert abs(g - fd) <= 0.15 * abs(fd), (g, fd)

    def test_train_step_carries_silhouette_gradient(self):
        """make_train_step with RenderOptions.edge_aware: the vertex
        gradient the public training API computes must carry the
        silhouette term — (a) one step's update moves the occluder's
        z coordinates measurably, (b) repeated small steps strictly
        decrease the loss, and (c) the same step WITHOUT edge_aware
        moves them ~100x less (interior-only gradients are ~zero on
        this normals-as-color fixture — the gap this flag closes)."""
        import dataclasses

        import optax

        from clpathtracer_tpu.parallel.mesh import default_mesh
        from clpathtracer_tpu.parallel.train import make_train_step
        cam = Camera.create(position=[0.011, 0.007, -1.0],
                            forward=[0.0, 0.0, 1.0])
        mesh = default_mesh(jax.devices()[:1])
        scene0 = self._scene(0.0)
        base = RenderOptions(width=32, height=32, mode="normal",
                             use_tree=False, background=1.0)
        # lr small enough that the multi-vertex dynamics stay in the
        # descent regime (larger steps tilt the quad and oscillate)
        lr = 0.02
        zmove = {}
        losses = {}
        for ea in (True, False):
            opts = dataclasses.replace(base, differentiable=True,
                                       edge_aware=ea)
            target = np.asarray(render_image(self._scene(0.35), cam,
                                             opts))
            step, init = make_train_step(
                scene0, opts, mesh, optax.sgd(lr), tree=None,
                param_fields=("verts",))
            state = init()
            key = jax.random.PRNGKey(0)
            ls = []
            for i in range(4):
                state, loss = step(state, cam, jnp.asarray(target), key)
                ls.append(float(loss))
            losses[ea] = ls
            dz = (np.asarray(state.params["verts"])[4:, 2]
                  - np.asarray(scene0.verts)[4:, 2])
            zmove[ea] = np.abs(dz).max()
        # (a) silhouette gradient moves the occluder along z
        assert zmove[True] > 5e-5, zmove
        # (b) small steps strictly decrease the edge-aware loss
        la = losses[True]
        assert all(b < a for a, b in zip(la, la[1:])), la
        # (c) without edge_aware the z-gradient is ~zero
        assert zmove[False] < 0.02 * zmove[True], zmove


class TestGridForwardGrad:
    """Differentiable mode with a uniform grid attached (accel/grid.py):
    the DDA walk supplies the detached bounce-wave topology; gradients
    still FD-validate on the emissive-fog configuration (the scene class
    the grid is for)."""

    def test_albedo_grad_matches_fd_with_grid(self):
        from clpathtracer_tpu.accel.sah import attach_grid
        from clpathtracer_tpu.scene.procedural import random_tri_soup
        scene = random_tri_soup(1500, seed=6, extent=1.0, tri_size=0.12,
                                emissive_frac=0.02).bake_shading()
        v0c, v1c, v2c = scene.tri_verts()
        tv = np.stack([np.asarray(v0c), np.asarray(v1c),
                       np.asarray(v2c)], 1)
        tree = attach_grid(_tree_for(scene), tv)
        assert tree.grid is not None
        cam = Camera.create(position=[0.0, 0.0, -2.5], forward=[0, 0, 1.0])
        # NEE: every hit pixel gets an albedo-dependent direct-light
        # term, so gradients reach every visible triangle
        opts = RenderOptions(width=24, height=24, mode="path", bounces=2,
                             spp=1, background=0.0, nee=True,
                             use_tree=True, differentiable=True)
        key = jax.random.PRNGKey(5)
        alb0 = np.asarray(scene.albedo, np.float64)

        def loss_from_scalar(a, i):
            albedo = jnp.asarray(alb0, jnp.float32).at[i, 0].set(
                jnp.asarray(a, jnp.float32))
            s = scene.replace(albedo=albedo)
            img = render_image(s, cam, opts, tree=tree, key=key)
            return jnp.mean(img)

        g = jax.grad(lambda alb: jnp.mean(render_image(
            scene.replace(albedo=alb), cam, opts, tree=tree, key=key)))(
                scene.albedo)
        assert np.isfinite(np.asarray(g)).all()
        i = int(np.abs(np.asarray(g)[:, 0]).argmax())
        assert abs(float(g[i, 0])) > 1e-5  # a pixel actually sees tri i
        fd = fd_grad(lambda a: loss_from_scalar(float(a), i),
                     np.array([alb0[i, 0]]), eps=1e-3)[0]
        np.testing.assert_allclose(float(g[i, 0]), fd, rtol=0.05,
                                   atol=2e-4)


def test_edge_aware_composes_with_spp_path():
    """RenderOptions.edge_aware under the spp>1 path route: each
    jittered sample runs the silhouette blend (render_image ->
    one_sample -> shade_edgeaware) — the render must be
    finite and its vertex gradient must carry silhouette signal."""
    import dataclasses

    t = TestSilhouetteGrad()
    opts = dataclasses.replace(
        RenderOptions(width=32, height=32, mode="path", bounces=1,
                      spp=2, use_tree=False, background=1.0),
        differentiable=True, edge_aware=True)
    cam = Camera.create(position=[0.011, 0.007, -1.0],
                        forward=[0.0, 0.0, 1.0])
    key = jax.random.PRNGKey(5)

    def loss_fn(dz):
        img = render_image(t._scene(dz), cam, opts, key=key)
        return jnp.mean(img[8:24, 12:28, :])

    img = render_image(t._scene(0.0), cam, opts, key=key)
    assert np.isfinite(np.asarray(img)).all()
    g = float(jax.grad(loss_fn)(jnp.float32(0.0)))
    assert np.isfinite(g) and abs(g) > 1e-4, g
