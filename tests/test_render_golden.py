"""Golden-image tests: render_image vs an independent pure-numpy renderer.

The numpy oracle below re-implements the reference pipeline (camera
unprojection + nearest-hit + normal shading) with plain loops/numpy —
sharing no code with the framework — so agreement is meaningful
(BASELINE config[0]: 64x64 Cornell box, image allclose).
"""

import numpy as np
import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera
from clpathtracer_tpu.render.integrator import RenderOptions, render_image
from clpathtracer_tpu.scene.procedural import cornell_box, icosphere


def numpy_reference_render(scene, pos, fwd, fov, near, far, w, h):
    """Independent numpy implementation of the reference's pipeline:
    cam matrix chain (src/camera.c), unprojection ray-gen
    (src/kernel.cl:443-456), Moller-Trumbore nearest hit with backface cull
    (src/kernel.cl:227-255), normal-viz shading (src/kernel.cl:395-397,
    smooth normals :359-362), miss → white (:421)."""
    fwd = np.asarray(fwd, np.float64); fwd /= np.linalg.norm(fwd)
    left = np.array([fwd[2], 0, -fwd[0]]); left /= np.linalg.norm(left)
    up = np.cross(fwd, left)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = left, up, fwd
    view[:3, 3] = view[:3, :3] @ (-np.asarray(pos, np.float64))
    c = 1 / np.tan(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = proj[1, 1] = c
    proj[2, 2] = -(far + near) / (near - far)
    proj[2, 3] = 2 * far * near / (near - far)
    proj[3, 2] = 1
    dev = np.diag([h / 2, h / 2, 1, 1])
    M = np.linalg.inv(dev @ proj @ view)

    def xform(p):
        q = M @ np.append(p, 1.0)
        return q[:3] / q[3]

    origin = M[:3, 2] / M[3, 2]

    verts = np.asarray(scene.verts, np.float64)
    faces = np.asarray(scene.faces)
    normals = np.asarray(scene.normals, np.float64)

    img = np.ones((h, w, 3))
    for y in range(h):
        for x in range(w):
            ncp = xform([x - w / 2, y - h / 2, -1.0])
            fcp = xform([x - w / 2, y - h / 2, 1.0])
            d = fcp - ncp
            d /= np.linalg.norm(d)
            best_t, best = np.inf, None
            for fi in range(faces.shape[0]):
                i0, i1, i2 = faces[fi, :, 0]
                v0, v1, v2 = verts[i0], verts[i1], verts[i2]
                e1, e2 = v1 - v0, v2 - v0
                pvec = np.cross(d, e2)
                det = e1 @ pvec
                if det <= 0:
                    continue
                tvec = origin - v0
                u = (tvec @ pvec) / det
                if u < 0 or u > 1:
                    continue
                qvec = np.cross(tvec, e1)
                vv = (d @ qvec) / det
                if vv < 0 or u + vv > 1:
                    continue
                t = (e2 @ qvec) / det
                if t <= 0 or t > best_t:
                    continue
                best_t = t
                if faces[fi, 0, 1] >= 0:
                    n0 = normals[faces[fi, 0, 1]]
                    n1 = normals[faces[fi, 1, 1]]
                    n2 = normals[faces[fi, 2, 1]]
                    n = (1 - u - vv) * n0 + u * n1 + vv * n2
                else:
                    n = np.cross(e1, e2)
                n = n / np.linalg.norm(n)
                best = n
            if best is not None:
                img[y, x] = (best + 1) / 2
    return img


class TestGoldenCornell:
    def test_bruteforce_matches_numpy_oracle(self):
        scene = cornell_box(light=False)
        cam = Camera.create(position=[0.0, 0.0, -1.0],
                            forward=[0.0, 0.0, 1.0])
        opts = RenderOptions(width=64, height=64, mode="normal",
                             use_tree=False)
        img = np.asarray(render_image(scene, cam, opts))
        ref = numpy_reference_render(scene, [0, 0, -1.0], [0, 0, 1],
                                     float(cam.fov), 0.1, 1.0, 64, 64)
        # f32 vs f64 at triangle edges: compare with a small pixel budget
        close = np.isclose(img, ref, atol=2e-3).all(axis=-1)
        assert close.mean() > 0.995, f"{(~close).sum()} pixels differ"

    def test_tree_matches_bruteforce_image(self):
        scene = cornell_box(light=False)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0],
                            forward=[0.0, 0.0, 1.0])
        img_bf = np.asarray(render_image(
            scene, cam, RenderOptions(width=64, height=64, mode="normal",
                                      use_tree=False)))
        img_kd = np.asarray(render_image(
            scene, cam, RenderOptions(width=64, height=64, mode="normal",
                                      use_tree=True), tree=tree))
        close = np.isclose(img_bf, img_kd, atol=2e-3).all(axis=-1)
        assert close.mean() > 0.998, f"{(~close).sum()} pixels differ"


class TestGoldenIcosphere:
    def test_smooth_normals_image(self):
        scene = icosphere(2)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0],
                            forward=[0.0, 0.0, 1.0])
        img = np.asarray(render_image(
            scene, cam, RenderOptions(width=48, height=48, mode="normal"),
            tree=tree))
        ref = numpy_reference_render(scene, [0, 0, -1.0], [0, 0, 1],
                                     float(cam.fov), 0.1, 1.0, 48, 48)
        close = np.isclose(img, ref, atol=5e-3).all(axis=-1)
        assert close.mean() > 0.99, f"{(~close).sum()} pixels differ"

    def test_sphere_center_normal_faces_camera(self):
        scene = icosphere(3)
        cam = Camera.create(position=[0.0, 0.0, -1.0],
                            forward=[0.0, 0.0, 1.0])
        img = np.asarray(render_image(
            scene, cam,
            RenderOptions(width=32, height=32, mode="normal",
                          use_tree=False)))
        # pixel (16,16) has offset exactly (0,0) (reference pixel grid uses
        # x - W/2): smooth normal ≈ (0,0,-1) → color ≈ (.5,.5,0)
        np.testing.assert_allclose(img[16, 16], [0.5, 0.5, 0.0], atol=0.02)


class TestModes:
    def _setup(self):
        scene = cornell_box()
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0],
                            forward=[0.0, 0.0, 1.0])
        return scene, tree, cam

    def test_mirror_mode_differs_from_normal_and_finite(self):
        scene, tree, cam = self._setup()
        opts_n = RenderOptions(width=32, height=32, mode="normal")
        opts_m = RenderOptions(width=32, height=32, mode="mirror", bounces=3)
        img_n = np.asarray(render_image(scene, cam, opts_n, tree=tree))
        img_m = np.asarray(render_image(scene, cam, opts_m, tree=tree))
        assert np.isfinite(img_m).all()
        assert np.abs(img_n - img_m).max() > 0.01

    def test_mirror_one_bounce_blend(self):
        """bounces=1: col = 0.8*normColor + 0.2*1 exactly (str 1→0.2)."""
        scene, tree, cam = self._setup()
        img_n = np.asarray(render_image(
            scene, cam, RenderOptions(width=32, height=32, mode="normal"),
            tree=tree))
        img_m = np.asarray(render_image(
            scene, cam,
            RenderOptions(width=32, height=32, mode="mirror", bounces=1),
            tree=tree))
        want = 0.8 * img_n + 0.2 * 1.0
        # hit pixels only (miss pixels are 1.0 in both)
        np.testing.assert_allclose(img_m, want, atol=1e-5)

    def test_path_mode_light_illuminates(self):
        scene, tree, cam = self._setup()
        opts = RenderOptions(width=32, height=32, mode="path", bounces=3,
                             spp=8, background=0.0)
        img = np.asarray(render_image(
            scene, cam, opts, key=jax.random.PRNGKey(1), tree=tree))
        assert np.isfinite(img).all()
        assert img.max() > 0.05  # light reaches the film
        assert img.min() >= 0.0

    def test_path_deterministic_given_key(self):
        scene, tree, cam = self._setup()
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             spp=4, background=0.0)
        a = np.asarray(render_image(scene, cam, opts,
                                    key=jax.random.PRNGKey(7), tree=tree))
        b = np.asarray(render_image(scene, cam, opts,
                                    key=jax.random.PRNGKey(7), tree=tree))
        np.testing.assert_array_equal(a, b)


class TestBakedShading:
    def test_baked_matches_live_resolve(self):
        """Scene.bake_shading: wide-gather shading must match the live
        multi-gather path on smooth and flat geometry."""
        for make in (lambda: icosphere(2), lambda: cornell_box(light=True)):
            scene = make()
            v0, v1, v2 = scene.tri_verts()
            tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
            tree = build_kd_tree(tv, tri_block=4)
            cam = Camera.create(position=[0.0, 0.0, -1.0],
                                forward=[0.0, 0.0, 1.0])
            opts = RenderOptions(width=32, height=32, mode="normal")
            a = np.asarray(render_image(scene, cam, opts, tree=tree))
            b = np.asarray(render_image(scene.bake_shading(), cam, opts,
                                        tree=tree))
            np.testing.assert_allclose(a, b, atol=1e-5)

    def test_baked_path_mode(self):
        scene = cornell_box(light=True)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="path", bounces=2,
                             background=0.0)
        key = jax.random.PRNGKey(2)
        a = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
        b = np.asarray(render_image(scene.bake_shading(), cam, opts,
                                    tree=tree, key=key))
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestNee:
    def test_nee_matches_bsdf_sampling_mean(self):
        """Next-event estimation must converge to the same radiance as
        plain BSDF-bounce sampling (unbiased), with lower variance."""
        scene = cornell_box(light=True)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        base = dict(width=16, height=16, mode="path", bounces=3,
                    background=0.0)
        img_bsdf = np.asarray(render_image(
            scene, cam, RenderOptions(**base, spp=96), tree=tree,
            key=jax.random.PRNGKey(11)))
        img_nee = np.asarray(render_image(
            scene, cam, RenderOptions(**base, spp=24, nee=True), tree=tree,
            key=jax.random.PRNGKey(12)))
        assert np.isfinite(img_nee).all()
        # means agree within Monte-Carlo tolerance
        np.testing.assert_allclose(img_nee.mean(), img_bsdf.mean(),
                                   rtol=0.15)
        # per-pixel agreement: NEE at 1/4 the samples should already be
        # close to the BSDF estimate
        diff = np.abs(img_nee - img_bsdf).mean()
        assert diff < 0.15, diff

    def test_nee_unbiased_low_albedo(self):
        """Regression (ADVICE r1): with albedo 0.25 the old NEE path applied
        the hit albedo twice, biasing the mean ~4x dark — the high-albedo
        Cornell test's tolerance masked it. Low albedo makes one lost
        albedo factor a 4x error the mean check cannot miss."""
        scene = cornell_box(light=True, wall_albedo=0.25)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        base = dict(width=16, height=16, mode="path", bounces=3,
                    background=0.0)
        img_bsdf = np.asarray(render_image(
            scene, cam, RenderOptions(**base, spp=128), tree=tree,
            key=jax.random.PRNGKey(21)))
        img_nee = np.asarray(render_image(
            scene, cam, RenderOptions(**base, spp=32, nee=True), tree=tree,
            key=jax.random.PRNGKey(22)))
        assert np.isfinite(img_nee).all()
        np.testing.assert_allclose(img_nee.mean(), img_bsdf.mean(),
                                   rtol=0.2)

    def test_emitter_one_sided_both_estimators(self):
        """Emission is one-sided (front face only) under both BSDF-path and
        NEE estimators: a camera looking at the BACK of the Cornell light
        panel must see no emission from it either way (ADVICE r1: the two
        estimators previously disagreed on back-face visibility)."""
        scene = cornell_box(light=True)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        # camera just above the light quad looking down at its back face
        cam = Camera.create(position=[0.0, 0.9995, 1.0],
                            forward=[0.0, -1.0, 1e-3])
        base = dict(width=8, height=8, mode="path", bounces=1,
                    background=0.0)
        for nee in (False, True):
            img = np.asarray(render_image(
                scene, cam, RenderOptions(**base, nee=nee), tree=tree,
                key=jax.random.PRNGKey(3)))
            # back face of the emitter: no direct emission contribution
            assert img.max() < 1.0, (nee, img.max())

    def test_nee_no_lights_is_noop(self):
        """Zero-emitter NEE regression: the entire shadow traversal is
        gated on any_light via lax.cond and the shadow directions
        sanitized; with no emitters NEE must contribute nothing and the
        render stays finite through both the wavefront walk and the
        small-leaf shadow tree's walk."""
        scene = cornell_box(light=False)
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        from clpathtracer_tpu.accel.sah import attach_shadow_tree
        walked = attach_shadow_tree(tree, tv)
        opts = RenderOptions(width=8, height=8, mode="path", bounces=2,
                             background=0.5, nee=True)
        for name, t in (("wavefront", tree), ("shadow-tree", walked)):
            img = np.asarray(render_image(scene, cam, opts, tree=t,
                                          key=jax.random.PRNGKey(0)))
            assert np.isfinite(img).all(), name


class TestBaselineConfig1:
    def test_multibounce_path_trace_5k_mesh(self):
        """BASELINE config[1] shape (scaled down for CPU CI): multi-bounce
        (4) diffuse path trace of a ~5k-tri mesh through the kd-tree with
        stratified subpixel sampling."""
        scene = icosphere(3)  # 5120 tris, smooth normals, sky-lit
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        tree = build_kd_tree(tv, tri_block=4, leaf_size=8, max_depth=16)
        cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=64, height=64, mode="path", bounces=4,
                             spp=2, background=0.8)
        img = np.asarray(render_image(scene, cam, opts, tree=tree,
                                      key=jax.random.PRNGKey(4)))
        assert img.shape == (64, 64, 3)
        assert np.isfinite(img).all() and img.min() >= 0.0
        # analytic check: a Lambertian CONVEX body under a uniform sky L
        # has constant outgoing radiance albedo*L (cosine-weighted bounce
        # always escapes) — 0.75 * 0.8 = 0.6 exactly
        # interior hit pixels (both spp samples hit; silhouette pixels mix
        # a 0.8 miss sample in)
        hit_px = (img < 0.65).all(-1)
        assert 0.05 < hit_px.mean() < 0.9
        np.testing.assert_allclose(img[hit_px], 0.6, atol=0.02)


def test_shadow_tree_image_parity():
    """A walk-tuned shadow tree (accel/sah.py::attach_shadow_tree) must
    not change the path+NEE image at all — the any_hit occlusion boolean
    is exact regardless of tree shape. With the bounce-walk reroute
    disabled the images are bit-equal; with it on (the default — bounce
    nearest-hits ride the same walk)
    they may differ only by exact-t tie winners, so hit structure and
    radiance stay close."""
    from clpathtracer_tpu.accel.sah import attach_shadow_tree
    from clpathtracer_tpu.core.camera import Camera
    from clpathtracer_tpu.scene.procedural import random_tri_soup
    import jax

    scene = random_tri_soup(3000, seed=4, extent=2.0, tri_size=0.05,
                            emissive_frac=0.01).bake_shading()
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4, leaf_size=64)
    cam = Camera.create(position=[0.0, 0.0, -1.5], forward=[0, 0, 1.0])
    opts = RenderOptions(width=32, height=32, mode="path", bounces=2,
                         nee=True, spp=1, bounce_walk=False)
    key = jax.random.PRNGKey(7)
    base = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
    st = attach_shadow_tree(tree, tv, leaf_size=8, max_depth=18)
    assert st.shadow is not None and st.shadow.num_nodes > tree.num_nodes
    with_shadow = np.asarray(
        render_image(scene, cam, opts, tree=st, key=key))
    np.testing.assert_array_equal(base, with_shadow)

    opts_walk = RenderOptions(width=32, height=32, mode="path", bounces=2,
                              nee=True, spp=1, bounce_walk=True)
    walked = np.asarray(
        render_image(scene, cam, opts_walk, tree=st, key=key))
    diff = np.abs(walked - base)
    assert (diff > 1e-4).mean() < 0.02, (diff > 1e-4).mean()
    np.testing.assert_allclose(walked.mean(), base.mean(), rtol=0.02)


def test_grid_image_parity(monkeypatch):
    """A uniform grid (accel/sah.py::attach_grid) must not change the
    path+NEE image: shadow occlusion booleans are exact and the bounce
    nearest-hit runs the same Möller–Trumbore arithmetic, so with the
    bounce reroute disabled the images are bit-equal, and with it enabled
    they differ at most by fp wobble in the engines' hit re-resolve."""
    from clpathtracer_tpu.accel.sah import attach_grid
    from clpathtracer_tpu.core.camera import Camera
    from clpathtracer_tpu.scene.procedural import random_tri_soup
    import jax

    scene = random_tri_soup(3000, seed=4, extent=2.0, tri_size=0.05,
                            emissive_frac=0.01).bake_shading()
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4, leaf_size=64)
    cam = Camera.create(position=[0.0, 0.0, -1.5], forward=[0, 0, 1.0])
    key = jax.random.PRNGKey(7)
    gt = attach_grid(tree, tv)
    assert gt.grid is not None

    # shadow-route only (CLPT_BOUNCE_GRID=0): bit-equal images
    monkeypatch.setenv("CLPT_BOUNCE_GRID", "0")
    opts = RenderOptions(width=32, height=32, mode="path", bounces=2,
                         nee=True, spp=1)
    base = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
    with_grid = np.asarray(render_image(scene, cam, opts, tree=gt, key=key))
    np.testing.assert_array_equal(base, with_grid)

    # bounce reroute on (the default): fp-wobble tolerance only.
    # different width → different jit signature (the env knob is read at
    # trace time; identical signatures would reuse the cached program)
    monkeypatch.setenv("CLPT_BOUNCE_GRID", "1")
    opts2 = RenderOptions(width=34, height=32, mode="path", bounces=2,
                          nee=True, spp=1)
    base2 = np.asarray(render_image(scene, cam, opts2, tree=tree, key=key))
    grid2 = np.asarray(render_image(scene, cam, opts2, tree=gt, key=key))
    np.testing.assert_allclose(base2, grid2, atol=1e-4)
