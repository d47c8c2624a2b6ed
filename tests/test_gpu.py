"""Tests that need an NVIDIA GPU (the `gpu` marker). They skip on the CPU;
on a machine with a card run `CLPT_TEST_GPU=1 python -m pytest -m gpu
tests/`."""

import jax
import numpy as np
import pytest

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core.camera import Camera
from clpathtracer_tpu.render.integrator import RenderOptions, render_image
from clpathtracer_tpu.scene.procedural import cornell_box


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["normal", "path"])
def test_render_on_gpu_matches_cpu(gpu_device, mode):
    """The same frame on the GPU and on the CPU: every pixel but exact-t
    ties (wall corners) agrees to float32 rounding."""
    scene = cornell_box(light=True)
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    cam = Camera.create(position=[0.0, 0.0, -1.0], forward=[0.0, 0.0, 1.0])
    opts = RenderOptions(width=32, height=32, mode=mode, bounces=2,
                         nee=(mode == "path"), background=0.0)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(render_image(scene, cam, opts, tree=tree, key=key))
    args = jax.device_put((scene, cam, tree, key), gpu_device)
    img = render_image(args[0], args[1], opts, tree=args[2], key=args[3])
    assert img.devices() == {gpu_device}
    close = np.isclose(np.asarray(img), ref, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean() > 0.99, close.mean()
