"""traverse_fast (the kd rope walk every primary and bounce wave takes)
against the brute-force oracle: scenes x ray kinds (tests/_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _parity import KINDS, SCENES, make_rays, oracle, scene_setup, select
from chip_smoke import compare_nearest, kd_nearest as walk
from clpathtracer_tpu.render.integrator import RenderOptions, intersect_scene


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_traverse_fast_matches_oracle(name, kind):
    setup = scene_setup(name)
    o, d, _, act = make_rays(name, kind)
    rec = walk(setup["tree"], o, d, act)
    ref = oracle(setup["scene"], o, d)
    a = np.asarray(act)
    assert not np.asarray(rec["hit"])[~a].any()  # dead lanes never walk
    out = compare_nearest(f"{name}/{kind}", select(rec, a), select(ref, a))
    assert out["mask_mismatch"] == 0
    if name == "spheres_tris":
        _check_spheres(setup, o, d)


def _check_spheres(setup, o, d):
    """intersect_scene folds spheres into the walk's triangle hits exactly
    as the brute-force route does."""
    scene = setup["scene"].replace(
        sphere_pos=jnp.asarray([[0.3, -0.6, 1.2], [-0.4, 0.2, 1.6]]),
        sphere_radius=jnp.asarray([0.3, 0.25]),
        sphere_albedo=jnp.full((2, 3), 0.5),
        sphere_emission=jnp.zeros((2, 3)))
    opts = RenderOptions(width=16, height=16)
    got = intersect_scene(scene, setup["tree"], o, d, opts)
    ref = intersect_scene(scene, None, o, d,
                          RenderOptions(width=16, height=16, use_tree=False))
    for k in ("hit", "tri", "sphere"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(ref[k]), err_msg=k)
    assert (np.asarray(got["sphere"]) >= 0).any()
    h = np.asarray(got["hit"])
    np.testing.assert_allclose(np.asarray(got["t"])[h],
                               np.asarray(ref["t"])[h], rtol=1e-5)
