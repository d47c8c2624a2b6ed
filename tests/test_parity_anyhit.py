"""The any-hit occlusion walks with t_max (NEE shadow rays:
render/integrator.py::_occluded) against the oracle's nearest hit below
t_max — the kd walk and the grid walk, scenes x ray kinds
(tests/_parity.py)."""

import numpy as np
import pytest

from _parity import KINDS, SCENES, make_rays, oracle, scene_setup, select
from chip_smoke import compare_occlusion, grid_any_hit, kd_any_hit


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_any_hit_walks_match_oracle(name, kind):
    setup = scene_setup(name)
    o, d, tm, act = make_rays(name, kind)
    ref = oracle(setup["scene"], o, d)
    a = np.asarray(act)
    for label, rec in (("kd", kd_any_hit(setup["tree"], o, d, tm, act)),
                       ("grid", grid_any_hit(setup["grid"], o, d, tm, act))):
        assert not np.asarray(rec["hit"])[~a].any(), label
        out = compare_occlusion(f"{name}/{kind}/{label}", select(rec, a),
                                select(ref, a), np.asarray(tm)[a])
        assert out["mask_mismatch"] == 0, label
