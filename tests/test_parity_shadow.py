"""The small-leaf shadow tree (accel/sah.py::attach_shadow_tree: surface
bounce waves and NEE occlusion) walked by traverse_fast, nearest and
any-hit with t_max, against the oracle: scenes x ray kinds
(tests/_parity.py)."""

import numpy as np
import pytest

from _parity import KINDS, SCENES, make_rays, oracle, scene_setup, select
from chip_smoke import (
    compare_nearest, compare_occlusion, kd_any_hit, kd_nearest)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_shadow_tree_walks_match_oracle(name, kind):
    setup = scene_setup(name)
    st = setup["shadow"]
    assert st.num_nodes > 0
    o, d, tm, act = make_rays(name, kind)
    ref = oracle(setup["scene"], o, d)
    a = np.asarray(act)
    out = compare_nearest(f"{name}/{kind}", select(kd_nearest(st, o, d, act), a),
                          select(ref, a))
    assert out["mask_mismatch"] == 0
    occ = compare_occlusion(f"{name}/{kind}/any", select(
        kd_any_hit(st, o, d, tm, act), a), select(ref, a), np.asarray(tm)[a])
    assert occ["mask_mismatch"] == 0
