"""traverse_grid (the DDA walk of fog-scene bounce waves) against the
brute-force oracle: scenes x ray kinds (tests/_parity.py)."""

import numpy as np
import pytest

from _parity import KINDS, SCENES, make_rays, oracle, scene_setup, select
from chip_smoke import compare_nearest, grid_nearest as walk


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_traverse_grid_matches_oracle(name, kind):
    setup = scene_setup(name)
    o, d, _, act = make_rays(name, kind)
    rec = walk(setup["grid"], o, d, act)
    ref = oracle(setup["scene"], o, d)
    a = np.asarray(act)
    assert not np.asarray(rec["hit"])[~a].any()
    out = compare_nearest(f"{name}/{kind}", select(rec, a), select(ref, a))
    assert out["mask_mismatch"] == 0
