"""chip_smoke.py on the CPU: the device check refuses this platform, the
last line has its exact form, the oracle comparisons catch faults, and
every phase runs end to end at a tiny size (the rehearsal of the GPU
run; the 4-card phase runs on 4 of the 8 virtual CPU devices)."""

import json

import jax
import numpy as np
import pytest

import chip_smoke
from chip_smoke import SmokeFailure, Sizes

TINY = Sizes(tris=20_000, res=32, samples=256, oracle_chunk=64,
             train_tris=600, train_res=16, frames=1)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SmokeFailure, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""  # no result line, nothing on stdout
    assert "needs a GPU" in captured.err


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
           "count": count}
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


def _rec(hit, t, tri):
    n = len(hit)
    return {"hit": np.asarray(hit), "t": np.asarray(t, np.float32),
            "tri": np.asarray(tri), "prim_id": np.asarray(tri),
            "u": np.full(n, 0.3, np.float32), "v": np.full(n, 0.3, np.float32)}


def test_compare_nearest_accepts_ties_and_rejects_faults():
    ref = _rec([True, True, False], [1.0, 2.0, 3.4e38], [4, 5, 0])
    tie = _rec([True, True, False], [1.0, 2.0, 3.4e38], [4, 9, -1])
    out = chip_smoke.compare_nearest("tie", tie, ref)
    assert out["tri_ties"] == 1 and out["mask_mismatch"] == 0
    with pytest.raises(SmokeFailure, match="differ in t"):
        chip_smoke.compare_nearest(
            "t", _rec([True, True, False], [1.0, 2.1, 0.0], [4, 5, -1]),
            ref)
    with pytest.raises(SmokeFailure, match="hit masks"):
        chip_smoke.compare_nearest(
            "mask", _rec([True, False, False], [1.0, 0.0, 0.0], [4, -1, -1]),
            ref)


def test_compare_occlusion_rejects_faults():
    ref = _rec([True, True, False], [1.0, 2.0, 3.4e38], [4, 5, 0])
    t_max = np.asarray([1.5, 1.5, 1.5], np.float32)
    ok = _rec([True, False, False], [1.0, 0.0, 0.0], [4, -1, -1])
    assert chip_smoke.compare_occlusion("ok", ok, ref, t_max)[
        "mask_mismatch"] == 0
    with pytest.raises(SmokeFailure, match="occlusion agrees"):
        chip_smoke.compare_occlusion(
            "bad", _rec([True, True, False], [1.0, 1.2, 0.0], [4, 5, -1]),
            ref, t_max)


def test_incoherent_rays_in_box():
    from clpathtracer_tpu.scene.procedural import random_tri_soup
    scene = random_tri_soup(500, seed=0)
    o, d, tm = chip_smoke.incoherent_rays(scene, 128, seed=1)
    lo, hi = (np.asarray(x) for x in scene.bounds())
    o = np.asarray(o)
    assert ((o >= lo - 1e-5) & (o <= hi + 1e-5)).all()
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=1), 1.0,
                               rtol=1e-5)
    assert (np.asarray(tm) > 0).all()


def test_primary_and_path_phases_tiny():
    out, terrain = chip_smoke.phase_primary(TINY, seed=0)
    assert out["oracle"]["mask_agree"] >= chip_smoke.MASK_AGREE
    assert out["oracle"]["hits"] > 0
    path = chip_smoke.phase_path(TINY, 0, terrain)
    for k in ("grid_nearest", "grid_any_hit", "kd_any_hit",
              "shadow_nearest", "shadow_any_hit"):
        assert path[k]["mask_agree"] >= chip_smoke.MASK_AGREE, k


def test_train_phase_tiny():
    out = chip_smoke.phase_train(TINY, seed=0)
    assert np.isfinite(out["losses"]).all()
    assert len(out["losses"]) == 1 + TINY.frames


def test_cards_phase_on_four_cpu_devices():
    out = chip_smoke.phase_cards(TINY, seed=0, n=4)
    single, sharded = out["losses"].values()
    np.testing.assert_allclose(single[0], sharded[0], rtol=1e-3)
    np.testing.assert_allclose(single[1], sharded[1], rtol=1e-2)
