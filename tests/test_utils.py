"""Tests for the error harness, device inventory, profiling utilities."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clpathtracer_tpu.utils.device import device_inventory, host_cpu, pick_device
from clpathtracer_tpu.utils.errors import checked, debug_nans, validate_image
from clpathtracer_tpu.utils.profiling import StageTimer, emit_metric


class TestErrors:
    def test_checked_catches_nan(self):
        f = checked(jax.jit(lambda x: jnp.log(x)))
        f(jnp.float32(1.0))  # fine
        with pytest.raises(Exception):
            f(jnp.float32(-1.0))  # log(-1) = nan

    def test_validate_image(self):
        validate_image(np.ones((4, 4, 3)))
        with pytest.raises(FloatingPointError):
            validate_image(np.array([[np.nan]]))
        with pytest.raises(FloatingPointError):
            validate_image(np.array([[-0.5]]))

    def test_debug_nans_scope_restores(self):
        prev = jax.config.jax_debug_nans
        with debug_nans(True):
            assert jax.config.jax_debug_nans
        assert jax.config.jax_debug_nans == prev


class TestDevice:
    def test_inventory(self):
        inv = device_inventory()
        assert len(inv) == 8  # simulated mesh (conftest)
        assert all(d["platform"] == "cpu" for d in inv)

    def test_pick(self):
        d = pick_device("cpu", 3)
        assert d.id == 3
        with pytest.raises(RuntimeError):
            pick_device("cpu", 99)

    def test_host_cpu(self):
        assert host_cpu().platform == "cpu"


class TestProfiling:
    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        assert "a" in t.report() and t.report()["a"] >= 0

    def test_emit_metric(self, capsys):
        rec = emit_metric("rays/s", 1e6, "rays/s", vs_baseline=0.005)
        out = capsys.readouterr().out
        assert '"metric"' in out and rec["value"] == 1e6


class TestPurity:
    def test_render_deterministic(self):
        """Functional purity = the race-detection story (SURVEY §5): same
        inputs → bit-identical frames."""
        from clpathtracer_tpu.core.camera import Camera
        from clpathtracer_tpu.render.integrator import (
            RenderOptions, render_image)
        from clpathtracer_tpu.scene.procedural import cornell_box
        scene = cornell_box()
        cam = Camera.create(position=[0, 0, -1.0], forward=[0, 0, 1.0])
        opts = RenderOptions(width=16, height=16, mode="normal",
                             use_tree=False)
        a = np.asarray(render_image(scene, cam, opts))
        b = np.asarray(render_image(scene, cam, opts))
        np.testing.assert_array_equal(a, b)


class TestCompileCache:
    def _restore(self):
        prev = jax.config.jax_compilation_cache_dir
        return lambda: jax.config.update("jax_compilation_cache_dir", prev)

    def test_env_dir_is_left_to_jax(self, monkeypatch):
        from clpathtracer_tpu.utils.device import enable_compile_cache
        restore = self._restore()
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
            assert enable_compile_cache() == "/elsewhere"
            # nothing set in code: the config still holds its old value
            assert jax.config.jax_compilation_cache_dir is None
        finally:
            restore()

    def test_default_is_the_checkout(self, monkeypatch):
        import os
        from clpathtracer_tpu.utils.device import enable_compile_cache
        restore = self._restore()
        try:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert path == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            restore()
