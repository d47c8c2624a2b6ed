"""Test configuration: run the suite on a simulated 8-device CPU mesh.

The reference has no tests at all (SURVEY.md §4); this suite is the missing
pyramid. JAX's CPU backend doubles as the "fake device": the same jitted
code that runs on the GPU runs here, and
--xla_force_host_platform_device_count=8 provides a virtual 8-device mesh
for distributed tests without hardware.

The platform is pinned with jax.config after import, so the suite runs on
the CPU whatever JAX_PLATFORMS says. Tests that need a GPU carry the `gpu`
marker and take the `gpu_device` fixture, which skips them here; on a
machine with a card, run them with `CLPT_TEST_GPU=1 python -m pytest -m
gpu tests/`, which keeps the GPU backend beside the CPU one.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the CPU backend first, so jax.devices() is the 8-device CPU mesh
jax.config.update("jax_platforms",
                  "cpu,cuda" if os.environ.get("CLPT_TEST_GPU") else "cpu")
jax.config.update("jax_enable_x64", False)
# tests compile hundreds of small programs; keep them out of the
# persistent cache that the CLI turns on for real runs
jax.config.update("jax_enable_compilation_cache", False)

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none. Decided here,
    at run time, never at import: every xdist worker must collect the
    same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU in this process (run with CLPT_TEST_GPU=1 on "
                    "a machine with a card)")
    return gpus[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-program caches after each test module.

    A full-suite session accumulates hundreds of compiled CPU programs;
    past ~275 tests the XLA CPU compiler was seen to abort compiling the
    next large while_loop program (internal compiler state, not system
    memory). Clearing per module bounds the accumulation; cross-module
    cache reuse is ~nil anyway (each module jits its own functions)."""
    yield
    jax.clear_caches()
