"""Device discovery and placement policy.

The reference enumerates OpenCL platforms/devices with printf inventories
and an interactive stdin picker (src/CLHandler.c:13-127). Here: structured
inventory of the JAX device topology and a non-interactive selection
policy (flags/env, never prompts — SURVEY §5 config).
"""

from __future__ import annotations

import os

import jax

# the checkout root: the directory that holds the package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_inventory() -> list:
    """One dict per device: the platform/device printout
    (src/CLHandler.c:13-38) as data."""
    out = []
    for d in jax.devices():
        out.append({
            "id": d.id,
            "platform": d.platform,
            "device_kind": getattr(d, "device_kind", "?"),
            "process_index": d.process_index,
            "coords": tuple(getattr(d, "coords", ()) or ()),
            "memory_kinds": sorted(
                m.kind for m in getattr(d, "addressable_memories",
                                        lambda: [])()),
        })
    return out


def pick_device(platform: str = None, index: int = 0):
    """Deterministic device selection (replaces the stdin picker,
    src/CLHandler.c:43-53). platform None → default backend order."""
    devs = jax.devices(platform) if platform else jax.devices()
    if not devs:
        raise RuntimeError(f"no devices for platform {platform!r}")
    if index >= len(devs):
        raise RuntimeError(
            f"device index {index} out of range ({len(devs)} available)")
    return devs[index]


def host_cpu():
    """The host CPU device (for host-side work pinned off the
    accelerator with jax.default_device)."""
    return jax.local_devices(backend="cpu")[0]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads that directory itself
    and nothing else is set here. Otherwise the cache goes to
    `<checkout>/.jax_cache` (listed in .gitignore). A fixed path matters:
    it is part of the cache key, so a moving directory never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
