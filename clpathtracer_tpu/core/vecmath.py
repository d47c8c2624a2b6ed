"""Batched 3-vector math over trailing-axis-3 arrays.

Batched analogue of the reference's scalar float3 helpers
(reference: src/vector.c:5-113, include/vector.h:12-23). Everything here is
shape-polymorphic over leading axes so the same functions serve a single
camera vector on the host and a [N_RAYS, 3] wavefront on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis. Keeps leading axes."""
    return jnp.sum(a * b, axis=-1)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def length_squared(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize over the trailing axis.

    Matches the reference's behavior (divide by the exact length,
    src/vector.c vec_normalize) when eps=0; pass eps>0 for a guarded
    version safe under jax.grad at zero vectors. The guard uses the
    double-where pattern: the excluded branch must see a SAFE denominator
    (1.0), or its backward computes -1/n2^2 → inf at underflow and
    0 * inf = NaN poisons every upstream gradient.
    """
    if eps:
        n2 = length_squared(a)
        ok = n2 > eps
        inv_len = jnp.where(ok, jax.lax.rsqrt(jnp.where(ok, n2, 1.0)), 0.0)
        return a * inv_len[..., None]
    return a / length(a)[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product over the trailing axis (reference: src/vector.c vec_cross)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def vmin(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(a, b)


def vmax(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(a, b)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction d about normal n.

    The reference's intended bounce rule (src/kernel.cl:400,
    `normalize(dir - 2*dot(dir, normal)*normal)`).
    """
    return normalize(d - 2.0 * dot(d, n)[..., None] * n)
