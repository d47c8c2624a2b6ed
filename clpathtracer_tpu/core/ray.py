"""Ray wavefront containers.

The reference carries per-ray precomputed inverse directions and sign bits
(reference: src/kernel.cl:72-87 `Ray{orig,dir,invdir,sign}`). Here a ray
*batch* is the unit: flat SoA arrays with a leading wavefront axis that jit,
vmap, and shard_map can all partition.
"""

from __future__ import annotations

import jax.numpy as jnp
from clpathtracer_tpu.utils import struct


@struct.dataclass
class RayBatch:
    """A wavefront of rays.

    orig, dir, invdir: [..., 3]; sign: [..., 3] int32 (1 where invdir < 0),
    matching the reference's slab-test convention (src/kernel.cl:79-87).
    """

    orig: jnp.ndarray
    dir: jnp.ndarray
    invdir: jnp.ndarray
    sign: jnp.ndarray

    @classmethod
    def create(cls, orig: jnp.ndarray, dir: jnp.ndarray) -> "RayBatch":
        invdir = 1.0 / dir  # IEEE inf on zero components, as in the reference
        sign = (invdir < 0).astype(jnp.int32)
        return cls(orig=orig, dir=dir, invdir=invdir, sign=sign)

    @property
    def shape(self):
        return self.orig.shape[:-1]

    def at(self, pos) -> jnp.ndarray:
        """Point along each ray: orig + t * dir, t of shape [...]."""
        return self.orig + pos[..., None] * self.dir
