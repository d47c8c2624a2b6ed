"""Camera model: view/projection/device matrix chain and ray generation.

Reproduces the reference's exact camera semantics so rendered images can be
compared pixel-for-pixel:

* view ("camera") transform built from a Forward vector with a horizon-locked
  left/up frame (reference: src/camera.c:5-33),
* OpenGL-style perspective from FOV/near/far (src/camera.c:35-50),
* pixel-scale device transform height/2 (src/camera.c:52-60),
* composed device @ projection @ view and INVERTED (src/camera.c:62-70) so
  ray generation is an unprojection of pixel coordinates
  (src/kernel.cl:443-456).

The camera is a differentiable pytree: gradients flow from pixels back to
Position / Forward / FOV (the reference has no gradients at all — this is a
new capability required by the differentiable-rendering mode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from clpathtracer_tpu.utils import struct

from clpathtracer_tpu.core import vecmath as vm
from clpathtracer_tpu.core.matrix import mat_inverse, mat_multiply


@struct.dataclass
class Camera:
    """Pinhole fly-camera (reference: include/camera.h:6-14).

    Attributes:
      near, far: clip planes. The reference defaults to near=0.1, far=1
        (src/game.c:275-277) — note far only shapes the unprojection points,
        not actual clipping, since dir is normalized.
      fov: vertical field of view in radians (device transform scales by
        height/2 on both axes, so fov is vertical and aspect comes from the
        pixel grid).
      position: [3] world-space eye position.
      forward: [3] unit view direction.
    """

    near: jnp.ndarray
    far: jnp.ndarray
    fov: jnp.ndarray
    position: jnp.ndarray
    forward: jnp.ndarray

    @classmethod
    def create(cls, position, forward, fov=jnp.pi / 3, near=0.1, far=1.0,
               dtype=jnp.float32) -> "Camera":
        position = jnp.asarray(position, dtype)
        forward = vm.normalize(jnp.asarray(forward, dtype))
        return cls(
            near=jnp.asarray(near, dtype),
            far=jnp.asarray(far, dtype),
            fov=jnp.asarray(fov, dtype),
            position=position,
            forward=forward,
        )


def camera_transform(cam: Camera) -> jnp.ndarray:
    """World→view matrix from the Forward vector (reference: src/camera.c:5-33).

    left = normalize((fz, 0, -fx)); up = forward × left; translation rows
    carry dot(axis, -position).
    """
    f = cam.forward
    left = jnp.stack([f[2], jnp.zeros_like(f[2]), -f[0]], axis=-1)
    left = vm.normalize(left)
    up = vm.cross(f, left)
    neg_pos = -cam.position
    rot = jnp.stack([left, up, f], axis=0)  # [3, 3]
    trans = jnp.matmul(rot, neg_pos, precision=jax.lax.Precision.HIGHEST)  # [3]
    top = jnp.concatenate([rot, trans[:, None]], axis=1)  # [3, 4]
    # bottom row built from traced values (zeros_like/ones_like), not a
    # literal array: a literal here becomes a hoisted jaxpr constant, which
    # jax 0.9 mishandles on multi-device meshes (lost const buffers on the
    # cached-execution path)
    z = jnp.zeros_like(f[0])
    bottom = jnp.stack([z, z, z, jnp.ones_like(z)])[None, :]
    return jnp.concatenate([top, bottom], axis=0)


def projection_transform(cam: Camera) -> jnp.ndarray:
    """Perspective matrix (reference: src/camera.c:35-50).

    Note the reference's row-major layout: mat_set(m, col, row, v) is
    m[row][col]; rows below follow src/camera.c exactly:
      [c 0 0 0; 0 c 0 0; 0 0 -(f+n)/(n-f) 2fn/(n-f); 0 0 1 0]
    """
    c = 1.0 / jnp.tan(cam.fov / 2.0)
    n, f = cam.near, cam.far
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, z, z, z], axis=-1),
        jnp.stack([z, c, z, z], axis=-1),
        jnp.stack([z, z, -(f + n) / (n - f), (2 * f * n) / (n - f)], axis=-1),
        jnp.stack([z, z, one, z], axis=-1),
    ], axis=-2)


def device_transform(height, dtype=jnp.float32) -> jnp.ndarray:
    """Pixel-scale transform diag(h/2, h/2, 1, 1) (reference: src/camera.c:52-60)."""
    h = jnp.asarray(height, dtype) / 2.0
    one = jnp.ones_like(h)
    return jnp.diag(jnp.stack([h, h, one, one]))


def cam_matrix(cam: Camera, height) -> jnp.ndarray:
    """Inverse of device @ projection @ view (reference: src/camera.c:62-70).

    This is the single 4x4 the device kernel consumes: it unprojects
    pixel-centered coordinates back to world space.
    """
    dev = device_transform(height, dtype=cam.position.dtype)
    proj = projection_transform(cam)
    view = camera_transform(cam)
    return mat_inverse(mat_multiply(mat_multiply(dev, proj), view))


def _transform_point(m: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Projective transform with perspective divide (reference: src/kernel.cl:89-94).

    m: [4, 4]; x: [..., 3] → [..., 3].
    """
    hi = jax.lax.Precision.HIGHEST
    num = jnp.einsum("ij,...j->...i", m[:3, :3], x, precision=hi) + m[:3, 3]
    den = jnp.einsum("j,...j->...", m[3, :3], x, precision=hi) + m[3, 3]
    return num / den[..., None]


def generate_rays(cam_inv: jnp.ndarray, width: int, height: int):
    """Primary-ray origins/directions for a width x height pixel grid.

    Mirrors the reference kernel's ray setup (src/kernel.cl:443-456):
      origin_i = cam_inv[i,2] / cam_inv[3,2]   (image of the +z clip axis)
      ncp/fcp  = unproject((px - W/2, py - H/2, ∓1))
      dir      = normalize(fcp - ncp)

    Returns (origins [H*W, 3], dirs [H*W, 3]) flattened row-major so pixel
    (x, y) is element y*W + x — a flat SoA wavefront, this framework's unit
    of work (the reference's 2-D NDRange collapsed to a shardable axis).
    """
    dtype = cam_inv.dtype
    xs = jnp.arange(width, dtype=dtype) - jnp.asarray(width, dtype) / 2.0
    ys = jnp.arange(height, dtype=dtype) - jnp.asarray(height, dtype) / 2.0
    px, py = jnp.meshgrid(xs, ys, indexing="xy")  # [H, W]
    pix = jnp.stack([px, py], axis=-1).reshape(-1, 2)  # [H*W, 2]

    origin = cam_inv[:3, 2] / cam_inv[3, 2]

    near_pts = jnp.concatenate(
        [pix, jnp.full((pix.shape[0], 1), -1.0, dtype)], axis=-1)
    far_pts = jnp.concatenate(
        [pix, jnp.full((pix.shape[0], 1), 1.0, dtype)], axis=-1)
    ncp = _transform_point(cam_inv, near_pts)
    fcp = _transform_point(cam_inv, far_pts)
    dirs = vm.normalize(fcp - ncp)
    origins = jnp.broadcast_to(origin, dirs.shape)
    return origins, dirs


def generate_rays_jittered(cam_inv: jnp.ndarray, width: int, height: int,
                           jitter: jnp.ndarray):
    """Like generate_rays but with per-ray subpixel offsets in [0,1)^2.

    `jitter` has shape [S, H*W, 2] (S = samples per pixel). Used by the
    stratified sampler for anti-aliased / Monte-Carlo rendering — a new
    capability (the reference shoots exactly one deterministic ray per pixel
    through the pixel's integer corner).
    Returns (origins [S, H*W, 3], dirs [S, H*W, 3]).
    """
    dtype = cam_inv.dtype
    xs = jnp.arange(width, dtype=dtype) - jnp.asarray(width, dtype) / 2.0
    ys = jnp.arange(height, dtype=dtype) - jnp.asarray(height, dtype) / 2.0
    px, py = jnp.meshgrid(xs, ys, indexing="xy")
    pix = jnp.stack([px, py], axis=-1).reshape(-1, 2)  # [H*W, 2]
    pix = pix[None, :, :] + jitter  # [S, H*W, 2]

    origin = cam_inv[:3, 2] / cam_inv[3, 2]
    z = jnp.ones(pix.shape[:-1] + (1,), dtype)
    ncp = _transform_point(cam_inv, jnp.concatenate([pix, -z], axis=-1))
    fcp = _transform_point(cam_inv, jnp.concatenate([pix, z], axis=-1))
    dirs = vm.normalize(fcp - ncp)
    origins = jnp.broadcast_to(origin, dirs.shape)
    return origins, dirs
