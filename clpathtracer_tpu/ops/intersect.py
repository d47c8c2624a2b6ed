"""Batched ray-primitive intersection (jnp, VPU-friendly).

All routines are data-parallel over a wavefront of rays and/or a block of
primitives — masked vector math instead of the reference's early-return
scalar code:

* Möller–Trumbore triangle test with the reference's backface-cull
  convention `det < EPS`, EPS = 0 (src/kernel.cl:227-255),
* slab AABB test returning entry/exit t and entry/exit face ids
  (hit_AABB, src/kernel.cl:101-144),
* the exit-face-only variant used for rope hops
  (traverse_AABB, src/kernel.cl:146-174),
* sphere intersection — live here, unlike the reference where it is dead
  code (src/kernel.cl:199-225; see SURVEY.md dead-code inventory). The
  reference's inside-the-sphere rejection bug (`c <= 0` → miss,
  src/kernel.cl:206-208) is deliberately NOT reproduced.

Face id convention (KD_SIDE, src/kernel.cl:39-46):
0 = -x, 1 = +x, 2 = -y, 3 = +y, 4 = -z, 5 = +z.
"""

from __future__ import annotations

import jax.numpy as jnp

from clpathtracer_tpu.core import vecmath as vm

TRI_EPS = 0.0  # reference EPS (src/kernel.cl:19)
BIG = 3.4e38  # plain float: avoids a hoisted jaxpr constant


def moller_trumbore(v0, v1, v2, orig, dir, eps: float = TRI_EPS):
    """Möller–Trumbore with backface culling.

    Shapes broadcast: v0/v1/v2 [..., 3] against orig/dir [..., 3]. Typical
    uses: one ray against a [K, 3] triangle block (broadcast), or zipped
    [N, 3] vs [N, 3].

    Returns (hit [...] bool, t [...], u [...], v [...]). t/u/v are garbage
    where hit is False — always gate on the mask.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vm.cross(dir, e2)
    det = vm.dot(e1, pvec)
    # backface cull: det < EPS rejects (reference src/kernel.cl:239; with
    # EPS=0, det==0 falls through there but produces inf/NaN uv that the
    # range checks reject — `det > eps` is the equivalent dense-mask form)
    ok = det > eps
    safe_det = jnp.where(det == 0.0, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = orig - v0
    u = vm.dot(tvec, pvec) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvec = vm.cross(tvec, e1)
    v = vm.dot(dir, qvec) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = vm.dot(e2, qvec) * inv_det
    ok = ok & (t > 0.0)
    return ok, t, u, v


def slab_t(near_b, far_b, orig, invdir):
    """Per-axis slab entry and exit distances (near_b - orig) * invdir
    and (far_b - orig) * invdir.

    A ray parallel to an axis (invdir = ±inf) whose origin lies exactly on
    a slab plane makes 0 * inf = NaN. Such a ray lies in the box's face,
    so the slab counts as not limiting it: entry -BIG, exit +BIG. A walk
    then follows the leaves on the descent's side of the plane, which
    hold every triangle such a ray can hit (straddling triangles are
    duplicated into both children)."""
    t_near = (near_b - orig) * invdir
    t_far = (far_b - orig) * invdir
    return (jnp.where(jnp.isnan(t_near), -BIG, t_near),
            jnp.where(jnp.isnan(t_far), BIG, t_far))


def hit_aabb(lo, hi, orig, invdir, sign):
    """Slab test with entry/exit face ids (reference hit_AABB,
    src/kernel.cl:101-144).

    lo/hi: [..., 3] box corners; orig/invdir: [..., 3]; sign: [..., 3]
    int (1 where invdir < 0). Returns (hit, tmin, tmax, near_face,
    far_face). `hit` requires the slabs to overlap AND tmax > 0, exactly as
    the reference (src/kernel.cl:143).
    """
    # bounds[sign] per axis: sign==0 → lo, sign==1 → hi
    signf = sign.astype(lo.dtype)
    near_b = lo + signf * (hi - lo)       # bounds[sign]
    far_b = hi - signf * (hi - lo)        # bounds[1 - sign]
    t_near, t_far = slab_t(near_b, far_b, orig, invdir)  # [..., 3]

    tmin = t_near[..., 0]
    tmax = t_far[..., 0]
    near_face = sign[..., 0]
    far_face = 1 - sign[..., 0]

    miss = (tmin > t_far[..., 1]) | (t_near[..., 1] > tmax)
    take = t_near[..., 1] > tmin
    near_face = jnp.where(take, 2 + sign[..., 1], near_face)
    tmin = jnp.where(take, t_near[..., 1], tmin)
    take = t_far[..., 1] < tmax
    far_face = jnp.where(take, 3 - sign[..., 1], far_face)
    tmax = jnp.where(take, t_far[..., 1], tmax)

    miss = miss | (tmin > t_far[..., 2]) | (t_near[..., 2] > tmax)
    take = t_near[..., 2] > tmin
    near_face = jnp.where(take, 4 + sign[..., 2], near_face)
    tmin = jnp.where(take, t_near[..., 2], tmin)
    take = t_far[..., 2] < tmax
    far_face = jnp.where(take, 5 - sign[..., 2], far_face)
    tmax = jnp.where(take, t_far[..., 2], tmax)

    hit = (~miss) & (tmax > 0.0)
    return hit, tmin, tmax, near_face, far_face


def traverse_aabb(lo, hi, orig, invdir, sign):
    """Exit-face-only slab walk for rope hops (reference traverse_AABB,
    src/kernel.cl:146-174). Returns (tmin, tmax, far_face). Note: like the
    reference, no miss handling — callers invoke this on a box the ray is
    known to pass through."""
    signf = sign.astype(lo.dtype)
    near_b = lo + signf * (hi - lo)
    far_b = hi - signf * (hi - lo)
    t_near, t_far = slab_t(near_b, far_b, orig, invdir)

    tmin = t_near[..., 0]
    tmax = t_far[..., 0]
    far_face = 1 - sign[..., 0]

    tmin = jnp.maximum(tmin, t_near[..., 1])
    take = t_far[..., 1] < tmax
    far_face = jnp.where(take, 3 - sign[..., 1], far_face)
    tmax = jnp.where(take, t_far[..., 1], tmax)

    tmin = jnp.maximum(tmin, t_near[..., 2])
    take = t_far[..., 2] < tmax
    far_face = jnp.where(take, 5 - sign[..., 2], far_face)
    tmax = jnp.where(take, t_far[..., 2], tmax)
    return tmin, tmax, far_face


def hit_sphere(center, radius, orig, dir):
    """Ray-sphere intersection (the reference's *intended* primitive;
    its version is dead code with an inside-sphere bug it never exercised).

    Returns (hit, t) with t the nearest positive root. Broadcasts like
    moller_trumbore.
    """
    oc = orig - center
    a = vm.dot(dir, dir)
    b = 2.0 * vm.dot(dir, oc)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = jnp.where(t0 > 0.0, t0, t1)
    ok = ok & (t > 0.0)
    return ok, t


def nearest_hit_bruteforce(scene, orig, dir, t_min_eps: float = 0.0):
    """Linear scan over every triangle + sphere: the oracle intersector.

    BASELINE config[0]'s "flat linear-scan intersect" and the golden-image
    reference for tree-traversal tests. O(F) per ray but fully dense —
    a [N_rays, F] broadcastable computation.

    Returns dict with hit [N] bool, t [N], prim_id [N] (triangle index, or
    F + sphere index), u/v [N] barycentrics (0 for spheres).
    """
    v0, v1, v2 = scene.tri_verts()  # [F, 3]
    # [N, 1, 3] vs [1, F, 3]
    o = orig[:, None, :]
    d = dir[:, None, :]
    ok, t, u, v = moller_trumbore(v0[None], v1[None], v2[None], o, d)
    big = 3.4e38  # plain float: avoids a hoisted jaxpr constant
    t_masked = jnp.where(ok & (t > t_min_eps), t, big)
    # reference tie rule `t <= minHit` (src/kernel.cl:344): on exact-equal t
    # the LATER candidate wins — take the last argmin, not the first
    nf_all = t_masked.shape[1]
    best = (nf_all - 1) - jnp.argmin(t_masked[:, ::-1], axis=1)
    n = orig.shape[0]
    rows = jnp.arange(n)
    best_t = t_masked[rows, best]
    hit = best_t < big
    out = {
        "hit": hit,
        "t": best_t,
        "prim_id": best.astype(jnp.int32),
        "u": u[rows, best],
        "v": v[rows, best],
    }

    nf = scene.num_tris
    if scene.num_spheres:
        sok, st = hit_sphere(scene.sphere_pos[None], scene.sphere_radius[None],
                             o, d)
        st_masked = jnp.where(sok & (st > t_min_eps), st, big)
        sbest = jnp.argmin(st_masked, axis=1)
        sbest_t = st_masked[rows, sbest]
        sph_wins = sbest_t < out["t"]
        out["t"] = jnp.where(sph_wins, sbest_t, out["t"])
        out["prim_id"] = jnp.where(
            sph_wins, nf + sbest.astype(jnp.int32), out["prim_id"])
        out["hit"] = out["hit"] | (sbest_t < big)
        out["u"] = jnp.where(sph_wins, 0.0, out["u"])
        out["v"] = jnp.where(sph_wins, 0.0, out["v"])
    return out
