"""Scene container: flat SoA device arrays as a differentiable pytree.

The device-array analogue of the reference's `kd` SoA container + `Object`
list (reference: include/kd_tree.h:10-16, include/object.h:9-22): vertices,
per-corner index triples, normals — plus what the reference stubbed out but
never finished: real sphere primitives (its sphere pipeline was dead code,
src/kernel.cl:199-225) and per-primitive materials (albedo/emission) for the
multi-bounce integrator.

Everything is a jnp array ⇒ the whole scene is a pytree: it can be donated,
sharded, and differentiated (e.g. gradients w.r.t. `verts` for inverse
rendering).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from clpathtracer_tpu.utils import struct


@struct.dataclass
class Scene:
    """Triangle + sphere scene.

    verts:    [V, 3] f32 vertex positions.
    faces:    [F, 3, 3] i32 — faces[f, corner] = (v_idx, vn_idx, vt_idx),
              -1 marks an absent normal/texcoord index (reference sentinel,
              src/kernel.cl:349).
    normals:  [VN, 3] f32 vertex normals (VN ≥ 1; row 0 is a placeholder
              when the mesh has none).
    albedo:   [F, 3] f32 per-face diffuse reflectance.
    emission: [F, 3] f32 per-face radiant exitance.
    sphere_pos/radius/albedo/emission: analytic sphere primitives
              ([S, 3], [S], [S, 3], [S, 3]; S may be 0).
    """

    verts: jnp.ndarray
    faces: jnp.ndarray
    normals: jnp.ndarray
    albedo: jnp.ndarray
    emission: jnp.ndarray
    sphere_pos: jnp.ndarray
    sphere_radius: jnp.ndarray
    sphere_albedo: jnp.ndarray
    sphere_emission: jnp.ndarray
    shade_rows: jnp.ndarray = None  # optional [F, 16] baked shading rows
    #   (n0, n1, n2, albedo, emission, pad) — one wide gather per hit
    #   instead of ~6 narrow ones; see bake_shading(). Stale after editing
    #   materials/normals — re-bake or set None. Ignored by the
    #   differentiable path (gradients need the live arrays).

    # ---------- constructors ----------

    @classmethod
    def create(cls, verts, faces, normals=None, albedo=None, emission=None,
               sphere_pos=None, sphere_radius=None, sphere_albedo=None,
               sphere_emission=None) -> "Scene":
        verts = jnp.asarray(verts, jnp.float32).reshape(-1, 3)
        faces = jnp.asarray(faces, jnp.int32).reshape(-1, 3, 3)
        nf = faces.shape[0]
        if normals is None or np.asarray(normals).size == 0:
            normals = jnp.zeros((1, 3), jnp.float32)
        else:
            normals = jnp.asarray(normals, jnp.float32).reshape(-1, 3)
        if albedo is None:
            albedo = jnp.full((nf, 3), 0.75, jnp.float32)
        else:
            albedo = jnp.broadcast_to(
                jnp.asarray(albedo, jnp.float32), (nf, 3))
        if emission is None:
            emission = jnp.zeros((nf, 3), jnp.float32)
        else:
            emission = jnp.broadcast_to(
                jnp.asarray(emission, jnp.float32), (nf, 3))
        if sphere_pos is None:
            sphere_pos = jnp.zeros((0, 3), jnp.float32)
            sphere_radius = jnp.zeros((0,), jnp.float32)
            sphere_albedo = jnp.zeros((0, 3), jnp.float32)
            sphere_emission = jnp.zeros((0, 3), jnp.float32)
        else:
            sphere_pos = jnp.asarray(sphere_pos, jnp.float32).reshape(-1, 3)
            ns = sphere_pos.shape[0]
            sphere_radius = jnp.asarray(sphere_radius, jnp.float32).reshape(ns)
            sphere_albedo = (
                jnp.broadcast_to(jnp.asarray(sphere_albedo, jnp.float32), (ns, 3))
                if sphere_albedo is not None else jnp.full((ns, 3), 0.75, jnp.float32))
            sphere_emission = (
                jnp.broadcast_to(jnp.asarray(sphere_emission, jnp.float32), (ns, 3))
                if sphere_emission is not None else jnp.zeros((ns, 3), jnp.float32))
        return cls(verts=verts, faces=faces, normals=normals, albedo=albedo,
                   emission=emission, sphere_pos=sphere_pos,
                   sphere_radius=sphere_radius, sphere_albedo=sphere_albedo,
                   sphere_emission=sphere_emission)

    @classmethod
    def from_obj(cls, path: str, **material_kwargs) -> "Scene":
        """Load a Wavefront OBJ (reference: src/model.c:147-176, .obj
        branch). MTL Kd/Ke resolve to per-face albedo/emission unless
        overridden via material_kwargs."""
        from clpathtracer_tpu.scene.objparser import load_obj
        d = load_obj(path)
        material_kwargs.setdefault("albedo", d["albedo"])
        material_kwargs.setdefault("emission", d["emission"])
        return cls.create(d["verts"], d["faces"], d["normals"],
                          **material_kwargs)

    # ---------- derived views ----------

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_pos.shape[0]

    def tri_verts(self):
        """Gathered corner positions (v0, v1, v2), each [F, 3].

        Differentiable w.r.t. `verts`; the gather stays inside jit so
        vertex-position gradients flow through intersection and shading.
        """
        idx = self.faces[:, :, 0]  # [F, 3]
        v = self.verts[idx]  # [F, 3, 3]
        return v[:, 0, :], v[:, 1, :], v[:, 2, :]

    def tri_normals(self):
        """Gathered per-corner vertex normals (n0, n1, n2) and a has-normals
        mask [F] (corner normal index ≥ 0, reference: src/kernel.cl:349)."""
        nidx = self.faces[:, :, 1]  # [F, 3]
        has = jnp.all(nidx >= 0, axis=-1)
        safe = jnp.maximum(nidx, 0)
        n = self.normals[safe]
        return n[:, 0, :], n[:, 1, :], n[:, 2, :], has

    def tri_corners(self):
        """Host-side [F, 3, 3] corner positions in FACE-WINDING order —
        the array `build_kd_tree` expects. Building a tree from raw
        vertex-order corners silently flips winding in the baked quads
        (backface culling then rejects everything)."""
        v = np.asarray(self.verts)
        return v[np.asarray(self.faces)[:, :, 0]]

    def bounds(self):
        """World AABB over triangle vertices (and spheres)."""
        lo = jnp.min(self.verts, axis=0)
        hi = jnp.max(self.verts, axis=0)
        if self.num_spheres:
            lo = jnp.minimum(lo, jnp.min(self.sphere_pos - self.sphere_radius[:, None], axis=0))
            hi = jnp.maximum(hi, jnp.max(self.sphere_pos + self.sphere_radius[:, None], axis=0))
        return lo, hi

    def with_verts(self, verts: jnp.ndarray) -> "Scene":
        return self.replace(verts=verts)

    def bake_shading(self) -> "Scene":
        """Precompute [F, 16] per-triangle shading rows.

        Per-corner normals are the vertex normals when the face carries
        them (all three indices >= 0, matching resolve_tri_hits), else the
        geometric normal replicated — interpolation then reproduces either
        case with a single wide gather at render time.
        """
        import numpy as np
        v = np.asarray(self.verts)
        f = np.asarray(self.faces)
        nrm = np.asarray(self.normals)
        nf = f.shape[0]
        p0, p1, p2 = v[f[:, 0, 0]], v[f[:, 1, 0]], v[f[:, 2, 0]]
        g = np.cross(p1 - p0, p2 - p0)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-30)
        has = (f[:, :, 1] >= 0).all(axis=-1)
        safe = np.maximum(f[:, :, 1], 0)
        corner = nrm[safe]  # [F, 3, 3]
        corner = np.where(has[:, None, None], corner,
                          np.repeat(g[:, None, :], 3, axis=1))
        rows = np.zeros((nf, 16), np.float32)
        rows[:, 0:9] = corner.reshape(nf, 9)
        rows[:, 9:12] = np.asarray(self.albedo)
        rows[:, 12:15] = np.asarray(self.emission)
        return self.replace(shade_rows=jnp.asarray(rows))
