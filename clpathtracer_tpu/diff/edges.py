"""Edge-aware (silhouette) gradients for primary visibility.

diff/grad.py's detached-topology decomposition gives exact INTERIOR
gradients but exactly zero gradient where the image moves because a
silhouette moves — the flagship inverse-rendering failure mode (VERDICT
r2 #6; BASELINE north star: "reparameterized/edge-aware pixel
gradients").

The estimator (implemented in render/integrator.py::shade_edgeaware and
reachable from the public API via RenderOptions.edge_aware, normal and
path modes) is screen-space silhouette reparameterization in the style
of nvdiffrast's analytic edge antialiasing, recast for a ray tracer:

* the hit's barycentrics (u, v, 1-u-v) are differentiable functions of
  the scene (diff/grad.py re-resolve). Their minimum m is a
  differentiable "distance to the winning triangle's boundary" that
  goes to zero exactly on silhouettes;
* a pixel near a boundary blends its own shading toward the shading of
  the CONTINUATION ray (re-cast past the hit: the surface the
  silhouette occludes, or the background) with weight
  alpha = clip(m / |∇m|, 0, 1), where |∇m| is the screen-space
  gradient of m — normalizing the blend band to ~1 pixel regardless of
  triangle size. The band is NOT detached: it moves with the scene,
  and a finite-difference probe of the smoothed render sees that
  motion (detaching it makes jax.grad disagree with FD in both sign
  and magnitude — measured on the occluder test);
* gradients flow through m: moving a vertex moves the silhouette,
  which moves alpha, which transfers radiance across the edge — the
  boundary integral term, estimated over a one-pixel band on the
  occluder side. Summed over the band, d(image)/d(edge position)
  equals the hard renderer's (c_in - c_out) x edge-length, so losses
  integrated over edge-straddling crops get the correct derivative.
* interior mesh edges (shared by adjacent coplanar-ish faces) blend
  two nearly equal shadings: bias and gradient contribution both ~0,
  so no silhouette classification pass is needed.

The smoothing perturbs the forward image only inside the one-pixel
band (alpha=1 elsewhere), so the estimator stays consistent with the
hard render as the band shrinks.

Reference parity note: the reference has no gradients at all; this is
part of the differentiable axis this framework adds.
"""

from __future__ import annotations

import dataclasses

from clpathtracer_tpu.render.integrator import (  # noqa: F401 (re-export)
    RenderOptions, _edge_band, render_image, shade_edgeaware)


def render_edgeaware(scene, camera, opts: RenderOptions, tree=None,
                     key=None):
    """[H, W, 3] render whose jax.grad carries silhouette terms (w.r.t.
    scene.verts, normals, materials and camera). Convenience wrapper:
    equivalent to render_image with differentiable=True and
    edge_aware=True (the public-API route; parallel/train.py's
    make_train_step picks it up through the same flag)."""
    opts_d = dataclasses.replace(opts, differentiable=True,
                                 edge_aware=True)
    return render_image(scene, camera, opts_d, tree=tree, key=key)
