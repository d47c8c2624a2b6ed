"""The rendering integrator: scene + camera → image, as one pure function.

Replaces the reference's frame machinery (CLExecute's arg registry + NDRange
enqueue + clFinish, src/CLState.c:204-219) with a jitted function of pytrees.
Three shading modes:

* "normal"  — reference-parity: first hit → normals-as-color
  (src/kernel.cl:395-397), miss → white (src/kernel.cl:421 with col=0,
  str=1). This is the mode golden-image tests compare bit-for-bit.
* "mirror"  — the reference's *intended* multi-bounce mirror shading, which
  is unreachable dead code there (src/kernel.cl:399-417 after the early
  return): blend col=(1-str)·col + str·normalColor, str·=0.2, reflect with
  1e-4 origin offset, recurse; miss/depth-exhaust → blend toward white.
* "path"    — a physically-based Lambertian path tracer with per-face
  albedo/emission, cosine-weighted hemisphere sampling and stratified
  subpixel jitter — the multi-bounce diffuse integrator the BASELINE
  configs require (config[1]); entirely new capability.

`use_tree=False` is the flat linear-scan intersector (BASELINE config[0]);
`use_tree=True` goes through the wavefront kd traversal (ops/traverse.py).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp

from clpathtracer_tpu.core import vecmath as vm
from clpathtracer_tpu.core.camera import (
    cam_matrix, generate_rays, generate_rays_jittered)
from clpathtracer_tpu.ops.intersect import hit_sphere, nearest_hit_bruteforce
from clpathtracer_tpu.ops.traverse import PackedTris, traverse
from clpathtracer_tpu.ops.traverse_fast import pack_quads, traverse_fast
from clpathtracer_tpu.render.shading import (
    cosine_sample_hemisphere, normal_color, resolve_sphere_hits,
    resolve_tri_hits)

BIG = 3.4e38  # plain float: avoids a hoisted jaxpr constant


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render configuration (hashable → jit static argument).

    Replaces the reference's compile-time #defines and GameProperties
    struct (SURVEY.md §5 config tiers).
    """

    width: int = 256
    height: int = 256
    mode: str = "normal"       # normal | mirror | path
    bounces: int = 2           # reference launches trace_ray(depth=2)
    spp: int = 1               # samples per pixel (path mode)
    use_tree: bool = True
    tri_block: int = 4         # must divide the tree's leaf padding
    background: float = 1.0    # miss shade (reference blends toward white)
    bounce_eps: float = 1e-4   # reflection origin offset (src/kernel.cl:401)
    max_iters: int = 16384     # traversal safety cap
    compact: bool = True       # wavefront wind-down compaction (fast path)
    nee: bool = False          # path mode: next-event estimation (direct
    #   light sampling with shadow rays) — much lower variance for small
    #   emitters
    differentiable: bool = False  # detached-topology hits (diff/grad.py) so
    #   jax.grad flows through t/u/v to camera, verts and materials
    scene_axis: str = None     # treelet ring: mesh axis name the scene is
    #   sharded over (set by parallel/treelet.py wrappers when rendering
    #   inside shard_map; None = scene replicated / sequential ring)
    bounce_grid: bool = None   # route incoherent bounce/shadow waves
    #   through the scene's attached uniform grid (tree.grid) when one
    #   exists. None resolves from CLPT_BOUNCE_GRID at CONSTRUCTION time
    #   (default on): the choice then lives in the hashable options and
    #   participates in the jit cache key, so flipping the env var
    #   between same-shape calls can never silently reuse a stale cached
    #   program, and an explicit False opts out per-render.
    bounce_walk: bool = None   # route incoherent bounce waves through
    #   the walk-tuned shadow tree (tree.shadow) on SURFACE scenes when
    #   one is attached. None resolves from CLPT_BOUNCE_WALK at
    #   CONSTRUCTION time (default on), like bounce_grid above.
    edge_aware: bool = False   # silhouette-reparameterized gradients:
    #   blend a one-pixel band at visibility edges toward the
    #   continuation ray's shading (normal mode) / radiance (path mode)
    #   so jax.grad carries the boundary term a detached-topology
    #   renderer loses (diff/edges.py rationale; north star:
    #   "reparameterized/edge-aware pixel gradients"). Costs one extra
    #   traversal + shading pass. Forward image changes only inside the
    #   band. Ignored in mirror mode.

    def __post_init__(self):
        if self.bounce_grid is None:
            object.__setattr__(
                self, "bounce_grid",
                os.environ.get("CLPT_BOUNCE_GRID", "1") == "1")
        if self.bounce_walk is None:
            object.__setattr__(
                self, "bounce_walk",
                os.environ.get("CLPT_BOUNCE_WALK", "1") == "1")


# ---------------------------------------------------------------------------
# intersection dispatch
# ---------------------------------------------------------------------------


def intersect_scene(scene, tree, orig, dir, opts: RenderOptions,
                    coherent: bool = True, active=None):
    """Nearest hit against triangles (+ spheres). Returns dict with
    hit [N] bool, t [N], tri [N] (-1 if none), u/v [N], sphere [N] (-1 if
    the nearest hit is not a sphere).

    coherent: whether the wavefront is camera rays. Incoherent waves
    (bounces) take the scene's per-ray accelerator when one is attached:
    the uniform grid on fog-like scenes (tree.grid, opts.bounce_grid),
    the small-leaf shadow tree on surface scenes (tree.shadow,
    opts.bounce_walk).

    active: optional [N] bool — lanes whose paths already terminated.
    Passed to the walks as the wavefront-compaction mask: dead lanes fold
    out in the first wind-down round."""
    n = orig.shape[0]
    is_stree = type(tree).__name__ == "ShardedTree"
    if opts.differentiable and scene.num_tris > 0:
        from clpathtracer_tpu.diff.grad import intersect_diff
        out = dict(intersect_diff(
            scene, tree if opts.use_tree else None, orig, dir,
            tri_block=opts.tri_block, max_iters=opts.max_iters,
            scene_axis=opts.scene_axis, coherent=coherent,
            bounce_grid=opts.bounce_grid, active=active))
    elif is_stree and opts.use_tree and scene.num_tris > 0:
        # scene-parallel treelet ring (parallel/treelet.py): blocks rotate
        # with ppermute when opts.scene_axis names a live mesh axis, else
        # the sequential single-device loop
        from clpathtracer_tpu.parallel.treelet import intersect_ring
        out = dict(intersect_ring(tree, orig, dir,
                                  axis_name=opts.scene_axis,
                                  max_iters=opts.max_iters))
    elif opts.use_tree and tree is not None and scene.num_tris > 0:
        v0, v1, v2 = scene.tri_verts()
        if tree.node_table is not None and opts.tri_block == 4:
            if not coherent and tree.grid is not None and opts.bounce_grid:
                # incoherent bounce wave on a fog-like scene with a grid
                # attached (accel/sah.py::attach_grid): per-ray DDA
                # nearest-hit, no root descent
                from clpathtracer_tpu.ops.grid_walk import traverse_grid
                rec = traverse_grid(tree.grid, orig, dir,
                                    max_iters=opts.max_iters,
                                    compact=opts.compact, active=active)
            elif (not coherent and tree.shadow is not None
                    and opts.bounce_walk):
                # incoherent bounce wave on a SURFACE scene with the
                # small-leaf tree attached (accel/sah.py::
                # attach_shadow_tree): hemisphere-scattered rays mostly
                # escape, and the small leaves let a walk exit fast
                rec = traverse_fast(tree.shadow, tree.shadow.quads, orig,
                                    dir, max_iters=opts.max_iters,
                                    compact=opts.compact, active=active)
            else:
                # baked at build time when available; repacking gathers
                # the whole triangle set every frame
                quads = (tree.quads if tree.quads is not None
                         else pack_quads(tree.tri_indices, v0, v1, v2))
                rec = traverse_fast(tree, quads, orig, dir,
                                    max_iters=opts.max_iters,
                                    compact=opts.compact, active=active)
        else:
            packed = PackedTris.pack(tree, v0, v1, v2)
            rec = traverse(tree, packed, orig, dir,
                           tri_block=opts.tri_block,
                           max_iters=opts.max_iters)
        out = {"hit": rec["hit"], "t": rec["t"], "tri": rec["tri"],
               "u": rec["u"], "v": rec["v"]}
    elif scene.num_tris > 0:
        rec = nearest_hit_bruteforce(scene, orig, dir)
        out = {"hit": rec["hit"], "t": rec["t"],
               "tri": jnp.where(rec["hit"], rec["prim_id"], -1),
               "u": rec["u"], "v": rec["v"]}
        # brute-force oracle folds spheres in via prim_id ≥ F; normalize to
        # the (tri, sphere) split below
        nf = scene.num_tris
        is_sph = out["tri"] >= nf
        out["sphere"] = jnp.where(is_sph, out["tri"] - nf, -1)
        out["tri"] = jnp.where(is_sph, -1, out["tri"])
        return out
    else:
        out = {"hit": jnp.zeros((n,), bool), "t": jnp.full((n,), BIG),
               "tri": jnp.full((n,), -1, jnp.int32),
               "u": jnp.zeros((n,)), "v": jnp.zeros((n,))}

    out["sphere"] = jnp.full((n,), -1, jnp.int32)
    if scene.num_spheres > 0:
        sok, st = hit_sphere(scene.sphere_pos[None], scene.sphere_radius[None],
                             orig[:, None, :], dir[:, None, :])
        st = jnp.where(sok, st, BIG)
        sbest = jnp.argmin(st, axis=1)
        s_t = st[jnp.arange(n), sbest]
        wins = s_t < out["t"]
        out["t"] = jnp.where(wins, s_t, out["t"])
        out["hit"] = out["hit"] | (s_t < BIG)
        out["tri"] = jnp.where(wins, -1, out["tri"])
        out["sphere"] = jnp.where(wins, sbest.astype(jnp.int32), -1)
        out["u"] = jnp.where(wins, 0.0, out["u"])
        out["v"] = jnp.where(wins, 0.0, out["v"])
    return out


def _surface(scene, rec, orig, dir, opts=None):
    """Merge triangle/sphere attribute resolution for a hit record."""
    n = orig.shape[0]
    point = orig + rec["t"][:, None] * dir
    if scene.num_tris == 0:
        # sphere-only / empty scene: no triangle rows to gather
        z = jnp.zeros((n, 3))
        tri_at = {"normal": z, "albedo": z, "emission": z}
    else:
        # baked shade rows would detach material/normal gradients
        allow_baked = not (opts is not None and opts.differentiable)
        tri_at = resolve_tri_hits(scene, rec["tri"], rec["u"], rec["v"],
                                  allow_baked=allow_baked)
    if scene.num_spheres > 0:
        sph_at = resolve_sphere_hits(scene, rec["sphere"], point)
        is_sph = (rec["sphere"] >= 0)[:, None]
        normal = jnp.where(is_sph, sph_at["normal"], tri_at["normal"])
        albedo = jnp.where(is_sph, sph_at["albedo"], tri_at["albedo"])
        emission = jnp.where(is_sph, sph_at["emission"], tri_at["emission"])
    else:
        normal, albedo, emission = (
            tri_at["normal"], tri_at["albedo"], tri_at["emission"])
    return point, normal, albedo, emission


# ---------------------------------------------------------------------------
# shading modes
# ---------------------------------------------------------------------------


def shade_normal(scene, tree, orig, dir, opts: RenderOptions,
                 first_rec=None, first_coherent: bool = True,
                 first_active=None):
    """Reference-parity: hit → (normal+1)/2, miss → white.

    first_rec: precomputed intersection record for these rays (the
    edge-aware pass traces once and shades twice); first_coherent/
    first_active configure the trace when first_rec is None."""
    rec = first_rec
    if rec is None:
        rec = intersect_scene(scene, tree, orig, dir, opts,
                              coherent=first_coherent,
                              active=first_active)
    _, normal, _, _ = _surface(scene, rec, orig, dir, opts)
    bg = jnp.full_like(normal, opts.background)
    return jnp.where(rec["hit"][:, None], normal_color(normal), bg)


def shade_mirror(scene, tree, orig, dir, opts: RenderOptions):
    """The reference's intended mirror-bounce shading, made reachable.

    Per bounce (src/kernel.cl:399-417): col = (1-str)·col + str·normColor;
    str ·= 0.2; reflect about the normal with a 1e-4 offset. On miss or
    depth exhaustion: col = (1-str)·col + str·background
    (src/kernel.cl:421).
    """
    n = orig.shape[0]
    col = jnp.zeros((n, 3))
    strength = jnp.ones((n,))
    alive = jnp.ones((n,), bool)
    o, d = orig, dir
    for b in range(opts.bounces):
        rec = intersect_scene(scene, tree, o, d, opts, coherent=(b == 0),
                              active=None if b == 0 else alive)
        point, normal, _, _ = _surface(scene, rec, o, d, opts)
        hit = rec["hit"] & alive
        nc = normal_color(normal)
        col = jnp.where(hit[:, None],
                        (1.0 - strength[:, None]) * col + strength[:, None] * nc,
                        col)
        strength = jnp.where(hit, strength * 0.2, strength)
        newdir = vm.reflect(d, normal)
        o = jnp.where(hit[:, None], point + newdir * opts.bounce_eps, o)
        d = jnp.where(hit[:, None], newdir, d)
        # rays that were alive but missed: finalize with background blend
        missed = alive & ~rec["hit"]
        col = jnp.where(missed[:, None],
                        (1.0 - strength[:, None]) * col
                        + strength[:, None] * opts.background,
                        col)
        alive = alive & rec["hit"]
    # depth exhausted for still-alive rays (reference depth==0 branch)
    col = jnp.where(alive[:, None],
                    (1.0 - strength[:, None]) * col
                    + strength[:, None] * opts.background,
                    col)
    return col


def _occluded(scene, tree, orig, dir, dist, opts: RenderOptions,
              active=None):
    """Boolean shadow query: anything closer than `dist` along dir?

    Uses the distance-bounded wavefront (traverse_fast t_max) when a
    packed tree exists — hits beyond the light don't matter, and the bound
    early-exits whole subtrees. Topology-discrete → wrapped in
    stop_gradient (visibility has zero gradient a.e.).
    """
    sg = jax.lax.stop_gradient
    o, d, dd = sg(orig), sg(dir), sg(dist)
    if type(tree).__name__ == "ShardedTree":
        from clpathtracer_tpu.parallel.treelet import intersect_ring
        rec = intersect_ring(sg(tree), o, d, axis_name=opts.scene_axis,
                             max_iters=opts.max_iters)
        occ = rec["hit"] & (rec["t"] < dd - 1e-3)
    elif (opts.use_tree and tree is not None
            and tree.node_table is not None and opts.tri_block == 4):
        act = None if active is None else sg(active)
        if tree.grid is not None:
            # uniform-grid DDA occlusion (accel/grid.py, attach_grid):
            # preferred for fog-like scenes — the any-hit query settles
            # within a handful of cells with no root descent and no
            # node-row gather per step
            from clpathtracer_tpu.ops.grid_walk import traverse_grid
            rec = traverse_grid(sg(tree.grid), o, d,
                                max_iters=opts.max_iters,
                                compact=opts.compact,
                                t_max=dd - 1e-3, active=act,
                                any_hit=True)
        else:
            # small-leaf shadow tree when attached (accel/sah.py::
            # attach_shadow_tree): the occlusion walk's cost is quad
            # steps until the first hit
            wtree = tree.shadow if tree.shadow is not None else tree
            quads = (wtree.quads if wtree.quads is not None
                     else pack_quads(wtree.tri_indices, *scene.tri_verts()))
            rec = traverse_fast(wtree, sg(quads), o, d,
                                max_iters=opts.max_iters,
                                compact=opts.compact,
                                t_max=dd - 1e-3, active=act,
                                any_hit=True)
        occ = rec["hit"]
    else:
        srec = intersect_scene(scene, tree, o, d, opts, coherent=False)
        occ = srec["hit"] & (srec["t"] < dd - 1e-3)
        return occ
    if scene.num_spheres > 0:
        sok, st = hit_sphere(sg(scene.sphere_pos)[None],
                             sg(scene.sphere_radius)[None],
                             o[:, None, :], d[:, None, :])
        occ = occ | jnp.any(sok & (st < (dd - 1e-3)[:, None]), axis=1)
    return occ


def _sample_light(scene, key, n):
    """Area-sample emissive triangles: returns (point [n,3], normal [n,3],
    emitted [n,3], pdf_area [n], any_light scalar bool).

    Faces weighted by luminance x area; barycentric-uniform point on the
    chosen face. pdf is per unit area so the G-term conversion applies.
    """
    if scene.num_tris == 0:
        z = jnp.zeros((n, 3))
        return z, z, z, jnp.ones((n,)), jnp.asarray(False)
    v0, v1, v2 = scene.tri_verts()
    cross = vm.cross(v1 - v0, v2 - v0)
    area = 0.5 * vm.length(cross)
    lum = jnp.max(scene.emission, axis=-1)
    w = lum * area
    total = jnp.sum(w)
    probs = w / jnp.maximum(total, 1e-30)

    kf, kb = jax.random.split(key)
    # inverse-CDF sample, NOT jax.random.categorical: categorical's
    # Gumbel-max reduces over an (n, num_tris) product — ~2.6e11
    # generated elements per 262k-ray wave on a 1M-tri scene (XLA fuses
    # the reduce so it fits, but the arithmetic alone costs seconds).
    # searchsorted is n * log2(num_tris) work.
    cdf = jnp.cumsum(probs)
    u = jax.random.uniform(kf, (n,)) * cdf[-1]
    f = jnp.clip(jnp.searchsorted(cdf, u), 0, probs.shape[0] - 1)
    uv = jax.random.uniform(kb, (n, 2))
    su = jnp.sqrt(uv[:, 0])
    bu = 1.0 - su
    bv = uv[:, 1] * su
    p = (bu[:, None] * v0[f] + bv[:, None] * v1[f]
         + (1.0 - bu - bv)[:, None] * v2[f])
    nrm = vm.normalize(cross[f], eps=1e-30)
    pdf_area = probs[f] / jnp.maximum(area[f], 1e-30)
    return p, nrm, scene.emission[f], pdf_area, total > 0.0


def shade_path(scene, tree, orig, dir, opts: RenderOptions, key,
               first_rec=None, first_coherent: bool = True,
               first_active=None):
    """Lambertian path tracing with emissive surfaces.

    radiance += throughput · emission at each hit; throughput ·= albedo;
    new direction cosine-sampled about the shading normal (flipped to face
    the incoming ray). With opts.nee, each vertex additionally area-samples
    the emitters and casts a shadow ray (next-event estimation — far lower
    variance for small lights); emitters then only contribute via BSDF
    bounces on the primary hit to avoid double counting.
    """
    n = orig.shape[0]
    radiance = jnp.zeros((n, 3))
    throughput = jnp.ones((n, 3))
    alive = (jnp.ones((n,), bool) if first_active is None
             else jnp.asarray(first_active))
    o, d = orig, dir
    for b in range(opts.bounces):
        if b == 0 and first_rec is not None:
            rec = first_rec
        else:
            rec = intersect_scene(
                scene, tree, o, d, opts,
                coherent=(b == 0 and first_coherent),
                active=(first_active if b == 0 else alive))
        point, normal, albedo, emission = _surface(scene, rec, o, d, opts)
        # one-sided emitters: the surface emits from its front face only,
        # matching NEE's cos_l > 0 gate below so nee=True and nee=False
        # converge to the same image
        front = vm.dot(normal, d) < 0.0
        # face-forward normal
        normal = jnp.where(vm.dot(normal, d)[:, None] > 0, -normal, normal)
        hit = rec["hit"] & alive
        # emission via BSDF path: always without NEE; primary-hit only with
        # NEE (later vertices' direct light arrives via the shadow rays)
        take_emit = ((hit & front) if (not opts.nee or b == 0)
                     else jnp.zeros_like(hit))
        radiance = radiance + jnp.where(
            take_emit[:, None], throughput * emission, 0.0)
        # miss → background radiance (sky), then die
        missed = alive & ~rec["hit"]
        radiance = radiance + jnp.where(
            missed[:, None], throughput * opts.background, 0.0)
        alive = hit

        if opts.nee:
            # NEE uses the PRE-bounce throughput: the BRDF factor for the
            # light direction is albedo/pi right here — the albedo update
            # below belongs to the cosine-sampled continuation only
            key, kl = jax.random.split(key)
            lp, ln, lemit, pdf_a, any_light = _sample_light(scene, kl, n)
            to_l = lp - point
            dist2 = jnp.maximum(vm.length_squared(to_l), 1e-12)
            dist = jnp.sqrt(dist2)
            wi = to_l / dist[:, None]
            # Sanitize the shadow directions unconditionally: on a scene
            # with zero emitters _sample_light's face choice is garbage
            # (all-zero weights), and a non-finite direction must never
            # reach the traversal.
            wi_ok = jnp.all(jnp.isfinite(wi), axis=-1)
            safe = jnp.zeros_like(wi).at[:, 1].set(1.0)
            wi = jnp.where(wi_ok[:, None], wi, safe)
            cos_s = vm.dot(normal, wi)
            cos_l = vm.dot(ln, -wi)
            facing = (cos_s > 0.0) & (cos_l > 0.0)
            # Gate the ENTIRE shadow traversal (not just the contribution)
            # on any_light: with no emitters the query is pure wasted,
            # hazardous work on meaningless rays (VERDICT r2 item 2).
            unoccluded = jax.lax.cond(
                any_light,
                lambda: ~_occluded(
                    scene, tree, point + normal * opts.bounce_eps, wi, dist,
                    opts, active=hit & facing & wi_ok),
                lambda: jnp.zeros((n,), bool))
            g = cos_s * cos_l / dist2
            contrib = (throughput * (albedo / jnp.pi) * lemit
                       * (g / jnp.maximum(pdf_a, 1e-30))[:, None])
            use = hit & facing & unoccluded & any_light & wi_ok
            radiance = radiance + jnp.where(use[:, None], contrib, 0.0)
        throughput = jnp.where(hit[:, None], throughput * albedo, throughput)

        key, sub = jax.random.split(key)
        u12 = jax.random.uniform(sub, (n, 2))
        newdir = cosine_sample_hemisphere(normal, u12[:, 0], u12[:, 1])
        o = jnp.where(hit[:, None], point + normal * opts.bounce_eps, o)
        d = jnp.where(hit[:, None], newdir, d)
    return radiance


# ---------------------------------------------------------------------------
# edge-aware (silhouette-reparameterized) shading
# ---------------------------------------------------------------------------


def _edge_band(m, rows, cols):
    """Per-pixel blend band: max |4-neighbour difference| of m, floored
    so flat regions don't blow the ratio up. NOT detached: the band
    itself moves with the scene and a finite-difference probe of the
    smoothed render sees that motion (diff/edges.py measurement — a
    detached band disagrees with FD in sign AND magnitude)."""
    mi = m.reshape(rows, cols)
    diffs = [jnp.abs(mi - jnp.roll(mi, s, axis=a))
             for a in (0, 1) for s in (1, -1)]
    g = jnp.maximum(jnp.maximum(diffs[0], diffs[1]),
                    jnp.maximum(diffs[2], diffs[3]))
    return jnp.maximum(g, 1e-4).reshape(-1)


def shade_edgeaware(scene, tree, orig, dir, opts: RenderOptions, key):
    """Silhouette-reparameterized shading (normal and path modes).

    The hit's min-barycentric m is a differentiable distance to the
    winning triangle's boundary that vanishes exactly on silhouettes; a
    pixel inside the one-pixel band blends its shading toward the
    CONTINUATION ray's (the surface the silhouette occludes, or the
    background) with weight alpha = clip(m/|∇m|, 0, 1). Gradients flow
    through m: moving a vertex moves alpha, which transfers radiance
    across the edge — the boundary term a detached-topology renderer
    loses (full rationale: diff/edges.py). Costs one extra traversal +
    shading pass; the forward image changes only inside the band.

    Works on any wavefront whose lane count is a multiple of the image
    width (full frames, or row-sharded blocks under shard_map — the
    band then wraps at block edges, a one-row approximation)."""
    n = orig.shape[0]
    cols = opts.width if n % opts.width == 0 else n
    rec1 = intersect_scene(scene, tree, orig, dir, opts)
    u, v = rec1["u"], rec1["v"]
    m = jnp.where(rec1["tri"] >= 0,
                  jnp.minimum(jnp.minimum(u, v), 1.0 - u - v), 1.0)
    alpha = jnp.clip(m / _edge_band(m, n // cols, cols), 0.0, 1.0)

    # continuation ray: what the silhouette occludes. Topology and the
    # step are detached; its shading is differentiable on its own.
    sg = jax.lax.stop_gradient
    t_det = sg(rec1["t"])
    step = jnp.where(rec1["hit"], t_det * 1e-3 + opts.bounce_eps, 0.0)
    o2 = orig + (t_det + step)[:, None] * dir

    if opts.mode == "path":
        if key is None:
            key = jax.random.PRNGKey(0)
        # same key for both passes: common random numbers keep the
        # blend's variance at the (c1 - c2) difference, not their sum
        c1 = shade_path(scene, tree, orig, dir, opts, key, first_rec=rec1)
        c2 = shade_path(scene, tree, o2, dir, opts, key,
                        first_coherent=False, first_active=rec1["hit"])
    else:
        c1 = shade_normal(scene, tree, orig, dir, opts, first_rec=rec1)
        c2 = shade_normal(scene, tree, o2, dir, opts,
                          first_coherent=False, first_active=rec1["hit"])
    return jnp.where(rec1["hit"][:, None],
                     alpha[:, None] * c1 + (1.0 - alpha[:, None]) * c2,
                     c1)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def render_rays(scene, tree, orig, dir, opts: RenderOptions, key=None):
    """Shade a wavefront of camera rays: [N, 3] colour or radiance."""
    if opts.edge_aware and opts.mode in ("normal", "path"):
        return shade_edgeaware(scene, tree, orig, dir, opts, key)
    if opts.mode == "normal":
        return shade_normal(scene, tree, orig, dir, opts)
    if opts.mode == "mirror":
        return shade_mirror(scene, tree, orig, dir, opts)
    if opts.mode == "path":
        if key is None:
            key = jax.random.PRNGKey(0)
        return shade_path(scene, tree, orig, dir, opts, key)
    raise ValueError(f"unknown mode {opts.mode!r}")


@partial(jax.jit, static_argnames=("opts",))
def render_image(scene, camera, opts: RenderOptions, tree=None, key=None):
    """Render an [H, W, 3] image. The whole frame is one XLA program —
    the analogue of the reference's per-frame CLExecute NDRange launch."""
    cam_inv = cam_matrix(camera, opts.height)
    if opts.mode == "path" and opts.spp > 1:
        if key is None:
            key = jax.random.PRNGKey(0)
        n = opts.width * opts.height
        keys = jax.random.split(key, opts.spp)

        def one_sample(k):
            kj, ks = jax.random.split(k)
            jitter = jax.random.uniform(kj, (1, n, 2))
            o, d = generate_rays_jittered(cam_inv, opts.width, opts.height,
                                          jitter)
            return render_rays(scene, tree, o[0], d[0], opts, ks)

        img = jax.lax.map(one_sample, keys).mean(axis=0)
    else:
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        img = render_rays(scene, tree, orig, dir, opts, key)
    return img.reshape(opts.height, opts.width, 3)
