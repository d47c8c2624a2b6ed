"""Run the renderer's main path once on an NVIDIA GPU and check it.

    python chip_smoke.py [--seed N]            # one card: phases 1-5
    python chip_smoke.py --cards 4 [--seed N]  # four cards: phase 6 only

One process drives the default device through the public entry points
(render_image, make_train_step, make_sharded_renderer,
make_treelet_renderer) on scenes generated from --seed:

1. device  — the default JAX device must be a GPU; there is no CPU
   fallback. Prints its kind, the device count, and the card's name and
   power limit as nvidia-smi reports them.
2. primary — 1M-triangle terrain, native kd build, render_image in normal
   mode at 512². A strided sample of 4096 of the frame's camera rays is
   traced by traverse_fast and by the brute-force oracle
   (ops/intersect.py::nearest_hit_bruteforce) over all triangles.
3. path    — 1M-triangle emissive soup with the uniform grid that
   fog_likeness picks; path mode, 2 bounces + NEE at 512². 4096
   incoherent rays (origins in the scene box, uniform directions) check
   the grid nearest-hit walk, the grid any-hit walk with t_max and the
   kd any-hit walk against the oracle, and the same rays check the
   small-leaf shadow tree's walks on the terrain.
4. train   — make_train_step on a one-device mesh: 100k-triangle soup with
   its grid, differentiable path mode, 2 bounces, 256², verts + albedo,
   adam, fresh keys; the albedo gradient is checked against central
   differences (diff/fd.py) at 3 entries.
5. memory  — the device's peak bytes in use.
6. cards   — with --cards N only: the row-sharded renderer against the
   single-device image (bit-identical), the treelet ring renderer against
   it, and make_train_step on a (rows=2, scene=2) treelet mesh against the
   single-device step.

Frame and step times are host-clock means over a few calls after a
warm-up call, each ending in block_until_ready. Any failure raises and the
process exits non-zero before the last line; the last line of standard
output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from clpathtracer_tpu.accel.grid import fog_likeness
from clpathtracer_tpu.accel.sah import (
    attach_grid, attach_shadow_tree, build_kd_tree)
from clpathtracer_tpu.core.camera import Camera, cam_matrix, generate_rays
from clpathtracer_tpu.ops.grid_walk import traverse_grid
from clpathtracer_tpu.ops.intersect import nearest_hit_bruteforce
from clpathtracer_tpu.ops.traverse_fast import traverse_fast
from clpathtracer_tpu.render.integrator import RenderOptions, render_image
from clpathtracer_tpu.scene.procedural import random_tri_soup, terrain_mesh
from clpathtracer_tpu.utils.device import enable_compile_cache

T_RTOL = 1e-5        # hit distance, as tests/test_traverse_fast.py
MASK_AGREE = 0.9999  # share of rays whose hit/occlusion boolean agrees
FD_RTOL = 0.15       # path-mode gradient vs FD, as tests/test_grad.py


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The sizes of a run. The defaults are the chip run; the CPU tests
    call the phases with tiny ones."""

    tris: int = 1_000_000      # terrain and soup triangles
    res: int = 512             # render width and height
    samples: int = 4096        # rays checked against the oracle
    oracle_chunk: int = 64     # rays per brute-force block ([chunk, F])
    train_tris: int = 100_000
    train_res: int = 256
    frames: int = 3            # timed calls after the warm-up call


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _tv(scene) -> np.ndarray:
    v0, v1, v2 = scene.tri_verts()
    return np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)


def timed(fn, frames: int):
    """(first-call seconds, mean ms of `frames` later calls, result).
    Every call ends in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return first, float(np.mean(times)), out


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def card_lines() -> list:
    """nvidia-smi's name and power limit, one line per card (a child
    process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def require_gpu(devices) -> dict:
    """The device record of the last line; SmokeFailure unless the
    default device is a GPU."""
    d = devices[0]
    check(d.platform == "gpu",
          f"needs a GPU; the default JAX device is {d.platform!r} "
          f"({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


# ---------------------------------------------------------------------------
# oracle comparison
# ---------------------------------------------------------------------------


# the walks under test, as intersect_scene / _occluded call them
kd_nearest = jax.jit(lambda t, o, d, active=None: traverse_fast(
    t, t.quads, o, d, active=active))
kd_any_hit = jax.jit(lambda t, o, d, t_max, active=None: traverse_fast(
    t, t.quads, o, d, t_max=t_max, active=active, any_hit=True))
grid_nearest = jax.jit(lambda g, o, d, active=None: traverse_grid(
    g, o, d, active=active))
grid_any_hit = jax.jit(lambda g, o, d, t_max, active=None: traverse_grid(
    g, o, d, t_max=t_max, active=active, any_hit=True))


@partial(jax.jit, static_argnames=("chunk",))
def oracle(scene, orig, dir, chunk: int):
    """Brute-force nearest hits, `chunk` rays at a time ([chunk, F])."""
    n = orig.shape[0]
    rec = jax.lax.map(
        lambda od: nearest_hit_bruteforce(scene, od[0], od[1]),
        (orig.reshape(n // chunk, chunk, 3),
         dir.reshape(n // chunk, chunk, 3)))
    return {k: v.reshape(n) for k, v in rec.items()}


def _edge_dist(u, v):
    return np.minimum(np.minimum(u, v), 1.0 - u - v)


def compare_nearest(name: str, got: dict, ref: dict) -> dict:
    """traverse_* record vs oracle record: hit mask, t, triangle id."""
    g_hit, r_hit = np.asarray(got["hit"]), np.asarray(ref["hit"])
    g_t, r_t = np.asarray(got["t"]), np.asarray(ref["t"])
    g_tri, r_tri = np.asarray(got["tri"]), np.asarray(ref["prim_id"])
    r_u, r_v = np.asarray(ref["u"]), np.asarray(ref["v"])
    n = g_hit.shape[0]
    mism = np.flatnonzero(g_hit != r_hit)
    for i in mism:
        kind = ("grazing" if r_hit[i] and _edge_dist(r_u[i], r_v[i]) < 1e-3
                else "not grazing")
        log(f"  {name} mismatch ray {i}: walk hit={bool(g_hit[i])} "
            f"t={g_t[i]!r} | oracle hit={bool(r_hit[i])} t={r_t[i]!r} "
            f"edge distance={_edge_dist(r_u[i], r_v[i])!r} ({kind})")
    both = g_hit & r_hit
    rel = np.abs(g_t - r_t) / np.maximum(np.abs(r_t), 1e-30)
    t_bad = both & (rel > T_RTOL)
    ties = both & (g_tri != r_tri) & ~t_bad
    agree = 1.0 - mism.size / n
    out = {"rays": n, "hits": int(r_hit.sum()), "mask_agree": agree,
           "mask_mismatch": int(mism.size),
           "t_max_rel_err": float(rel[both].max()) if both.any() else 0.0,
           "t_over_tol": int(t_bad.sum()), "tri_ties": int(ties.sum())}
    log(f"  {name}: {json.dumps(out)}")
    check(agree >= MASK_AGREE,
          f"{name}: hit masks agree on {agree:.6f} < {MASK_AGREE}")
    check(not t_bad.any(),
          f"{name}: {int(t_bad.sum())} hits differ in t by > {T_RTOL}")
    return out


def compare_occlusion(name: str, got: dict, ref: dict, t_max) -> dict:
    """any-hit walk with t_max vs the oracle's nearest hit < t_max."""
    t_max = np.asarray(t_max)
    g_occ = np.asarray(got["hit"])
    r_t = np.asarray(ref["t"])
    r_occ = np.asarray(ref["hit"]) & (r_t < t_max)
    n = g_occ.shape[0]
    mism = np.flatnonzero(g_occ != r_occ)
    for i in mism:
        log(f"  {name} mismatch ray {i}: walk occluded={bool(g_occ[i])} "
            f"oracle nearest t={r_t[i]!r} t_max={t_max[i]!r}")
    agree = 1.0 - mism.size / n
    below = bool((np.asarray(got["t"])[g_occ] < t_max[g_occ]).all())
    out = {"rays": n, "occluded": int(r_occ.sum()), "mask_agree": agree,
           "mask_mismatch": int(mism.size), "hits_below_t_max": below}
    log(f"  {name}: {json.dumps(out)}")
    check(agree >= MASK_AGREE,
          f"{name}: occlusion agrees on {agree:.6f} < {MASK_AGREE}")
    check(below, f"{name}: an any-hit reports t >= t_max")
    return out


def incoherent_rays(scene, n: int, seed: int):
    """n rays with origins uniform in the scene box and uniform
    directions, and per-ray t_max uniform in (0, box diagonal / 2)."""
    lo, hi = (np.asarray(x, np.float64) for x in scene.bounds())
    r = np.random.default_rng(seed)
    orig = r.uniform(lo, hi, size=(n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = r.uniform(0.0, 0.5 * np.linalg.norm(hi - lo), size=n)
    return (jnp.asarray(orig, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(t_max, jnp.float32))


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def terrain_scene(sizes: Sizes, seed: int):
    scene = terrain_mesh(sizes.tris, seed=seed, extent=10.0).bake_shading()
    cam = Camera.create(position=[0.0, 14.0, 0.0], forward=[0.0, -1.0, 0.01])
    return scene, cam


def soup_scene(n: int, seed: int, tri_size: float):
    scene = random_tri_soup(n, seed=seed, extent=10.0, tri_size=tri_size,
                            emissive_frac=0.001).bake_shading()
    cam = Camera.create(position=[0.0, 0.0, -25.0], forward=[0.0, 0.0, 1.0])
    return scene, cam


def build_tree(scene, label: str):
    tv = _tv(scene)
    t0 = time.perf_counter()
    tree = build_kd_tree(tv, tri_block=4, leaf_size=4, max_depth=22,
                         backend="native")
    log(f"  {label} kd build: {time.perf_counter() - t0!r} s "
        f"{json.dumps(tree.stats())}")
    return tree, tv


# ---------------------------------------------------------------------------
# phases 2-5
# ---------------------------------------------------------------------------


def phase_primary(sizes: Sizes, seed: int):
    """Returns (results, terrain) with terrain = (scene, tree, tv) for
    the path phase's shadow-tree checks."""
    log("phase primary: terrain, normal mode")
    scene, cam = terrain_scene(sizes, seed)
    tree, tv = build_tree(scene, "terrain")
    opts = RenderOptions(width=sizes.res, height=sizes.res, mode="normal")
    first, ms, img = timed(
        lambda: render_image(scene, cam, opts, tree=tree), sizes.frames)
    img = np.asarray(img)
    check(img.shape == (sizes.res, sizes.res, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "primary image has non-finite pixels")
    log(f"  primary compile+first s: {first!r}")
    log(f"  primary frame ms: {ms!r}")

    orig, dir = generate_rays(cam_matrix(cam, sizes.res), sizes.res,
                              sizes.res)
    rec = kd_nearest(tree, orig, dir)
    idx = np.arange(sizes.samples) * (orig.shape[0] // sizes.samples)
    got = {k: np.asarray(v)[idx] for k, v in rec.items()}
    ref = oracle(scene, orig[idx], dir[idx], sizes.oracle_chunk)
    cmp = compare_nearest("primary traverse_fast vs oracle", got, ref)
    return ({"frame_ms": ms, "first_s": first, "oracle": cmp},
            (scene, tree, tv))


def phase_path(sizes: Sizes, seed: int, terrain) -> dict:
    log("phase path: emissive soup, path mode, 2 bounces + NEE")
    scene, cam = soup_scene(sizes.tris, seed + 1, tri_size=0.01)
    tree, tv = build_tree(scene, "soup")
    fog = fog_likeness(tv)
    check(fog > 0.5, f"soup fog_likeness {fog} picks no grid")
    t0 = time.perf_counter()
    tree = attach_grid(tree, tv)
    log(f"  grid build: {time.perf_counter() - t0!r} s "
        f"{json.dumps(tree.grid.stats())}")
    opts = RenderOptions(width=sizes.res, height=sizes.res, mode="path",
                         bounces=2, nee=True, background=0.0)
    key = jax.random.PRNGKey(seed)
    first, ms, img = timed(
        lambda: render_image(scene, cam, opts, tree=tree, key=key),
        sizes.frames)
    img = np.asarray(img)
    check(np.isfinite(img).all(), "path image has non-finite pixels")
    check(float(img.sum()) > 0.0, "path image is all zero")
    log(f"  path compile+first s: {first!r}")
    log(f"  path frame ms: {ms!r}")
    log(f"  path mean radiance: {float(img.mean())!r}")

    out = {"frame_ms": ms, "first_s": first}
    o, d, tm = incoherent_rays(scene, sizes.samples, seed + 3)
    ref = oracle(scene, o, d, sizes.oracle_chunk)
    out["grid_nearest"] = compare_nearest(
        "soup traverse_grid vs oracle", grid_nearest(tree.grid, o, d), ref)
    out["grid_any_hit"] = compare_occlusion(
        "soup traverse_grid any-hit t_max vs oracle",
        grid_any_hit(tree.grid, o, d, tm), ref, tm)
    out["kd_any_hit"] = compare_occlusion(
        "soup traverse_fast any-hit t_max vs oracle",
        kd_any_hit(tree, o, d, tm), ref, tm)

    terrain, ttree, ttv = terrain
    t0 = time.perf_counter()
    shadow = attach_shadow_tree(ttree, ttv).shadow
    log(f"  terrain shadow-tree build: {time.perf_counter() - t0!r} s "
        f"{json.dumps(shadow.stats())}")
    o, d, tm = incoherent_rays(terrain, sizes.samples, seed + 4)
    ref = oracle(terrain, o, d, sizes.oracle_chunk)
    out["shadow_nearest"] = compare_nearest(
        "terrain shadow-tree traverse_fast vs oracle",
        kd_nearest(shadow, o, d), ref)
    out["shadow_any_hit"] = compare_occlusion(
        "terrain shadow-tree any-hit t_max vs oracle",
        kd_any_hit(shadow, o, d, tm), ref, tm)
    for k in ("grid_any_hit", "kd_any_hit", "shadow_any_hit"):
        check(0 < out[k]["occluded"] < out[k]["rays"],
              f"{k}: the rays are all occluded or all free")
    return out


def _train_setup(sizes: Sizes, seed: int, mode: str):
    scene, cam = soup_scene(sizes.train_tris, seed + 2, tri_size=0.03)
    tree, tv = build_tree(scene, "train soup")
    tree = attach_grid(tree, tv)
    opts = RenderOptions(width=sizes.train_res, height=sizes.train_res,
                         mode=mode, bounces=2, background=1.0,
                         differentiable=True)
    target = render_image(scene, cam, opts, tree=tree,
                          key=jax.random.PRNGKey(seed))
    noise = jax.random.normal(jax.random.PRNGKey(seed + 5),
                              scene.albedo.shape)
    start = scene.replace(
        albedo=jnp.clip(scene.albedo + 0.2 * noise, 0.05, 0.95))
    return start, cam, tree, tv, opts, target


def phase_train(sizes: Sizes, seed: int) -> dict:
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clpathtracer_tpu.diff.fd import fd_grad
    from clpathtracer_tpu.parallel import default_mesh, make_train_step

    log("phase train: make_train_step, path mode, verts + albedo")
    scene, cam, tree, _, opts, target = _train_setup(sizes, seed, "path")
    mesh = default_mesh(devices=jax.devices()[:1])
    step, init = make_train_step(scene, opts, mesh, optax.adam(1e-2),
                                 tree=tree, param_fields=("verts", "albedo"))
    state = init()
    target_s = jax.device_put(target, NamedSharding(mesh,
                                                    P("rows", None, None)))
    losses, times = [], []
    for i in range(1 + sizes.frames):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 6), i)
        t0 = time.perf_counter()
        state, loss = step(state, cam, target_s, key)
        loss = float(jax.block_until_ready(loss))
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    check(np.isfinite(losses).all(), f"train losses {losses}")
    for name, p in state.params.items():
        check(np.isfinite(np.asarray(p)).all(),
              f"param {name} non-finite after the steps")
    ms = float(np.mean(times[1:])) * 1e3
    log(f"  train losses: {losses!r}")
    log(f"  train compile+first s: {times[0]!r}")
    log(f"  train step ms: {ms!r}")

    key = jax.random.PRNGKey(seed + 7)

    def loss_of(albedo):
        img = render_image(scene.replace(albedo=albedo), cam, opts,
                           tree=tree, key=key)
        return jnp.mean((img - target) ** 2)

    g = np.asarray(jax.jit(jax.grad(loss_of))(scene.albedo))
    check(np.isfinite(g).all(), "albedo gradient non-finite")
    flat = np.argsort(np.abs(g).ravel())[-3:]
    rows, cols = np.unravel_index(flat, g.shape)
    loss_j = jax.jit(loss_of)

    def loss_at(vals):
        alb = scene.albedo.at[rows, cols].set(jnp.asarray(vals, jnp.float32))
        return loss_j(alb)

    fd = fd_grad(loss_at, np.asarray(scene.albedo)[rows, cols], eps=1e-2)
    ad = g[rows, cols]
    log(f"  albedo grad at {list(zip(rows.tolist(), cols.tolist()))}: "
        f"autodiff {ad.tolist()!r} fd {np.asarray(fd).tolist()!r}")
    ok = np.abs(ad - fd) <= FD_RTOL * np.abs(fd) + 1e-3 * np.abs(g).max()
    check(ok.all(), f"albedo grad vs FD beyond {FD_RTOL}: {ad} vs {fd}")
    return {"step_ms": ms, "first_s": times[0], "losses": losses,
            "fd": np.asarray(fd).tolist(), "grad": ad.tolist()}


def phase_memory(devices) -> dict:
    peaks = {}
    for d in devices:
        stats = d.memory_stats() or {}
        peaks[str(d)] = stats.get("peak_bytes_in_use")
    log(f"phase memory: peak_bytes_in_use {json.dumps(peaks)}")
    return peaks


# ---------------------------------------------------------------------------
# phase 6: several cards
# ---------------------------------------------------------------------------


def compare_images(name: str, img, ref, scene, cam, sizes: Sizes) -> dict:
    """A normal-mode image against the single-device one. A pixel may
    differ by float32 rounding (the programs fuse differently, so FMA
    contraction differs) or, beyond that, only where its ray passes
    within rounding of a triangle border, so that a last-bit change of
    the ray or a tie order picks the neighbour: the oracle's hit must lie
    within 1e-3 of an edge in barycentric units (a last-bit change of a
    ray moves its hit ~1e-6 along a ~1e-2 triangle)."""
    diff = np.abs(img - ref).max(-1).ravel()
    bad = np.flatnonzero(diff > 1e-4)
    out = {"pixels": int(diff.size), "bit_identical": int((diff == 0).sum()),
           "rounding": int(((diff > 0) & (diff <= 1e-4)).sum()),
           "max_rounding": float(diff[diff <= 1e-4].max()),
           "border_ties": int(bad.size)}
    if bad.size:
        o, d = generate_rays(cam_matrix(cam, sizes.res), sizes.res,
                             sizes.res)
        c = sizes.oracle_chunk
        pad = np.resize(bad, -(-bad.size // c) * c)
        rec = oracle(scene, o[pad], d[pad], c)
        edge = _edge_dist(np.asarray(rec["u"]),
                          np.asarray(rec["v"]))[:bad.size]
        out["max_edge_distance"] = float(edge.max())
        out["oracle_all_hit"] = bool(np.asarray(rec["hit"]).all())
    log(f"  {name} vs single-device image: {json.dumps(out)}")
    check(out.get("oracle_all_hit", True)
          and out.get("max_edge_distance", 0.0) < 1e-3,
          f"{name}: pixels differ off triangle borders")
    return out


def phase_cards(sizes: Sizes, seed: int, n: int) -> dict:
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clpathtracer_tpu.parallel import (
        default_mesh, make_sharded_renderer, make_train_step, replicated)
    from jax import shard_map

    from clpathtracer_tpu.parallel.treelet import (
        build_sharded_tree, intersect_ring, make_treelet_renderer)

    devs = jax.devices()
    check(len(devs) >= n, f"--cards {n}: only {len(devs)} devices")
    devs = devs[:n]
    log(f"phase cards: {n} devices")
    scene, cam = terrain_scene(sizes, seed)
    tree, tv = build_tree(scene, "terrain")
    opts = RenderOptions(width=sizes.res, height=sizes.res, mode="normal")
    first1, ms1, ref = timed(
        lambda: render_image(scene, cam, opts, tree=tree), sizes.frames)
    ref = np.asarray(ref)
    log(f"  single-device primary frame ms: {ms1!r}")

    mesh = default_mesh(devices=devs)
    repl = replicated(mesh)
    rend = make_sharded_renderer(opts, mesh)
    args = [jax.device_put(x, repl) for x in
            (scene, cam, tree, jax.random.PRNGKey(0))]
    first_n, ms_n, img = timed(lambda: rend(*args), sizes.frames)
    shard_devs = [s.device for s in img.addressable_shards]
    check(len(set(shard_devs)) == n and set(shard_devs) == set(devs),
          f"sharded image lives on {shard_devs}")
    log(f"  row-sharded primary frame ms: {ms_n!r} on "
        f"{[str(d) for d in shard_devs]}")
    rows = compare_images("row-sharded", np.asarray(img), ref, scene, cam,
                          sizes)

    smesh = default_mesh(devices=devs, scene_parallel=n)
    stree = jax.device_put(build_sharded_tree(tv, n_shards=n),
                           NamedSharding(smesh, P("scene")))
    check(len({s.device for s in stree.quads.addressable_shards}) == n,
          "treelet blocks not spread over the cards")
    # the ring's hit records against the replicated walk's, same rays
    o, d = generate_rays(cam_matrix(cam, sizes.res), sizes.res, sizes.res)
    spec = P(("rows", "scene"), None)
    ring = jax.jit(shard_map(
        lambda st, o, d: intersect_ring(st, o, d, axis_name="scene"),
        mesh=smesh, in_specs=(P("scene"), spec, spec),
        out_specs=P(("rows", "scene"))))(stree, o, d)
    rep_ = kd_nearest(tree, o, d)
    same = {k: int((np.asarray(ring[k]) != np.asarray(rep_[k])).sum())
            for k in ("hit", "t", "tri")}
    log(f"  treelet ring vs replicated traverse_fast, rays differing in "
        f"{json.dumps(same)} of {o.shape[0]}")
    check(same["hit"] == 0 and same["t"] == 0,
          "treelet ring hits differ from the replicated walk")
    trend = make_treelet_renderer(opts, smesh)
    first_t, ms_t, timg = timed(lambda: trend(stree, scene, cam, None),
                                sizes.frames)
    log(f"  treelet-ring frame ms: {ms_t!r}")
    ring_img = compare_images("treelet ring", np.asarray(timg), ref, scene,
                              cam, sizes)

    start, tcam, _, _, topts, target = _train_setup(sizes, seed, "normal")
    # normal mode sees geometry, not albedo: move the vertices off target.
    # Both trees are built from these start vertices: the ring selects
    # hits from the vertices its blocks were built with, the replicated
    # walk from the live ones, so they agree while the vertices stay put
    # (a small learning rate keeps step 2 close: 0.2 % apart on a 20k
    # soup at 64² on the CPU)
    start = start.replace(verts=start.verts + 0.01 * jax.random.normal(
        jax.random.PRNGKey(seed + 8), start.verts.shape))
    ttree, ttv = build_tree(start, "train soup, start vertices")
    losses = {}
    for label, m, tr in (
            ("single", default_mesh(devices=devs[:1]), ttree),
            ("rows=2,scene=2", default_mesh(devices=devs, scene_parallel=2),
             build_sharded_tree(ttv, n_shards=2))):
        step, init = make_train_step(start, topts, m, optax.adam(1e-4),
                                     tree=tr,
                                     param_fields=("verts", "albedo"))
        state = init()
        tgt = jax.device_put(target, NamedSharding(m, P("rows", None, None)))
        ls = []
        for i in range(2):
            state, loss = step(state, tcam, tgt, jax.random.PRNGKey(i))
            ls.append(float(loss))
        losses[label] = ls
    log(f"  train losses: {json.dumps(losses)}")
    a, b = np.asarray(losses["single"]), np.asarray(losses["rows=2,scene=2"])
    # step 1 sees identical geometry; after the first update the ring's
    # hit selection lags the live vertices by one step (rtol 1e-2)
    check(np.isfinite(b).all() and abs(b[0] - a[0]) <= 1e-3 * abs(a[0])
          and abs(b[1] - a[1]) <= 1e-2 * abs(a[1]),
          f"sharded train losses {b} vs single-device {a}")
    return {"single_ms": ms1, "sharded_ms": ms_n, "treelet_ms": ms_t,
            "row_sharded": rows, "treelet_hits_differ": same,
            "treelet": ring_img, "losses": losses}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cards", type=int, default=1,
                   help="with N > 1, run only the N-card phase")
    args = p.parse_args(argv)

    devices = jax.devices()
    try:
        device = require_gpu(devices)
    except SmokeFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    enable_compile_cache()
    log(f"phase device: {device['kind']} x{device['count']} "
        f"(jax {jax.__version__})")
    for line in card_lines():
        log(f"card: {line}")
    log("precision: float32 throughout; camera matrix products at "
        "lax.Precision.HIGHEST (no TF32)")

    sizes = Sizes()
    t0 = time.perf_counter()
    if args.cards > 1:
        phase_cards(sizes, args.seed, args.cards)
        phase_memory(devices[:args.cards])
    else:
        _, terrain = phase_primary(sizes, args.seed)
        phase_path(sizes, args.seed, terrain)
        phase_train(sizes, args.seed)
        phase_memory(devices[:1])
    log(f"total s: {time.perf_counter() - t0!r}")
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
