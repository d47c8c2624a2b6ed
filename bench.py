"""Frame times of the renderer on the default device; prints one JSON line.

    python bench.py [--legs terrain,soup,path] [--wave-chunks 0,65536]
                    [--reps 5] [--seed 0]

Legs, each built from --seed at 512² (BENCH_W / BENCH_H override):

  terrain     1M-triangle heightfield (a surface mesh), normal mode
  soup        1M-triangle emissive fog, normal mode
  path        the soup with its uniform grid, path mode, 2 bounces + NEE
  terrain10m  10M-triangle heightfield, normal mode (not in the default)

Set-up (scene generation, kd build, grid build, compile and first frame)
is reported apart from the frame time, which is the host-clock mean of
--reps frames after the first, each ending in block_until_ready.

--wave-chunks repeats the legs in this one process for each listed value
of CLPT_WALK_CHUNK and CLPT_GRID_CHUNK (the lanes per chunk of a big
traversal wave, ops/traverse_fast.py::chunk_wave; 0 = unchunked), with
the jit caches cleared in between, so the values compare on one card.

The output names the device (platform, device_kind, count) and the
card's name and power limit from nvidia-smi. This file keeps the legs
runnable; it defines no benchmark cells and no targets.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

LEGS = ("terrain", "soup", "path", "terrain10m")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_leg(kind, seed, width, height):
    """(scene, camera, tree, opts, set-up seconds) for one leg."""
    from chip_smoke import Sizes, build_tree, soup_scene, terrain_scene

    from clpathtracer_tpu.accel.sah import attach_grid
    from clpathtracer_tpu.render.integrator import RenderOptions

    t0 = time.perf_counter()
    if kind in ("terrain", "terrain10m"):
        n = 10_000_000 if kind == "terrain10m" else 1_000_000
        scene, cam = terrain_scene(Sizes(tris=n), seed)
    else:
        scene, cam = soup_scene(1_000_000, seed + 1, tri_size=0.01)
    tree, tv = build_tree(scene, kind)
    if kind == "path":
        tree = attach_grid(tree, tv)
        opts = RenderOptions(width=width, height=height, mode="path",
                             bounces=2, nee=True, background=0.0)
    else:
        opts = RenderOptions(width=width, height=height, mode="normal")
    return scene, cam, tree, opts, time.perf_counter() - t0


def run_leg(leg, reps, seed):
    import jax

    from chip_smoke import timed

    from clpathtracer_tpu.render.integrator import render_image

    scene, cam, tree, opts, _ = leg
    key = jax.random.PRNGKey(seed)
    first, ms, img = timed(
        lambda: render_image(scene, cam, opts, tree=tree, key=key), reps)
    img = np.asarray(img)
    if not np.isfinite(img).all():
        raise RuntimeError("non-finite pixels")
    rays = opts.width * opts.height
    return {"frame_ms": ms, "compile_and_first_s": first,
            "rays_per_s": rays / (ms * 1e-3), "checksum": float(img.sum())}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--legs", default="terrain,soup,path")
    p.add_argument("--wave-chunks", default=None,
                   help="comma-separated CLPT_WALK_CHUNK/CLPT_GRID_CHUNK "
                        "values to compare in this process")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    legs = args.legs.split(",")
    unknown = set(legs) - set(LEGS)
    if unknown:
        raise SystemExit(f"unknown legs {sorted(unknown)}; known {LEGS}")

    import jax

    from chip_smoke import card_lines, require_gpu

    from clpathtracer_tpu.utils.device import enable_compile_cache

    device = require_gpu(jax.devices())
    enable_compile_cache()
    device["cards"] = card_lines()
    log(f"# device: {device}")
    width = int(os.environ.get("BENCH_W", 512))
    height = int(os.environ.get("BENCH_H", 512))

    built = {}
    for kind in legs:
        built[kind] = build_leg(kind, args.seed, width, height)
        log(f"# {kind} set-up: {built[kind][-1]!r} s")

    chunks = (args.wave_chunks.split(",") if args.wave_chunks
              else [None])
    detail = {}
    for chunk in chunks:
        if chunk is not None:
            os.environ["CLPT_WALK_CHUNK"] = chunk
            os.environ["CLPT_GRID_CHUNK"] = chunk
            jax.clear_caches()  # the chunk is read at trace time
        for kind in legs:
            res = run_leg(built[kind], args.reps, args.seed)
            res["setup_s"] = built[kind][-1]
            name = kind if chunk is None else f"{kind}@chunk={chunk}"
            # repeated values keep every run: name#2, name#3, ...
            k, i = name, 1
            while k in detail:
                i += 1
                k = f"{name}#{i}"
            detail[k] = res
            log(f"# {k}: {json.dumps(res)}")

    head = next(iter(detail.values()))
    print(json.dumps({
        "metric": f"{next(iter(detail))}: camera rays/s at "
                  f"{width}x{height}",
        "value": head["rays_per_s"], "unit": "rays/s",
        "device": device, "detail": detail}), flush=True)


if __name__ == "__main__":
    main()
