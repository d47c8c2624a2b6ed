"""Command-line entry: render / orbit / fly / info.

The reference's CLI is `./CLPathTracer model.obj ...` which opens an
interactive GLFW window (src/main.c:9-20). This framework renders
offline on an accelerator: the same capabilities map to subcommands —

  render  one frame → PNG                (the frame loop body, once)
  orbit   camera orbit → frame sequence  (animation without input devices)
  fly     scripted fly-through using the physics stepper + fly-camera
          (the game loop, src/game.c:219-244, driven by a JSON script
          instead of GLFW callbacks)
  info    scene + kd-tree quality stats  (the reference's printfs,
          src/kd_tree.c:232-235, as structured output)

All configuration is flags on a single dataclass-backed parser — no
interactive stdin prompts (the reference's device picker,
src/CLHandler.c:43-53, deliberately not reproduced).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clpathtracer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp, camera=True):
        sp.add_argument("models", nargs="+",
                        help=".obj or .kd.npz model paths")
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--mode", choices=("normal", "mirror", "path"),
                        default="normal")
        sp.add_argument("--bounces", type=int, default=2)
        sp.add_argument("--spp", type=int, default=1)
        sp.add_argument("--background", type=float, default=1.0)
        sp.add_argument("--nee", action="store_true",
                        help="path mode: next-event estimation (direct"
                             " light sampling)")
        sp.add_argument("--no-tree", action="store_true",
                        help="brute-force linear-scan intersector")
        sp.add_argument("--tri-block", type=int, default=4)
        sp.add_argument("--max-depth", type=int, default=24)
        sp.add_argument("--leaf-size", type=int, default=4)
        sp.add_argument("--no-cache", action="store_true",
                        help="skip the .kd.npz acceleration cache")
        sp.add_argument("--sphere", type=float, nargs=4, action="append",
                        default=[], metavar=("X", "Y", "Z", "R"),
                        help="add an analytic sphere primitive (repeatable;"
                             " the reference's sphere pipeline was dead"
                             " code — here it renders)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--sharded", action="store_true",
                        help="shard pixel rows over all local devices")
        sp.add_argument("--cpu", action="store_true",
                        help="pin to CPU backend")
        sp.add_argument("--exposure", type=float, default=1.0)
        sp.add_argument("--gamma", type=float, default=None,
                        help="default: 2.2 for path mode, 1.0 otherwise")
        if camera:
            sp.add_argument("--position", type=float, nargs=3,
                            default=[0.0, 0.1, -0.2],
                            help="eye position (reference default, "
                                 "src/game.c:275-277)")
            sp.add_argument("--forward", type=float, nargs=3,
                            default=[0.0, 0.0, 1.0])
            sp.add_argument("--fov", type=float, default=60.0,
                            help="vertical FOV in degrees")
        return sp

    r = add_common(sub.add_parser("render", help="render one frame"))
    r.add_argument("--out", default="out.png")

    o = add_common(sub.add_parser("orbit", help="orbit animation"))
    o.add_argument("--out-dir", default="frames")
    o.add_argument("--frames", type=int, default=24)
    o.add_argument("--radius", type=float, default=None,
                   help="orbit radius (default: 1.5x scene extent)")
    o.add_argument("--elevation", type=float, default=15.0,
                   help="camera elevation in degrees")

    f = add_common(sub.add_parser(
        "fly", help="scripted fly-through (physics-stepped camera)"),
        camera=True)
    f.add_argument("--script", required=True,
                   help="JSON: [{duration, move:[r,u,f], look:[dx,dy], "
                        "sprint, walk, zoom}, ...]")
    f.add_argument("--fps", type=float, default=12.0)
    f.add_argument("--out-dir", default="frames")

    v = add_common(sub.add_parser(
        "view", help="interactive viewer (matplotlib window, WASD+arrows)"))
    v.add_argument("--fps-cap", type=float, default=30.0)

    i = sub.add_parser("info", help="scene + tree stats")
    i.add_argument("models", nargs="+")
    i.add_argument("--tri-block", type=int, default=4)
    i.add_argument("--max-depth", type=int, default=24)
    i.add_argument("--leaf-size", type=int, default=4)
    i.add_argument("--no-cache", action="store_true")
    i.add_argument("--json", action="store_true", dest="as_json")
    return p


def _load(args):
    from clpathtracer_tpu.scene.cache import load_models
    t0 = time.time()
    scene, tree, skipped = load_models(
        args.models, tri_block=args.tri_block,
        max_depth=args.max_depth, leaf_size=args.leaf_size,
        use_cache=not args.no_cache)
    spheres = getattr(args, "sphere", [])
    if spheres:
        import jax.numpy as jnp
        sp = np.asarray(spheres, np.float32)
        scene = scene.replace(
            sphere_pos=jnp.asarray(sp[:, :3]),
            sphere_radius=jnp.asarray(sp[:, 3]),
            sphere_albedo=jnp.full((len(sp), 3), 0.75, jnp.float32),
            sphere_emission=jnp.zeros((len(sp), 3), jnp.float32))
    if (getattr(args, "mode", None) == "path" and tree is not None
            and scene.num_tris > 0):
        # per-ray path-mode waves (bounce nearest-hit, NEE shadow
        # occlusion) want a second accelerator: a uniform grid when the
        # scene is fog-like, a small-leaf kd tree for surface meshes.
        # Auto-picked by centroid occupancy (accel/grid.py::fog_likeness).
        from clpathtracer_tpu.accel.grid import fog_likeness
        from clpathtracer_tpu.accel.sah import attach_grid, \
            attach_shadow_tree
        v0, v1, v2 = scene.tri_verts()
        tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
        if fog_likeness(tv) > 0.5:
            tree = attach_grid(tree, tv)
        else:
            tree = attach_shadow_tree(tree, tv)
    # the reference prints parse/build wall time (src/model.c:136-143)
    print(f"# loaded {scene.num_tris} tris, {scene.num_spheres} spheres "
          f"in {time.time()-t0:.2f}s ({len(skipped)} skipped)",
          file=sys.stderr)
    return scene, tree


def _opts(args, differentiable=False):
    from clpathtracer_tpu.render.integrator import RenderOptions
    return RenderOptions(
        width=args.width, height=args.height, mode=args.mode,
        bounces=args.bounces, spp=args.spp, use_tree=not args.no_tree,
        tri_block=args.tri_block, background=args.background,
        nee=getattr(args, "nee", False),
        differentiable=differentiable)


def _render(scene, tree, camera, args, key=None):
    import jax
    from clpathtracer_tpu.render.integrator import render_image
    opts = _opts(args)
    if key is None:
        key = jax.random.PRNGKey(args.seed)
    if args.sharded:
        from clpathtracer_tpu.parallel import default_mesh, \
            make_sharded_renderer, replicated
        mesh = default_mesh()
        n_rows = mesh.shape["rows"]
        if opts.height % n_rows:
            raise SystemExit(
                f"--height must be divisible by {n_rows} with --sharded")
        repl = replicated(mesh)
        rend = make_sharded_renderer(opts, mesh)
        img = rend(jax.device_put(scene, repl),
                   jax.device_put(camera, repl),
                   jax.device_put(tree, repl) if tree is not None else None,
                   jax.device_put(key, repl))
    else:
        img = render_image(scene, camera, opts, tree=tree, key=key)
    return np.asarray(img)


def _postprocess(img, args):
    from clpathtracer_tpu.utils.png import tonemap
    gamma = args.gamma
    if gamma is None:
        gamma = 2.2 if args.mode == "path" else 1.0
    return tonemap(img, exposure=args.exposure, gamma=gamma)


def _camera_from_args(args):
    from clpathtracer_tpu.core.camera import Camera
    return Camera.create(position=args.position, forward=args.forward,
                         fov=float(np.deg2rad(args.fov)))


def cmd_render(args):
    from clpathtracer_tpu.utils.png import write_png
    scene, tree = _load(args)
    cam = _camera_from_args(args)
    t0 = time.time()
    img = _render(scene, tree, cam, args)
    dt = time.time() - t0
    rays = args.width * args.height
    print(f"# rendered {args.width}x{args.height} in {dt:.2f}s "
          f"({rays/dt:.3g} primary rays/s incl. compile)", file=sys.stderr)
    write_png(args.out, _postprocess(img, args))
    print(args.out)


def cmd_orbit(args):
    import jax
    from clpathtracer_tpu.core.camera import Camera
    from clpathtracer_tpu.utils.png import write_png
    scene, tree = _load(args)
    lo, hi = (np.asarray(x) for x in scene.bounds())
    center = (lo + hi) / 2
    radius = args.radius or 1.5 * float(np.max(hi - lo))
    elev = np.deg2rad(args.elevation)
    os.makedirs(args.out_dir, exist_ok=True)
    key = jax.random.PRNGKey(args.seed)
    for i in range(args.frames):
        theta = 2 * np.pi * i / args.frames
        pos = center + radius * np.array([
            np.sin(theta) * np.cos(elev), np.sin(elev),
            -np.cos(theta) * np.cos(elev)])
        fwd = center - pos
        cam = Camera.create(position=pos, forward=fwd,
                            fov=float(np.deg2rad(args.fov)))
        key, sub = jax.random.split(key)
        img = _render(scene, tree, cam, args, key=sub)
        out = os.path.join(args.out_dir, f"frame_{i:04d}.png")
        write_png(out, _postprocess(img, args))
        print(out)


def cmd_fly(args):
    import jax
    from clpathtracer_tpu.core.physics import FlyCamera
    from clpathtracer_tpu.utils.png import write_png
    scene, tree = _load(args)
    with open(args.script) as f:
        script = json.load(f)
    fc = FlyCamera(position=np.asarray(args.position, np.float64),
                   fov=float(np.deg2rad(args.fov)))
    os.makedirs(args.out_dir, exist_ok=True)
    dt = 1.0 / args.fps
    key = jax.random.PRNGKey(args.seed)
    frame = 0
    for seg in script:
        fc.move = np.asarray(seg.get("move", [0, 0, 0]), np.float64)
        fc.sprint = bool(seg.get("sprint", False))
        fc.walk = bool(seg.get("walk", False))
        look = seg.get("look", [0.0, 0.0])
        zoom = float(seg.get("zoom", 0.0))
        n = max(1, int(round(float(seg["duration"]) * args.fps)))
        for _ in range(n):
            fc.look(look[0] * dt, look[1] * dt)
            if zoom:
                fc.zoom(zoom * dt)
            fc.step(dt)
            key, sub = jax.random.split(key)
            img = _render(scene, tree, fc.camera(), args, key=sub)
            out = os.path.join(args.out_dir, f"frame_{frame:04d}.png")
            write_png(out, _postprocess(img, args))
            print(out)
            frame += 1


def cmd_view(args):
    from clpathtracer_tpu.cli.viewer import run_viewer
    scene, tree = _load(args)
    run_viewer(scene, tree, _opts(args), position=tuple(args.position),
               fps_cap=args.fps_cap)


def cmd_info(args):
    from clpathtracer_tpu.scene.cache import load_models
    scene, tree, skipped = load_models(
        args.models, tri_block=args.tri_block, max_depth=args.max_depth,
        leaf_size=args.leaf_size, use_cache=not args.no_cache)
    lo, hi = (np.asarray(x).tolist() for x in scene.bounds())
    stats = {
        "num_tris": scene.num_tris,
        "num_verts": int(scene.verts.shape[0]),
        "num_spheres": scene.num_spheres,
        "bounds_lo": lo,
        "bounds_hi": hi,
        "skipped": skipped,
        **{f"tree_{k}": v for k, v in tree.stats().items()},
    }
    if args.as_json:
        print(json.dumps(stats))
    else:
        for k, v in stats.items():
            print(f"{k}: {v}")


def main(argv=None):
    args = _build_parser().parse_args(argv)
    import jax

    from clpathtracer_tpu.utils.device import enable_compile_cache
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    {"render": cmd_render, "orbit": cmd_orbit, "fly": cmd_fly,
     "view": cmd_view, "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    main()
