"""Command-line app shell.

Replaces the reference's GLUT window + keyboard loop (``CudaTracer.cu:649-786``,
``CudaUtils.h:27-188``) with file-output commands, per SURVEY §7 step 8:

  render     progressive render of a scene preset -> PNG/TGA/NPY
  benchmark  rays/s on the current default device
  grad-check AD-vs-finite-difference report for chosen scene fields
  invert     inverse rendering (recover scene params from a target image)
  interact   terminal-interactive progressive render with WASD/TFGH camera
             keys (the reference's moveCamera bindings) and 0 = screenshot

Runtime-configurable everything the reference hardcoded: resolution, spp,
bounces, scene preset, seed, early-exit cutoff.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _common(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="cornell", help="scene preset name")
    p.add_argument("--obj", default=None, metavar="FILE",
                   help="render a Wavefront OBJ instead of a preset: the "
                        "mesh (with its mtllib materials, if any) is "
                        "auto-centered in the Cornell shell "
                        "(render/interact/view/benchmark)")
    p.add_argument("--obj-scale", type=float, default=1.0,
                   help="size multiplier for --obj (1.0 fits the mesh's "
                        "largest extent to 4 units)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--bounces", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--live-cutoff", type=int, default=128,
                   help="bounce loop early-exit when <= this many rays live; "
                        "-1 disables (differentiable scan path)")
    p.add_argument("--samples-per-pass", type=int, default=None,
                   help="samples accumulated per progressive pass; default "
                        "AUTO — interactive steps stay at 4 spp, while "
                        "'render' grows passes 4 -> 1024 on the fused "
                        "engine to amortize launch overhead")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "jnp", "pallas", "pallas_interpret",
                            "lighttrace", "bidir"],
                   help="jnp = differentiable wavefront (XLA, any "
                        "backend), pallas = fused Pallas-Triton kernel "
                        "(forward rendering on a GPU), pallas_interpret = "
                        "the same kernel on the CPU (slow, for testing), "
                        "auto = pallas on a GPU and jnp elsewhere; gradients "
                        "(grad-check/invert) run on jnp. 'lighttrace' and "
                        "'bidir' are INVERT-only estimator engines "
                        "(make_loss; both need --physical) — for rendering "
                        "use the dedicated lighttrace/bidir subcommands")
    p.add_argument("--accel", default="none", choices=["none", "grid"],
                   help="spatial acceleration: grid = the jnp engine's "
                        "per-ray uniform-grid DDA (ops/grid.py; identical "
                        "image); the fused kernel sweeps linearly")
    p.add_argument("--physical", action="store_true",
                   help="unbiased estimator mode (BOTH engines): "
                        "uniform-area light sampling with the correct "
                        "measure, per-lobe MIS, no emitter double-count — a "
                        "capability beyond the reference; the default "
                        "reproduces the reference's estimator quirks exactly")


def _resolve_engine(args, training=False):
    """Render engines follow render/engine.py; gradients (``training``)
    run on jnp unless an estimator engine is named."""
    if args.engine in ("lighttrace", "bidir"):
        return args.engine
    if training and args.engine == "auto":
        return "jnp"
    from .render.engine import resolve_engine
    return resolve_engine(args.engine, args.accel)


def _cutoff(args):
    return None if args.live_cutoff < 0 else args.live_cutoff


def _obj_scene(args):
    """User OBJ (+ its .mtl library) auto-centered inside the Cornell
    shell — the 'bring your own mesh' path the reference slated
    (README.md:30) but never shipped."""
    import numpy as np

    from .models.presets import add_cornell_box
    from .models.scene import MaterialSpec, SceneBuilder
    from .utils.obj import add_obj_with_mtl, load_obj

    b = SceneBuilder()
    fallback = b.add_material(MaterialSpec(diffuse=(0.7, 0.6, 0.5),
                                           diff_avg=0.75))
    v, _, _ = load_obj(args.obj)
    center = (v.min(0) + v.max(0)) / 2
    extent = float((v.max(0) - v.min(0)).max())
    s = args.obj_scale * 4.0 / max(extent, 1e-9)
    t = np.diag([s, s, s, 1.0]).astype(np.float32)
    t[:3, 3] = np.asarray([0.0, -1.0, -5.5], np.float32) - s * center
    n, mmap = add_obj_with_mtl(b, args.obj, fallback, transform=t)
    add_cornell_box(b, 10.0)
    print(f"loaded {args.obj}: {n} triangles, "
          f"materials: {sorted(mmap) if mmap else '(fallback)'}")
    return b.build()


def _build(args):
    from .models.camera import Camera
    from .models.presets import get_scene
    from .render.renderer import ProgressiveRenderer, RenderConfig

    if args.engine in ("lighttrace", "bidir"):
        raise SystemExit(
            f"--engine {args.engine} is an invert-only estimator engine; "
            "render with the dedicated "
            f"'{args.engine}' subcommand instead")

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, spp=args.spp,
                       seed=args.seed, live_cutoff=_cutoff(args),
                       samples_per_pass=args.samples_per_pass,
                       engine=args.engine, accel=args.accel,
                       physical=getattr(args, "physical", False))
    scene = (_obj_scene(args) if getattr(args, "obj", None)
             else get_scene(args.scene))
    return ProgressiveRenderer(scene, Camera(), cfg)


def cmd_render(args):
    r = _build(args)
    if args.resume:
        r.restore(args.resume)
    if args.checkpoint and args.checkpoint_every > 0:
        # periodic snapshot -> any crash/preemption restarts from the last
        # completed pass (atomic: write aside, then rename)
        every = args.checkpoint_every
        final = (args.checkpoint if args.checkpoint.endswith(".npz")
                 else args.checkpoint + ".npz")
        # np.savez appends .npz to any other suffix, so the tmp name must
        # already carry it for the rename source to exist
        tmp = final[:-len(".npz")] + ".tmp.npz"

        def snap(metrics, _n=[0]):
            _n[0] += 1
            if _n[0] % every == 0:
                r.checkpoint(tmp)
                os.replace(tmp, final)

        r.on_pass = snap
    r.run()
    r.save(args.out)
    if args.checkpoint:
        # atomic like the periodic snapshots: a kill mid-write must never
        # leave a corrupt resume file (np.savez appends .npz to other
        # suffixes, so the tmp name must already carry it)
        final = (args.checkpoint if args.checkpoint.endswith(".npz")
                 else args.checkpoint + ".npz")
        tmp = final[:-len(".npz")] + ".tmp.npz"
        r.checkpoint(tmp)
        os.replace(tmp, final)
    print(f"wrote {args.out}")


def cmd_interact(args):
    r = _build(args)
    print("keys: w/a/s/d/q/e move, t/f/g/h rotate, p toggle ray-trace mode, "
          "0 screenshot, x quit; empty line = render more passes")
    while True:
        m = r.step()
        print(f"spp={m['samples_per_pixel']} "
              f"{m['primary_rays_per_s'] / 1e6:.2f} M rays/s", end=" > ",
              flush=True)
        line = sys.stdin.readline()
        if not line:
            break
        for ch in line.strip():
            if ch == "x":
                r.save(args.out)
                print(f"wrote {args.out}")
                return
            if ch == "0":
                path = time.strftime("render%Y-%m-%d-%H%M%S.png")
                r.save(path)
                print(f"wrote {path}")
            elif ch == "p":
                mode = r.toggle_ray_trace_mode()
                print("ray-trace mode" if mode else "path-trace mode")
            elif r.move_camera(ch):
                print(f"camera moved ({ch}); accumulation reset")


def cmd_view(args):
    from .viewer import serve

    serve(_build(args), port=args.port)


def cmd_benchmark(args):
    import jax
    import jax.numpy as jnp

    from .models.camera import Camera
    from .models.presets import get_scene
    from .render.integrator import camera_arrays, render

    scene = get_scene(args.scene)
    cp = camera_arrays(Camera())
    engine = _resolve_engine(args)
    grid = None
    if args.accel == "grid":
        from .ops.grid import build_grid
        grid = build_grid(scene)
    if engine in ("pallas", "pallas_interpret"):
        from .ops.pallas.megakernel import pack_scene, render_megakernel

        # pack once (as the renderer does): per-repeat packing would be
        # counted in the timing
        packed = jax.block_until_ready(pack_scene(scene))

        def run(k):
            # distinct sample window per repeat: timing reflects fresh work
            return render_megakernel(packed, cp, args.seed, args.width,
                                     args.height, args.spp, args.bounces,
                                     sample_offset=k[0] * args.spp,
                                     interpret=engine == "pallas_interpret")
    else:
        def run(k):
            return render(scene, cp, args.width, args.height, args.spp,
                          jnp.int32(args.seed),
                          max_bounces=args.bounces, live_cutoff=_cutoff(args),
                          sample_offset=k[0] * args.spp, grid=grid)

    t0 = time.perf_counter()
    jax.block_until_ready(run(jnp.asarray([0])))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(args.repeats):
        img = run(jnp.asarray([i + 1]))
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * args.spp * args.repeats
    out = {
        "scene": args.scene, "width": args.width, "height": args.height,
        "spp": args.spp, "bounces": args.bounces,
        "compile_s": round(compile_s, 2),
        "wall_s": round(dt, 4),
        "primary_rays_per_s": round(rays / dt, 1),
        "engine": engine,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    if args.stats:
        from .render.integrator import live_ray_stats
        fracs = live_ray_stats(scene, cp, args.width, args.height,
                               jnp.int32(args.seed),
                               max_bounces=args.bounces)
        out["live_ray_fraction_per_bounce"] = [round(float(f), 4)
                                               for f in fracs]
    print(json.dumps(out))


def cmd_grad_check(args):
    import jax

    from .models.camera import Camera
    from .models.presets import get_scene
    from .render import inverse
    from .render.integrator import camera_arrays

    import jax.numpy as jnp

    scene = get_scene(args.scene)
    cp = camera_arrays(Camera())
    engine = _resolve_engine(args, training=True)
    fields = args.fields.split(",")
    inverse.check_engine_fields(engine, fields)
    target = jnp.zeros((args.height, args.width, 3), jnp.float32)
    loss = inverse.make_loss(scene, cp, target, args.width, args.height,
                             args.spp, max_bounces=args.bounces,
                             engine=engine, accel=args.accel,
                             field_names=fields, physical=args.physical)
    params = inverse.extract_params(scene, fields)
    ad, fd = inverse.directional_fd_check(loss, params, args.seed,
                                          eps=args.eps,
                                          num_directions=args.directions)
    rel = abs(ad - fd) / (abs(fd) + 1e-12)
    print(json.dumps({
        "fields": fields,
        "engine": engine,
        "ad": ad.tolist(), "fd": fd.tolist(),
        "max_rel_err": float(rel.max()),
        "allclose": bool((rel < args.tol).all()),
    }))


def cmd_lighttrace(args):
    import numpy as np

    from .models.camera import Camera
    from .models.presets import get_scene
    from .render.integrator import camera_arrays
    from .render.lighttrace import render_lighttrace
    from .utils.image import write_png

    scene = _obj_scene(args) if args.obj else get_scene(args.scene)
    cp = camera_arrays(Camera())
    acc = np.zeros((args.height, args.width, 3), np.float64)
    t0 = time.time()
    for k in range(args.batches):
        img = render_lighttrace(scene, cp, args.width, args.height,
                                args.paths, args.seed,
                                max_bounces=args.bounces, sample_idx=k)
        acc += np.asarray(img)
        print(f"batch {k + 1}/{args.batches}  "
              f"({(k + 1) * args.paths / (time.time() - t0) / 1e6:.2f} M "
              f"paths/s)")
    arr = np.clip(acc / args.batches, 0, 1) ** (1 / 2.2)
    write_png(args.out, arr.astype(np.float32))
    print(f"wrote {args.out}")


def cmd_bidir(args):
    import numpy as np

    from .models.camera import Camera
    from .models.presets import get_scene
    from .render.bidir import render_bidir
    from .render.integrator import camera_arrays
    from .utils.image import write_png

    scene = _obj_scene(args) if args.obj else get_scene(args.scene)
    cp = camera_arrays(Camera())
    acc = np.zeros((args.height, args.width, 3), np.float64)
    t0 = time.time()
    for k in range(args.batches):
        img = render_bidir(scene, cp, args.width, args.height,
                           args.spp, args.paths, args.seed,
                           max_bounces=args.bounces,
                           sample_offset=k * args.spp,
                           light_sample_idx=k)
        acc += np.asarray(img)
        done = (k + 1) * (args.spp * args.width * args.height + args.paths)
        print(f"batch {k + 1}/{args.batches}  "
              f"({done / (time.time() - t0) / 1e6:.2f} M path starts/s, "
              "eye samples + light paths)")
    arr = np.clip(acc / args.batches, 0, 1) ** (1 / 2.2)
    write_png(args.out, arr.astype(np.float32))
    print(f"wrote {args.out}")


def cmd_invert(args):
    import numpy as np

    from .models.camera import Camera
    from .models.presets import get_scene
    from .render import inverse
    from .render.integrator import camera_arrays
    from .utils.image import write_png

    from .render.integrator import render

    scene_true = get_scene(args.scene)
    cp = camera_arrays(Camera())
    engine = _resolve_engine(args, training=True)
    fields = args.fields.split(",")
    inverse.check_engine_fields(engine, fields)
    target = render(scene_true, cp, args.width, args.height, args.spp,
                    args.seed, max_bounces=args.bounces, live_cutoff=None,
                    physical=args.physical)

    # perturb the truth, then recover it
    params0 = inverse.extract_params(scene_true, fields)
    perturbed = {k: v + args.perturb for k, v in params0.items()}
    scene0 = inverse.merge_params(scene_true, perturbed)

    def cb(step, val, params):
        if step % 20 == 0:
            print(f"step {step:4d}  loss {val:.3e}")

    recovered, params, losses = inverse.invert(
        scene0, cp, target, fields, args.width, args.height, spp=args.spp,
        steps=args.steps, lr=args.lr, seed=args.seed,
        max_bounces=args.bounces, callback=cb, engine=engine,
        accel=args.accel, physical=args.physical,
        silhouette=args.silhouette)
    err = {k: float(np.abs(np.asarray(params[k]) - np.asarray(params0[k])).max())
           for k in params}
    print(json.dumps({"final_loss": losses[-1], "max_abs_err": err}))
    if args.out:
        img = render(recovered, cp, args.width, args.height, args.spp,
                     args.seed, max_bounces=args.bounces, live_cutoff=None,
                     physical=args.physical)
        write_png(args.out, np.clip(np.asarray(img), 0, 1) ** (1 / 2.2))
        print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cuda_path_tracer_ss",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a preset to an image file")
    _common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also snapshot the accumulator every N passes "
                        "(atomic rename) so a killed render resumes from "
                        "the last completed pass via --resume")
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("interact", help="progressive render with camera keys")
    _common(p)
    p.add_argument("--out", default="render.png")
    p.set_defaults(fn=cmd_interact)

    p = sub.add_parser("view", help="live browser viewer (GL-window analog)")
    _common(p)
    p.add_argument("--port", type=int, default=8642)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("benchmark", help="measure rays/s")
    _common(p)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--stats", action="store_true",
                   help="also report live-ray fraction per bounce")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("grad-check", help="AD vs finite differences")
    _common(p)
    p.add_argument("--fields", default="materials.diffuse,al_power")
    p.add_argument("--eps", type=float, default=2e-3)
    p.add_argument("--directions", type=int, default=3)
    p.add_argument("--tol", type=float, default=0.05)
    p.set_defaults(fn=cmd_grad_check)

    p = sub.add_parser("lighttrace",
                       help="adjoint render: light paths splatted through "
                            "the camera (render/lighttrace.py)")
    _common(p)
    p.add_argument("--paths", type=int, default=200_000,
                   help="light paths per batch")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--out", default="lighttrace.png")
    p.set_defaults(fn=cmd_lighttrace)

    p = sub.add_parser("bidir",
                       help="bidirectional render: MIS-weighted forward + "
                            "light-traced estimators (render/bidir.py) — "
                            "caustics AND camera-visible specular in one "
                            "image")
    _common(p)
    p.add_argument("--paths", type=int, default=200_000,
                   help="light paths per batch (eye samples come from "
                        "--spp)")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--out", default="bidir.png")
    p.set_defaults(fn=cmd_bidir)

    p = sub.add_parser("invert", help="inverse rendering demo")
    _common(p)
    p.add_argument("--fields", default="materials.diffuse")
    p.add_argument("--perturb", type=float, default=0.3)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out", default=None)
    p.add_argument("--silhouette", action="store_true",
                   help="add the edge-sampled visibility-boundary term to "
                        "geometry gradients (render/silhouette.py)")
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    # Persist compiled executables across runs; opt out with
    # CPT_NO_COMPILE_CACHE=1 (utils/compile_cache.py).
    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
