"""Command-line frame driver - the headless "app orchestrator".

Replaces the reference's GLFW interactive loop (main.cpp:653-731) with a
scriptable driver: load a scene (glTF/OBJ/procedural), fly a parametric
camera path (the analog of WASD/mouse input), render progressively with
move-resets, and write PNG frames + a structured per-frame log
(SURVEY.md par.5 "Metrics": ms/frame, Mrays/s, spp accumulated).

Usage:
  python -m pathtracer.app --scene cornell --frames 16 --out out.png
  python -m pathtracer.app --scene path/to/scene.gltf --width 1280 \
      --height 720 --spp 4 --frames 60 --orbit --out frames/
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import jax
import numpy as np

from pathtracer import film as fm
from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.render import Renderer
from pathtracer.scene import procedural
from pathtracer.utils.compile_cache import enable_compile_cache


_PRESETS = {
    "cornell": lambda: procedural.cornell_box(),
    "cornell-spheres": lambda: procedural.cornell_box(spheres=True),
    "materials": lambda: procedural.cornell_box(materials_suite=True),
    "bunny": lambda: procedural.bunny_like(),
    "sponza": lambda: procedural.sponza_like(),
    "sponza-textured": lambda: procedural.sponza_like(textured=True),
}


def _parse_spec(spec: str):
    """'path[@tx,ty,tz[,scale[,ry_deg]]]' -> (path, 4x4 transform|None).

    The per-object TRS mirrors the reference's scene list
    (main.cpp:150-171: per-SceneObject translate/scale + normal matrix).
    """
    if "@" not in spec:
        return spec, None
    path, params = spec.rsplit("@", 1)
    vals = [float(x) for x in params.split(",")]
    if len(vals) < 3:
        raise SystemExit(f"bad transform in scene spec: {spec!r} "
                         "(want tx,ty,tz[,scale[,ry_deg]])")
    tx, ty, tz = vals[0:3]
    s = vals[3] if len(vals) > 3 else 1.0
    ry = math.radians(vals[4]) if len(vals) > 4 else 0.0
    c, sn = math.cos(ry), math.sin(ry)
    m = np.array([[s * c, 0, s * sn, tx],
                  [0, s, 0, ty],
                  [-s * sn, 0, s * c, tz],
                  [0, 0, 0, 1]], np.float32)
    return path, m


def load_scene(specs):
    """SceneBuilder from specs: ONE procedural preset name, or any number
    of .gltf/.glb/.obj paths (each with an optional '@tx,ty,tz[,scale
    [,ry_deg]]' transform) composed into one scene - the analog of the
    reference's multi-model MODELS_TO_LOAD assembly (main.cpp:30-41,
    150-235)."""
    if isinstance(specs, str):
        specs = [specs]
    if len(specs) == 1 and specs[0] in _PRESETS:
        return _PRESETS[specs[0]]()

    from pathtracer.scene.build import SceneBuilder

    builder = SceneBuilder()
    for spec in specs:
        path, transform = _parse_spec(spec)
        if path in _PRESETS:
            raise SystemExit(
                f"procedural preset {path!r} cannot be composed with other "
                "models; compose .gltf/.glb/.obj files")
        ext = os.path.splitext(path)[1].lower()
        if ext in (".gltf", ".glb"):
            from pathtracer.scene.gltf import load_gltf

            load_gltf(path, builder=builder, transform=transform)
        elif ext == ".obj":
            from pathtracer.scene.objload import load_obj

            load_obj(path, builder=builder, transform=transform)
        else:
            raise SystemExit(f"unknown scene: {spec}")
    return builder


def load_envmap(path: str) -> np.ndarray:
    """Environment radiance from a .hdr (Radiance RGBE) or LDR image."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        from pathtracer.scene.hdr import read_hdr

        return read_hdr(path)
    with open(path, "rb") as f:
        raw = f.read()
    from pathtracer.utils import native, png

    arr = native.png_decode(raw)
    if arr is None:
        arr = png.decode(raw)
    if arr.shape[2] < 3:                      # gray (+ alpha) -> RGB
        arr = np.repeat(arr[..., :1], 3, axis=2)
    return (arr[..., :3].astype(np.float32) / 255.0) ** 2.2


def default_camera(spec: str) -> Camera:
    presets = {
        "cornell": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
        "cornell-spheres": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
        "materials": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
        "bunny": ((0.0, 2.0, 5.0), (0.0, 1.0, 0.0)),
        "sponza": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
        "sponza-textured": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
    }
    pos, tgt = presets.get(spec, ((0, 1, 4), (0, 0, 0)))
    cam = Camera(position=pos)
    cam.look_at(tgt)
    return cam


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", action="append", default=None,
                    help="procedural preset, or .gltf/.glb/.obj path with "
                         "optional '@tx,ty,tz[,scale[,ry_deg]]' transform; "
                         "repeat to compose several models (main.cpp:30-41)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8,
                    help="progressive frames to render; with --frame-batch "
                         "F (or auto) the count rounds UP to a whole "
                         "number of F-frame steps (e.g. --frames 10 with "
                         "F=8 renders 16)")
    ap.add_argument("--spp-batch", action="store_true",
                    help="trace all spp samples as one wavefront "
                         "(cfg.spp_batch; bigger coherence-sort pool)")
    ap.add_argument("--frame-batch", default="1", metavar="F",
                    help="fold F progressive frames' spp pools into one "
                         "wavefront per step (implies --spp-batch; "
                         "identical estimator, same sample set). "
                         "'auto' picks F to grow the pool toward "
                         "config.POOL_SATURATION_LANES")
    ap.add_argument("--sky", default="gradient",
                    choices=["gradient", "black", "hosek", "envmap"])
    ap.add_argument("--envmap", default=None,
                    help="equirect environment file (.hdr Radiance RGBE, "
                         "or an LDR image) - required with --sky envmap")
    ap.add_argument("--env-nee", action="store_true",
                    help="importance-sample the env map with MIS "
                         "(one extra shadow ray per bounce)")
    ap.add_argument("--env-cell", type=int, default=8, metavar="N",
                    help="cell-interleaved env-NEE draws: pixels in an "
                         "NxN screen cell share one env direction per "
                         "(sample, depth) - coherent shadow tiles, "
                         "same per-pixel estimator (1 = independent)")
    ap.add_argument("--env-rr", type=float, default=0.0, metavar="M",
                    help="Russian roulette on env shadow rays: trace "
                         "with q = clip(M*lum(throughput), 1/8, 1), "
                         "weight survivors 1/q (unbiased; 0 disables)")
    ap.add_argument("--aperture", type=float, default=0.0,
                    help="thin-lens DoF: lens diameter in world units "
                         "(0 = pinhole, the reference's camera)")
    ap.add_argument("--focus-dist", type=float, default=0.0,
                    help="focal-plane distance along the view axis "
                         "(required with --aperture)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", default="pcg", choices=["pcg", "sobol"],
                    help="pcg = independent uniforms (reference class); "
                         "sobol = Owen-scrambled Sobol (lower variance)")
    ap.add_argument("--intersector", default="cluster",
                    choices=["cluster", "bvh", "brute"])
    ap.add_argument("--traversal-backend", default="auto",
                    choices=["auto", "triton", "xla"],
                    help="cluster-sweep route: triton (GPU kernel), xla, "
                         "or auto (the platform's route)")
    ap.add_argument("--interactive", action="store_true",
                    help="terminal viewer: ANSI truecolor preview, "
                         "WASD+arrow camera, accumulation resets on "
                         "movement (the reference's windowed loop)")
    ap.add_argument("--auto-frame-batch", type=int, default=8, metavar="F",
                    help="interactive throughput mode: while the camera "
                         "is static, each step after the first renders F "
                         "frames' sample pools as one wavefront; the step "
                         "after a move stays "
                         "single-frame for latency. 0/1 disables. Only "
                         "affects --interactive.")
    ap.add_argument("--motion-preview", type=int, default=2, metavar="S",
                    help="interactive latency mode: while the camera is "
                         "MOVING, render a 1-spp preview at 1/S "
                         "resolution and upscale for display (full-res "
                         "accumulation resumes the moment the camera "
                         "stops; the film never sees preview frames). "
                         "0/1 disables. Only affects --interactive.")
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera (resets accumulation per frame)")
    ap.add_argument("--out", default="out.png",
                    help="output PNG (or directory with --orbit)")
    ap.add_argument("--checkpoint", default=None,
                    help="film checkpoint to save/resume (.npz)")
    ap.add_argument("--priming", action="store_true",
                    help="verified primary-hit prediction across the spp "
                         "loop (exact; config.primary_priming)")
    ap.add_argument("--denoise", action="store_true",
                    help="edge-aware a-trous denoiser at display time "
                         "(film/denoise.py; the accumulation stays raw)")
    ap.add_argument("--clamp", type=float, default=0.0, metavar="C",
                    help="firefly clamp: bound each path sample's "
                         "radiance at C (biased variance control; "
                         "0 = off, the unbiased default)")
    ap.add_argument("--tonemap", default="gamma",
                    choices=["gamma", "reinhard", "aces"],
                    help="display transform: gamma = the reference's "
                         "pow-1/2.2; reinhard/aces add filmic highlight "
                         "rolloff (display-time only)")
    ap.add_argument("--aov", action="store_true",
                    help="also write primary-hit AOV images next to "
                         "--out: <out>_normal/_depth/_albedo.png "
                         "(net-new; the reference renders beauty only)")
    ap.add_argument("--mesh", default=None, metavar="TILE,SAMPLE",
                    help="render across a (tile, sample) device mesh via "
                         "shard_map (parallel/sharding.py); e.g. '4,2' on "
                         "8 devices. 'auto' factorizes all visible "
                         "devices. Composes with --priming/--denoise.")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    enable_compile_cache()

    specs = args.scene or ["cornell"]
    builder = load_scene(specs)
    if args.sky == "envmap" and not args.envmap:
        raise SystemExit("--sky envmap requires --envmap PATH "
                         "(a zero envmap would render black)")
    if args.envmap:
        builder.set_envmap(load_envmap(args.envmap))
    scene = builder.finalize()
    if args.frame_batch == "auto":
        if args.interactive:
            # the viewer's ADAPTIVE policy (--auto-frame-batch) owns
            # batching: a fixed F>1 here would make every post-move step
            # an F-frame batch (~F x movement latency, the opposite of
            # the latency-preserving design)
            frame_batch = 1
        else:
            from pathtracer.config import saturating_frame_batch

            frame_batch = saturating_frame_batch(
                args.width, args.height, args.spp)
    else:
        frame_batch = int(args.frame_batch)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, sky=args.sky,
                       env_importance_sampling=args.env_nee,
                       env_nee_cell=args.env_cell,
                       env_shadow_rr=args.env_rr,
                       aperture=args.aperture,
                       focus_dist=args.focus_dist,
                       seed=args.seed, sampler=args.sampler,
                       intersector=args.intersector,
                       traversal_backend=args.traversal_backend,
                       primary_priming=args.priming,
                       denoise=args.denoise,
                       tonemap=args.tonemap,
                       clamp_radiance=args.clamp,
                       capture_gbuffer=args.aov,
                       spp_batch=args.spp_batch or frame_batch > 1,
                       frame_batch=frame_batch)
    mesh = None
    if args.mesh:
        from pathtracer.parallel.sharding import make_mesh

        if args.mesh == "auto":
            mesh = make_mesh()
        else:
            tile, sample = (int(x) for x in args.mesh.split(","))
            mesh = make_mesh(tile=tile, sample=sample)
    cam = default_camera(specs[0])
    auto_fb = (args.auto_frame_batch
               if args.interactive and frame_batch == 1 else 0)
    r = Renderer(scene, cfg, cam, mesh=mesh, auto_frame_batch=auto_fb,
                 motion_preview=(args.motion_preview
                                 if args.interactive else 0))

    if args.checkpoint and os.path.exists(args.checkpoint):
        r.film = fm.load_checkpoint(args.checkpoint)
        r.camera.moved = False
        if not args.quiet:
            print(f"resumed at frame {int(r.film.frame)}")

    if args.interactive:
        from pathtracer import viewer

        n = viewer.run_interactive(r)
        if not args.quiet:
            print(f"rendered {n} frames")
        r.save_png(args.out)
        if args.aov:
            stem = os.path.splitext(args.out)[0]
            for name, img in r.aovs().items():
                fm.write_png(f"{stem}_{name}.png", img)
        if args.checkpoint:
            fm.save_checkpoint(args.checkpoint, r.film)
        return

    orbit_dir = None
    if args.orbit:
        orbit_dir = args.out
        os.makedirs(orbit_dir, exist_ok=True)
        center = np.asarray(cam.position) * 0  # orbit scene origin-ish
        radius = float(np.linalg.norm(cam.position))

    # --frames counts PROGRESSIVE FRAMES; with frame_batch=F each step
    # covers F of them
    steps = max(1, -(-args.frames // frame_batch))
    for i in range(steps):
        if args.orbit:
            ang = 2 * math.pi * i / steps
            r.camera.position = np.array(
                [radius * math.cos(ang), cam.position[1],
                 radius * math.sin(ang)], np.float32)
            r.camera.look_at(center)
        t0 = time.perf_counter()
        film = r.step()
        jax.block_until_ready(film.accum)
        dt = time.perf_counter() - t0
        if not args.quiet:
            print(json.dumps({
                "frame": int(film.frame),
                "ms": round(dt * 1e3, 2),
                "spp_accumulated": int(film.frame) * cfg.spp,
                "mean_radiance": round(float(np.asarray(film.accum).mean()), 5),
            }))
        if args.orbit:
            fm.write_png(os.path.join(orbit_dir, f"frame_{i:04d}.png"),
                         r.display())

    if not args.orbit:
        r.save_png(args.out)
        if not args.quiet:
            print(f"wrote {args.out}")
    if args.aov:
        stem = os.path.splitext(args.out)[0]
        for name, img in r.aovs().items():
            fm.write_png(f"{stem}_{name}.png", img)
            if not args.quiet:
                print(f"wrote {stem}_{name}.png")
    if args.checkpoint:
        fm.save_checkpoint(args.checkpoint, r.film)

    return 0


if __name__ == "__main__":
    sys.exit(main())
