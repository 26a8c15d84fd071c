#!/usr/bin/env python
"""Smoke test of the path tracer on an NVIDIA GPU: does the main path run
on the card, with kernels compiled for it, and are its answers right?

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded render only

Run from the repository root, one process per machine. Phases (each prints
its lines and its seconds, compilation included):

1. device   - JAX must run on a GPU (else exit 2, naming the platform);
              the card's name and power limit from nvidia-smi, whether the
              native host library loaded, the headline accel build time.
2. kernels  - the traversal route `auto` resolves to, compiled at real
              widths (memory analysis printed), checked on a 1M-ray
              headline bounce-1 batch against the XLA sweep and the
              brute-force oracles, and the Triton cull of one 131,072-ray
              chunk against the XLA cull bit for bit
              (bench/checks.kernel_checks, the same checks the
              `gpu`-marked tests run at a small size).
3. main     - pathtracer.app.main renders Cornell frames to a PNG; the
              headline (262k-triangle textured Sponza-class scene,
              1920x1080, 4 spp, depth 6, spp_batch) renders through
              Renderer: ms/frame, Mrays/s from the exact ray counter, peak
              device memory; then the five BASELINE configs' 64x64 probes
              are gated against the committed CPU goldens.
4. --multi  - only with the option, and then no other phase:
              render_frame_sharded on a (tile 2 x sample 2) mesh of four
              cards against the one-card render_frame of the same frame.

Any failed check raises; the exit code is then non-zero and no result line
is printed. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HEADLINE = dict(width=1920, height=1080, spp=4, max_depth=6, spp_batch=True)
HEADLINE_TRIS = 262_000
KERNEL_RAYS = 1 << 20        # eight production chunks of 131,072 rays
BRUTE_RAYS = 1 << 16
FRAMES = 3
MULTI_MEAN_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: {time.perf_counter() - t0:.1f} s")


def check(name, result):
    """Print one comparison with its tolerances; raise if it failed."""
    log(f"check {name}: {json.dumps(result)}")
    if not result["ok"]:
        raise AssertionError(f"check {name} failed: {result}")


def headline_scene():
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.config import RenderConfig
    from pathtracer.integrator.camera import Camera
    from pathtracer.scene.procedural import sponza_like

    t0 = time.perf_counter()
    scene = build_scene_clusters(
        sponza_like(target_tris=HEADLINE_TRIS, textured=True).finalize())
    log(f"accel build: {time.perf_counter() - t0:.1f} s "
        f"({scene.n_tris} triangles, {scene.clusters_fine.n_clusters} fine "
        f"+ {scene.clusters.n_clusters} coarse clusters)")
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    return scene, RenderConfig(**HEADLINE), cam


def kernels_phase(scene, cfg, cam):
    import jax

    from pathtracer.bench import checks
    from pathtracer.kernels import packet, triton_cull, triton_sweep
    from pathtracer.render import make_intersectors

    backend = make_intersectors(scene, cfg)[0].backend
    log(f"traversal backend: {cfg.traversal_backend} -> {backend}")
    if backend == "triton":
        k = scene.clusters_fine.tris_per_cluster
        log(f"triton sweep: one program per {packet.TILE_RAYS}-ray tile, "
            f"{triton_sweep.sub_cols(k)}-column sub-blocks of K={k}, "
            f"num_warps={triton_sweep.NUM_WARPS}")
        log(f"triton cull: one program per {packet.TILE_RAYS}-ray tile, "
            f"{triton_cull.CULL_COLS}-cluster blocks, "
            f"num_warps={triton_cull.NUM_WARPS}")
    o = jax.numpy.zeros((KERNEL_RAYS, 3), jax.numpy.float32)
    for name, fn in (
            ("closest", lambda o, d: packet.intersect_clusters(
                scene.clusters_fine, o, d, 1e-3, 1e20, backend=backend)),
            ("anyhit", lambda o, d: packet.occluded_clusters(
                scene.clusters, o, d, 1e20, backend=backend))):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(o, o).compile()
        log(f"compile {name} ({KERNEL_RAYS} rays): "
            f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
            f"{compiled.memory_analysis()}")
    for name, result in checks.kernel_checks(scene, cfg, cam, KERNEL_RAYS,
                                             BRUTE_RAYS):
        check(name, result)


def main_path_phase(scene, cfg, cam, card):
    import jax
    import numpy as np

    from pathtracer import app
    from pathtracer.film import film
    from pathtracer.render import Renderer

    os.makedirs("out", exist_ok=True)
    png = os.path.join("out", "chip_smoke_cornell.png")
    t0 = time.perf_counter()
    app.main(["--scene", "cornell", "--width", "64", "--height", "64",
              "--spp", "2", "--max-depth", "4", "--frames", "3",
              "--out", png, "--quiet"])
    img = film.read_png(png)
    log(f"app.main cornell -> {png}: {img.shape}, mean {img.mean():.4f}, "
        f"{time.perf_counter() - t0:.1f} s")
    check("cornell_png", {"ok": bool(img.shape == (64, 64, 3)
                                     and 0.05 < img.mean() < 0.95),
                          "shape": list(img.shape),
                          "mean": float(img.mean())})

    r = Renderer(scene, cfg, cam)
    t0 = time.perf_counter()
    r.step()
    warm_rays = float(r.last_rays)
    log(f"headline warm-up frame (compile included): "
        f"{time.perf_counter() - t0:.1f} s, {warm_rays:.0f} rays")
    ms, rays = [], []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        r.step()
        rays.append(float(r.last_rays))     # the host read ends the frame
        ms.append((time.perf_counter() - t0) * 1e3)
    accum = np.asarray(jax.block_until_ready(r.film.accum))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    mean_ms = sum(ms) / len(ms)
    result = {
        "ok": bool(np.isfinite(accum).all() and accum.mean() > 0
                   and accum.shape == (cfg.height, cfg.width, 3)),
        "ms_per_frame": ms, "mean_ms_per_frame": mean_ms,
        "mrays_per_s": sum(rays) / sum(ms) / 1e3,
        "rays_per_frame": rays, "peak_bytes_in_use_process": peak,
        "mean_radiance": float(accum.mean())}
    check(f"headline {cfg.width}x{cfg.height} {cfg.spp}spp depth "
          f"{cfg.max_depth} on {card}", result)

    from benchmarks.run_configs import accuracy_probe, build_configs

    from pathtracer.accel.cluster import build_scene_clusters

    for i, (name, scene_fn, ccfg, ccam) in enumerate(build_configs(1.0), 1):
        t0 = time.perf_counter()
        gate = accuracy_probe(build_scene_clusters(scene_fn()), ccfg, ccam, i)
        check(f"golden config_{i} {name} "
              f"({time.perf_counter() - t0:.1f} s)", gate)


def multi_phase():
    import jax
    import numpy as np

    from pathtracer.bench import checks
    from pathtracer.parallel.sharding import make_mesh, render_frame_sharded
    from pathtracer.render import render_frame

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX sees {len(devices)}")
    scene, cfg, cam = headline_scene()
    mesh = make_mesh(devices[:4], tile=2, sample=2)
    log(f"mesh: {dict(mesh.shape)} over {[str(d) for d in devices[:4]]}")
    t0 = time.perf_counter()
    sharded = np.asarray(render_frame_sharded(scene, cfg, cam.state(), 0,
                                              mesh))
    log(f"sharded frame (compile included): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    single = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    log(f"one-card frame (compile included): "
        f"{time.perf_counter() - t0:.1f} s")
    mean_rel = abs(float(sharded.mean()) - float(single.mean())) / max(
        abs(float(single.mean())), 1e-12)
    check("sharded_mean_vs_one_card", {
        "ok": bool(np.isfinite(sharded).all() and mean_rel <= MULTI_MEAN_RTOL),
        "mean_rel": mean_rel, "rtol": MULTI_MEAN_RTOL})
    check("sharded_image_vs_one_card", checks.image_gate(sharded, single))
    return len(mesh.devices.flat)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded render check")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    from pathtracer.bench import device as dev

    try:
        devices = dev.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    from pathtracer.utils import native
    from pathtracer.utils.compile_cache import enable_compile_cache

    with phase("device"):
        card = dev.smi_line()
        log(card)
        log(f"jax devices: {[str(d) for d in devices]} "
            f"({devices[0].device_kind})")
        log(f"compile cache: {enable_compile_cache()}")
        log(f"native host library loaded: {native.available()}")
        if not args.multi:
            scene, cfg, cam = headline_scene()
    if args.multi:
        with phase("multi"):
            count = multi_phase()
    else:
        with phase("kernels"):
            kernels_phase(scene, cfg, cam)
        with phase("main path"):
            main_path_phase(scene, cfg, cam, card)
        count = 1
    log(f"total: {time.perf_counter() - t_all:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
