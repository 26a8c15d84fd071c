#!/usr/bin/env python
"""Measured interactive-loop fps at reduced scale (the reference's defining
demo is a window you fly through: pathtracer/source/main.cpp:662-731).

Drives the REAL viewer loop end to end: Renderer.step() -> display()
(tone map + host readback) -> frame_to_ansi (terminal encode), with the
camera rotated every frame in "fly" mode so accumulation resets each
step (main.cpp:678-681 semantics) - the honest interactive worst case.
"accum" mode holds the camera still (progressive refinement fps).

Prints one JSON line per (scene, mode). Defaults: Cornell 480x272@1spp
and bunny-class 480x272@1spp, depth 6, production knobs.

  INTERACTIVE_SCENES=cornell,bunny  INTERACTIVE_FRAMES=30
  INTERACTIVE_W=480 INTERACTIVE_H=272 INTERACTIVE_SPP=1
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scene(name):
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.integrator.camera import Camera
    from pathtracer.scene import procedural

    if name == "cornell":
        b = procedural.cornell_box()
        cam = Camera(position=(0.0, 1.0, 3.2))
        cam.look_at((0.0, 1.0, 0.0))
    elif name == "bunny":
        b = procedural.bunny_like(subdivisions=6)
        cam = Camera(position=(0.0, 1.2, 2.6))
        cam.look_at((0.0, 0.7, 0.0))
    elif name == "sponza":
        b = procedural.sponza_like(target_tris=262_000, textured=True)
        cam = Camera(position=(3.0, 4.5, 6.0))
        cam.look_at((14.0, 3.0, 6.0))
    else:
        raise SystemExit(f"unknown scene {name!r}")
    return build_scene_clusters(b.finalize()), cam


def main():
    from pathtracer.bench.device import device_info
    from pathtracer.utils.compile_cache import enable_compile_cache

    device = device_info()           # fails unless JAX runs on a GPU
    enable_compile_cache()

    import numpy as np

    from pathtracer.config import RenderConfig
    from pathtracer.render import Renderer
    from pathtracer.viewer import frame_to_ansi

    w = int(os.environ.get("INTERACTIVE_W", 480))
    h = int(os.environ.get("INTERACTIVE_H", 272))
    spp = int(os.environ.get("INTERACTIVE_SPP", 1))
    n = int(os.environ.get("INTERACTIVE_FRAMES", 30))
    scenes = os.environ.get("INTERACTIVE_SCENES", "cornell,bunny").split(",")

    for name in scenes:
        scene, cam = _scene(name)
        cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=6,
                           intersector="cluster")
        # accum_fb: static-camera refinement with cfg.frame_batch=F -
        # F progressive frames' pools traced as ONE wavefront. At this
        # scale the per-frame pool is ~130k lanes, far below
        # config.POOL_SATURATION_LANES, so pool growth still cuts swept
        # columns; fps here counts accumulated frames.
        import dataclasses

        fb = int(os.environ.get("INTERACTIVE_FB", 8))
        # fly_preview: the motion-preview path (Renderer
        # motion_preview=2) - moving-camera steps render a 1-spp
        # preview at 1/2 resolution and display() upscales.
        for mode in ("fly", "fly_preview", "accum", "accum_fb"):
            mcfg = (dataclasses.replace(cfg, spp_batch=True,
                                        frame_batch=fb)
                    if mode == "accum_fb" else cfg)
            r = Renderer(scene, mcfg, camera=cam,
                         motion_preview=(
                             int(os.environ.get("INTERACTIVE_PREVIEW",
                                                2))
                             if mode == "fly_preview" else 0))
            # warmup: compile and flush first-run effects, with a host
            # read per frame
            for _ in range(4):
                if mode.startswith("fly"):
                    cam.process_mouse(15.0, 0.0)
                r.step()
                # full host sync: the preview path never touches the
                # film, so sync through display()
                float(np.asarray(r.display()).sum())
            r.reset()
            F = mcfg.frame_batch           # frames accumulated per step
            steps = max(1, n // F)
            t0 = time.perf_counter()
            for _ in range(steps):
                if mode.startswith("fly"):
                    cam.process_mouse(15.0, 0.0)   # ~1.5 deg yaw/frame
                r.step()
                img = r.display() * 255.0          # host readback = sync
                frame_to_ansi(img, cols=100, rows=40)
            dt = time.perf_counter() - t0
            nf = steps * F
            print(json.dumps({
                "metric": f"interactive_{name}_{mode}_fps",
                "value": round(nf / dt, 2),
                "unit": "fps",
                "ms_per_frame": round(1e3 * dt / nf, 1),
                "frames": nf,
                "steps": steps,
                "frame_batch": F,
                "resolution": [w, h],
                "spp": spp,
                "max_depth": 6,
                "loop": "step+display+ansi",
                "device": device,
            }))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
