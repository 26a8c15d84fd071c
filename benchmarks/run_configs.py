#!/usr/bin/env python
"""Run all five BASELINE.json bench configs, print one JSON line each.

  1. Cornell box 256x256 @ 4 spp        (golden-image config)
  2. bunny-class mesh (~81k tris) 512^2 (LBVH build + traverse)
  3. materials suite 512^2 @ 64 spp     (GGX metal + dielectric + MIS)
  4. env-map + textured scene 1024^2    (HDR importance sampling)
  5. Sponza-class (~262k tris) 1080p    (headline Mrays/s + ms/frame)

Scale down for smoke runs: --scale 0.25 (resolution) --frames 2.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pathtracer.bench.checks import (  # noqa: E402,F401  (re-exported)
    MEAN_TOL, OUTLIER_TOL, RMSE_TOL, image_gate)


def build_configs(scale: float):
    import functools

    from pathtracer.config import RenderConfig as _RC
    from pathtracer.integrator.camera import Camera
    from pathtracer.scene import procedural
    from pathtracer.scene.build import MaterialDesc

    # Production parity: the headline bench runs spp-batched wavefronts,
    # so the config sweep uses the same default. PT_CFG_SPP_BATCH=0
    # reverts to per-sample wavefronts. Exception: config 1 routes to the
    # dense 12-tri intersector (render.py make_intersectors), where there
    # is no coherence sort for a bigger pool to help - it stays per-sample.
    _sb = os.environ.get("PT_CFG_SPP_BATCH", "1") != "0"
    RenderConfig = functools.partial(_RC, spp_batch=_sb)

    # Frame-batch each progressive config toward the pool-saturation
    # point (config.POOL_SATURATION_LANES: the column win rides on pool
    # growth, which the 1-spp configs leave on the table), capped at 8
    # frames/step. The sample set is identical (frame_batch semantics);
    # ms/frame stays per-frame (harness renormalizes). PT_CFG_FB=0
    # disables.
    _fb_auto = os.environ.get("PT_CFG_FB", "auto") == "auto"

    def _with_fb(cfg):
        if not (_fb_auto and cfg.spp_batch):
            return cfg
        import dataclasses

        from pathtracer.config import saturating_frame_batch

        f = saturating_frame_batch(cfg.width, cfg.height, cfg.spp)
        return dataclasses.replace(cfg, frame_batch=f)

    def r(x):
        return max(16, int(x * scale) // 8 * 8)

    def cam(pos, tgt):
        c = Camera(position=pos)
        c.look_at(tgt)
        return c

    def envmap_scene():
        b = procedural.bunny_like(subdivisions=5)
        # checkerboard texture on the body + an HDR sky with a hot sun
        tex = np.indices((256, 256)).sum(axis=0) % 2
        tex = (np.stack([tex] * 3, -1) * 0.6 + 0.2).astype(np.float32)
        tid = b.add_texture(tex)
        b.materials[1] = MaterialDesc(albedo=(1, 1, 1), albedo_tex=tid,
                                      roughness=0.4)
        # a real Radiance .hdr file on disk feeds the env light (BASELINE
        # config 4 = "HDR env-map"): gradient sky + hot sun disc, written
        # and re-read through the RGBE codec (pathtracer/scene/hdr.py)
        from pathtracer.scene.hdr import read_hdr, write_hdr

        eh, ew = 512, 1024
        theta = np.linspace(0, np.pi, eh)[:, None]
        env = np.zeros((eh, ew, 3), np.float32)
        horizon = np.clip(np.sin(theta), 0, 1) ** 3
        env[..., 0] = 0.25 + 0.5 * horizon
        env[..., 1] = 0.35 + 0.45 * horizon
        env[..., 2] = 0.6 + 0.25 * horizon
        env[60:76, 220:236] = 800.0  # sun disc
        hdr_path = os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "bench_env.hdr")
        write_hdr(hdr_path, env)
        b.set_envmap(read_hdr(hdr_path))
        return b.finalize()

    configs = [
        ("cornell_256_4spp",
         lambda: procedural.cornell_box().finalize(),
         RenderConfig(width=r(256), height=r(256), spp=4, max_depth=6,
                      spp_batch=False),  # dense route: batching loses
         cam((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))),
        ("bunny_512_lbvh",
         lambda: procedural.bunny_like().finalize(),
         RenderConfig(width=r(512), height=r(512), spp=1, max_depth=6),
         cam((0.0, 2.0, 5.0), (0.0, 1.2, 0.0))),
        ("materials_512_64spp",
         lambda: procedural.cornell_box(materials_suite=True).finalize(),
         RenderConfig(width=r(512), height=r(512), spp=4, max_depth=6),
         cam((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))),  # 64 spp = 16 frames x 4
        ("envmap_textured_1024",
         envmap_scene,
         RenderConfig(width=r(1024), height=r(1024), spp=1, max_depth=6,
                      sky="envmap", env_importance_sampling=True,
                      emission_gain=1.0),
         cam((0.0, 2.5, 5.5), (0.0, 1.2, 0.0))),
        ("sponza_1080p",
         lambda: procedural.sponza_like().finalize(),
         RenderConfig(width=r(1920), height=r(1080), spp=1, max_depth=6),
         cam((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))),
    ]
    return [(n, s, _with_fb(c), cm) for n, s, c, cm in configs]


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "goldens")
PROBE_RES = 64          # fixed accuracy-probe resolution (every config)
PROBE_SPP = 4


def accuracy_probe(scene, cfg, camera, idx, write=False):
    """Fixed 64x64 same-seed render vs the committed per-config golden.

    The counter-based RNG makes the probe deterministic in (seed, frame,
    pixel), so cross-platform differences are pure float arithmetic.
    Dense scenes flip nearest-hit WINNERS at silhouettes across
    platforms (a different fused multiply-add order in the sweep moves t
    by ~1 ulp and a different triangle wins), so the gate is robust
    (pathtracer/bench/checks.image_gate): inlier RMSE (|diff| <= 98th
    pct) <= RMSE_TOL AND winner-flip pixels (|diff| > 0.01) <=
    OUTLIER_TOL AND relative mean shift <= MEAN_TOL. Real behavioral
    drift moves ALL pixels (fails inlier/mean) or many (fails outlier).
    Returns the gate dict (checks.image_gate: ok, inlier_rmse,
    outlier_frac, mean_rel), or {"ok": bool, "golden": "written" |
    "missing"} when there is nothing to compare.
    """
    import dataclasses

    from pathtracer.render import render_frame

    pcfg = dataclasses.replace(cfg, width=PROBE_RES, height=PROBE_RES,
                               spp=PROBE_SPP)
    img = np.asarray(render_frame(scene, pcfg, camera.state(), 0),
                     np.float32)
    path = os.path.join(GOLDEN_DIR, f"config_{idx}_{PROBE_RES}.npz")
    if write:
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.savez_compressed(path, img=img)
        return {"ok": True, "golden": "written"}
    if not os.path.exists(path):
        return {"ok": False, "golden": "missing"}
    return image_gate(img, np.load(path)["img"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the 64x64 accuracy probe per config")
    ap.add_argument("--write-goldens", action="store_true",
                    help="(re)write tests/goldens/config_N_64.npz instead "
                         "of checking")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="also write the per-config results as one JSON "
                         "file")
    args = ap.parse_args(argv)

    from pathtracer.bench.device import device_info
    from pathtracer.utils.compile_cache import enable_compile_cache

    # goldens are written on the CPU; every measurement needs the GPU
    device = None if args.write_goldens else device_info()
    enable_compile_cache()
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.bench.harness import bench_scene

    wanted = {int(x) for x in args.configs.split(",")}
    results = []
    for i, (name, scene_fn, cfg, camera) in enumerate(
            build_configs(args.scale), start=1):
        if i not in wanted:
            continue
        scene = build_scene_clusters(scene_fn())
        if args.write_goldens:
            accuracy_probe(scene, cfg, camera, i, write=True)
            print(json.dumps({"config": name, "golden": "written"}),
                  flush=True)
            continue
        res = bench_scene(scene, cfg, camera, warmup=3, frames=args.frames)
        out = {
            "config": name,
            "mrays_per_sec": round(res.mrays_per_sec, 3),
            "ms_per_frame": round(res.ms_per_frame, 3),
            "rays_per_frame": res.rays_per_frame,
            "tris": int(scene.n_tris),
            "resolution": [cfg.width, cfg.height],
            "spp": cfg.spp,
            "device": device,
        }
        if not args.no_check:
            gate = accuracy_probe(scene, cfg, camera, i)
            out["inlier_rmse_vs_golden"] = gate.get("inlier_rmse")
            out["accuracy_ok"] = gate["ok"]
        print(json.dumps(out), flush=True)
        results.append(out)
    if args.out and results:
        import datetime

        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"date": datetime.date.today().isoformat(),
                       "scale": args.scale, "frames": args.frames,
                       "configs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
