#!/usr/bin/env python
"""Headline benchmark: Sponza-class interior (~262k tris) at 1920x1080, 4spp
progressive loop on one GPU (BASELINE.json config 5).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"traversal_backend", "detail"}. vs_baseline is the ratio against the 300
Mrays/s per card north-star target; device names the card and its power
limit. Fails unless JAX runs on a GPU.

Scale down with env vars for smoke runs:
  BENCH_WIDTH/BENCH_HEIGHT/BENCH_TRIS/BENCH_FRAMES
"""

import json
import os
import sys


def main():
    from pathtracer.bench.device import device_info
    from pathtracer.utils.compile_cache import enable_compile_cache

    device = device_info()           # fails unless JAX runs on a GPU
    enable_compile_cache()
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    tris = int(os.environ.get("BENCH_TRIS", 262_000))
    frames = int(os.environ.get("BENCH_FRAMES", 8))
    # 4 spp/frame mirrors the reference's per-frame workload
    # (assets/shaders/raygen.rgen:100); override for smoke runs.
    spp = int(os.environ.get("BENCH_SPP", 4))
    # Textured headline by default: sRGB albedo + metal-rough +
    # normal maps + alpha-cutout banners - the reference's real workload
    # class (closesthit.rchit:88-112), not an untextured stand-in.
    textured = os.environ.get("BENCH_TEXTURED", "1") != "0"

    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.bench.harness import bench_scene
    from pathtracer.config import RenderConfig
    from pathtracer.integrator.camera import Camera
    from pathtracer.kernels.packet import resolve_backend
    from pathtracer.scene.procedural import sponza_like

    # BENCH_SCENE=path.glb|.gltf|.obj benches a FILE-loaded asset through
    # the full loader + native-unpack + texture path (the reference's
    # production input class, model_loader.cpp:253-289) instead of the
    # in-memory procedural build. BENCH_SCENE=export roundtrips the
    # procedural headline through export_glb -> load_gltf first.
    scene_file = os.environ.get("BENCH_SCENE")
    if scene_file == "export":
        import tempfile

        from pathtracer.scene.export import export_glb
        from pathtracer.scene.gltf import load_gltf

        path = os.path.join(tempfile.gettempdir(),
                            f"bench_sponza_{tris}_{int(textured)}.glb")
        if not os.path.exists(path):
            export_glb(sponza_like(target_tris=tris, textured=textured),
                       path)
        scene = load_gltf(path).finalize()
    elif scene_file:
        from pathtracer.app import load_scene

        scene = load_scene([scene_file]).finalize()
    else:
        scene = sponza_like(target_tris=tris, textured=textured).finalize()
    scene = build_scene_clusters(scene)

    # BENCH_PRIMING=1 enables verified primary-hit + blocker priming
    # (config.primary_priming).
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=6,
                       intersector="cluster",
                       # BENCH_SAMPLER=sobol measures the Owen-scrambled
                       # Sobol draw cost (sampling/sobol.py) on the real
                       # workload; estimator quality is pinned by the tests
                       sampler=os.environ.get("BENCH_SAMPLER", "pcg"),
                       primary_priming=os.environ.get(
                           "BENCH_PRIMING", "0") != "0",
                       # one wavefront for all spp samples, so the
                       # coherence sort pools every sample's rays
                       spp_batch=os.environ.get(
                           "BENCH_SPP_BATCH", "1") != "0",
                       # cross-frame sample batching (cfg.frame_batch):
                       # BENCH_FRAME_BATCH frames' spp pools as one
                       # wavefront (default 1; A/B knob for the S=8 pool)
                       frame_batch=int(os.environ.get(
                           "BENCH_FRAME_BATCH", "1")))
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))

    untex_ref = (textured
                 and os.environ.get("BENCH_UNTEXTURED_REF", "1") != "0")
    detail = {
        "tris": tris,
        "textured": textured,
        "resolution": [width, height],
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
    }
    if untex_ref:
        # companion number on the untextured workload; the two legs'
        # windows alternate, so both see the card in the same state
        # (clocks, temperature) instead of one leg running after the other
        from pathtracer.bench.harness import bench_interleaved

        plain = sponza_like(target_tris=tris, textured=False).finalize()
        plain = build_scene_clusters(plain)
        both = bench_interleaved({"tex": scene, "untex": plain}, cfg, cam,
                                 warmup=4, frames=frames)
        result, ref = both["tex"], both["untex"]
        detail["untextured_mrays_per_sec"] = round(ref.mrays_per_sec, 3)
        detail["untextured_ms_per_frame"] = round(ref.ms_per_frame, 3)
    else:
        result = bench_scene(scene, cfg, cam, warmup=4, frames=frames)
    detail["ms_per_frame"] = round(result.ms_per_frame, 3)
    detail["rays_per_frame"] = result.rays_per_frame
    detail["window_ms"] = [round(w, 1) for w in result.window_ms]
    detail["ms_std"] = round(result.ms_std, 1)

    # Exact visited-vs-needed column counts on this scene's real bounce-1
    # batch (pathtracer/bench/pair_metrics.py).
    if os.environ.get("BENCH_PAIR_METRICS", "1") != "0":
        from pathtracer.bench.pair_metrics import bounce1_pair_metrics

        detail["pair_metrics"] = bounce1_pair_metrics(scene, cfg, cam)

    baseline = 300.0  # Mrays/s/chip north-star (BASELINE.json)
    print(json.dumps({
        "metric": "sponza_1080p_mrays_per_sec_per_chip",
        "value": round(result.mrays_per_sec, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(result.mrays_per_sec / baseline, 4),
        "device": device,
        "traversal_backend": resolve_backend(cfg.traversal_backend),
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
