"""pathtracer/bench/pair_metrics.py sanity (the BENCH roofline dict)."""

import numpy as np

from pathtracer.accel.cluster import build_scene_clusters
from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.scene.procedural import sponza_like


def test_bounce1_pair_metrics_fields():
    from pathtracer.bench.pair_metrics import bounce1_pair_metrics

    scene = build_scene_clusters(
        sponza_like(target_tris=5_000).finalize())
    cfg = RenderConfig(width=64, height=64, spp=1, max_depth=2)
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    pm = bounce1_pair_metrics(scene, cfg, cam)
    assert "error" not in pm, pm
    # the structural invariant the bench quotes: a tile pays at least
    # what its hungriest ray needs, so waste >= 1
    assert pm["packet_waste"] >= 1.0
    assert pm["tile_visited_cols_mean"] > 0
    assert pm["ray_needed_cols_mean"] > 0
    assert pm["sweep_pairs_g"] > 0
    assert pm["rays_probed"] > 0
    assert np.isfinite(pm["packet_waste"])
