"""Mesh-sharded renders gated against ALL FIVE config goldens.

test_sharding.py pins sharded-vs-single-device agreement on small ad-hoc
scenes; this file gates the mesh-sharded render against the five
committed BASELINE config goldens (tests/goldens/config_N_64.npz), so the
sharded path's accuracy matrix matches the single-device one.

Each config's 64x64 probe renders through `render_frame_sharded` on the
8-virtual-device (tile=4, sample=2) mesh and must pass the SAME robust
gate as benchmarks/run_configs.accuracy_probe (inlier RMSE + winner-flip
fraction + relative mean; pathtracer/bench/checks.image_gate).

Slow tier: five full 64x64@4spp depth-6 renders (incl. the 262k-tri
sponza scene) through shard_map on one CPU core. Run explicitly:

    python -m pytest tests/test_sharded_goldens.py -m slow -q
"""

import dataclasses
import os

import numpy as np
import pytest

from benchmarks.run_configs import (GOLDEN_DIR, MEAN_TOL, OUTLIER_TOL,
                                    PROBE_RES, PROBE_SPP, RMSE_TOL,
                                    build_configs)


@pytest.mark.slow
@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5])
def test_sharded_config_golden(idx):
    import jax

    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.parallel.sharding import make_mesh, render_frame_sharded

    name, scene_fn, cfg, camera = build_configs(scale=0.0625)[idx - 1]
    golden_path = os.path.join(GOLDEN_DIR, f"config_{idx}_{PROBE_RES}.npz")
    assert os.path.exists(golden_path), f"missing golden for {name}"

    pcfg = dataclasses.replace(cfg, width=PROBE_RES, height=PROBE_RES,
                               spp=PROBE_SPP, frame_batch=1,
                               spp_batch=False)
    scene = build_scene_clusters(scene_fn())
    mesh = make_mesh(jax.devices("cpu")[:8], tile=4, sample=2)
    img = np.asarray(
        render_frame_sharded(scene, pcfg, camera.state(), 0, mesh),
        np.float32)

    g = np.load(golden_path)["img"]
    d = img - g
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    inlier_rmse = float(np.sqrt(np.mean(d[inl] ** 2)))
    outlier_frac = float((ad > 0.01).mean())
    mean_rel = abs(float(img.mean()) - float(g.mean())) / max(
        abs(float(g.mean())), 1e-6)
    assert inlier_rmse <= RMSE_TOL, (name, inlier_rmse)
    assert outlier_frac <= OUTLIER_TOL, (name, outlier_frac)
    assert mean_rel <= MEAN_TOL, (name, mean_rel)
