"""Golden-image regression: the Cornell render must not drift.

tests/golden_cornell_64.npy is the linear-radiance output of the default
estimator (4 frames x 2 spp, depth 4, cluster intersector) committed at
round 1. The counter-based RNG makes renders bit-stable across runs, so
any difference beyond float-reassociation noise is an estimator change -
intentional changes must regenerate the golden (see the script in this
file's history / BASELINE.md config 1).
"""

import os

import numpy as np

from pathtracer.accel.cluster import build_scene_clusters
from pathtracer.config import RenderConfig
from pathtracer.film.film import rmse
from pathtracer.integrator.camera import Camera
from pathtracer.render import render_frame
from pathtracer.scene.procedural import cornell_box

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cornell_64.npy")
_GOLDEN_256 = os.path.join(os.path.dirname(__file__),
                           "golden_cornell_256.npy")
_GOLDEN_Q256 = os.path.join(os.path.dirname(__file__),
                            "golden_cornell_quirks_256.npy")


def test_cornell_256_matches_golden():
    """BASELINE config 1 exactly: Cornell box, 256x256 @ 4 spp.

    Single frame (frame 0) of the default estimator at full config-1
    scale; the counter-based RNG keys on (pixel, sample, frame), so the
    render is deterministic and the committed golden pins the whole
    integrator (camera rays, traversal, NEE+MIS, BSDF, RR) at depth 6.
    """
    scene = build_scene_clusters(cornell_box().finalize())
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=6)
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    img = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    golden = np.load(_GOLDEN_256)
    err = rmse(img, golden)
    assert err <= 1e-4, f"render drifted from golden: RMSE {err:.2e}"


def test_cornell_quirks_256_matches_golden():
    """reference_quirks estimator at config-1 scale.

    Quirks mode reproduces the reference's estimator decisions exactly
    (emission not scaled by albedo factor, etc.); the 8x8 oracle test
    pins those semantics against an independent derivation, and this
    golden pins them at full config-1 resolution as regression.
    """
    scene = build_scene_clusters(cornell_box().finalize())
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=6,
                       reference_quirks=True)
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    img = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    golden = np.load(_GOLDEN_Q256)
    err = rmse(img, golden)
    assert err <= 1e-4, f"quirks render drifted from golden: RMSE {err:.2e}"


def test_cornell_matches_golden():
    scene = build_scene_clusters(cornell_box(materials_suite=True).finalize())
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    acc = np.zeros((64, 64, 3), np.float32)
    for f in range(4):
        acc += np.asarray(render_frame(scene, cfg, cam.state(), f))
    acc /= 4
    golden = np.load(_GOLDEN)
    err = rmse(acc, golden)
    assert err <= 1e-4, f"render drifted from golden: RMSE {err:.2e}"
