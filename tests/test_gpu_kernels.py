"""The Triton sweep and cull compiled for the card, against their
references.

Marked `gpu`: each test takes the `gpu` fixture (tests/conftest.py),
which skips it unless JAX runs on a GPU. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

chip_smoke.py runs the same checks (bench/checks.kernel_checks) at the
headline's real widths.
"""

import pytest

from pathtracer.bench import checks


def _scene(tris):
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.config import RenderConfig
    from pathtracer.integrator.camera import Camera
    from pathtracer.scene.procedural import sponza_like

    scene = build_scene_clusters(
        sponza_like(target_tris=tris, textured=True).finalize())
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    return scene, RenderConfig(width=128, height=128, spp=4, max_depth=6,
                               spp_batch=True), cam


@pytest.mark.gpu
@pytest.mark.parametrize("tris,rays", [(20_000, 16_384), (60_000, 131_072)])
def test_triton_sweep_matches_references(gpu, tris, rays):
    scene, cfg, cam = _scene(tris)
    results = checks.kernel_checks(scene, cfg, cam, rays, 4096,
                                   backend="triton")
    bad = [(name, r) for name, r in results if not r["ok"]]
    assert not bad, bad


@pytest.mark.gpu
def test_auto_route_is_triton_on_gpu(gpu):
    from pathtracer.kernels import packet

    assert packet.resolve_backend("auto") == "triton"
