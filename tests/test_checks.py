"""The comparison helpers chip_smoke.py gates the card with.

Each must pass what is within its tolerance and fail what is not, on
synthetic inputs, and kernel_checks must hold for the routes the CPU can
run (the XLA sweep, and the Triton kernel in the Pallas interpreter).
"""

import numpy as np
import pytest

from pathtracer.bench import checks


def test_compare_closest_tolerances():
    tri = np.arange(10_000) % 97 - 1               # some misses (-1)
    t = np.linspace(1.0, 50.0, tri.size)
    ok = checks.compare_closest(tri, t, tri, t * (1 + 5e-5))
    assert ok["ok"] and ok["id_agree"] == 1.0
    # misses agree whatever their t
    t_miss = np.where(tri < 0, np.inf, t)
    assert checks.compare_closest(tri, t, tri, t_miss)["ok"]
    # one flipped winner in 10,000 is inside the 99.9% bound ...
    flip = tri.copy()
    flip[5] += 1
    assert checks.compare_closest(tri, t, flip, t)["ok"]
    # ... eleven are not
    flip[:11] += 1
    assert not checks.compare_closest(tri, t, flip, t)["ok"]
    # where ids agree, t must agree to T_RTOL
    assert not checks.compare_closest(tri, t, tri, t * (1 + 2e-4))["ok"]
    assert not checks.compare_closest([], [], [], [])["ok"]


def test_compare_blocked_tolerance():
    ref = np.arange(20_000) % 3 == 0
    got = ref.copy()
    got[:20] = ~got[:20]                           # 0.1% disagree
    assert checks.compare_blocked(ref, got)["ok"]
    got[:21] = ~ref[:21]
    assert not checks.compare_blocked(ref, got)["ok"]


def test_verify_blockers_catches_false_hints():
    import jax.numpy as jnp

    # one triangle facing the rays (front face: d . n < 0), at z = 1
    v0 = jnp.asarray([[-1.0, -1.0, 1.0]])
    v1 = jnp.asarray([[-1.0, 1.0, 1.0]])
    v2 = jnp.asarray([[1.0, -1.0, 1.0]])
    o = jnp.asarray([[-0.5, -0.5, 0.0], [0.9, 0.9, 0.0], [-0.5, -0.5, 0.0]])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (3, 1))
    t_max = jnp.asarray([2.0, 2.0, 0.5])
    good = checks.verify_blockers(o, d, t_max, v0, v1, v2,
                                  [True, False, False], [0, -1, -1])
    assert good["ok"], good
    # a hint on an open ray, a blocked ray without a hint, a hint that
    # misses its ray, a hit past t_max: each counts
    for blocked, btri in (([True, False, True], [0, -1, 0]),
                          ([True, False, False], [0, 0, -1]),
                          ([True, True, False], [0, 0, -1]),
                          ([False, False, False], [-1, -1, 0])):
        assert not checks.verify_blockers(o, d, t_max, v0, v1, v2,
                                          blocked, btri)["ok"]


def test_compare_exact():
    a = np.asarray([[1.0, np.inf], [0.5, 2.0]], np.float32)
    assert checks.compare_exact(a, a.copy())["ok"]
    b = a.copy()
    b[1, 0] = np.nextafter(np.float32(0.5), np.float32(1.0))
    assert checks.compare_exact(a, b)["mismatches"] == 1
    assert not checks.compare_exact(a, b)["ok"]
    assert not checks.compare_exact(a, a[:1])["ok"]
    assert not checks.compare_exact(a[:0], a[:0])["ok"]


def test_image_gate():
    rng = np.random.default_rng(3)
    ref = rng.uniform(0.0, 1.0, (64, 64, 3)).astype(np.float32)
    assert checks.image_gate(ref, ref)["ok"]
    assert checks.image_gate(ref + 1e-4, ref)["ok"]
    flips = ref.copy()
    px = flips.reshape(-1, 3)
    px[0:40:2] += 0.3                               # ~1% flipped winners,
    px[1:40:2] -= 0.3                               # either way
    assert checks.image_gate(flips, ref)["ok"]
    px[0:200:2] += 0.3                              # ~5%
    px[1:200:2] -= 0.3
    assert not checks.image_gate(flips, ref)["ok"]
    assert not checks.image_gate(ref * 1.01, ref)["ok"]   # every pixel


@pytest.mark.parametrize("backend,interpret", [("xla", False),
                                               ("triton", True)])
def test_kernel_checks_on_cpu(backend, interpret):
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.config import RenderConfig
    from pathtracer.integrator.camera import Camera
    from pathtracer.scene.procedural import sponza_like

    scene = build_scene_clusters(sponza_like(target_tris=3000).finalize())
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=2)
    results = checks.kernel_checks(scene, cfg, cam, 1024, 256,
                                   backend=backend, interpret=interpret)
    assert [n for n, _ in results] == [
        "closest_vs_xla", "closest_vs_brute", "anyhit_vs_xla",
        "anyhit_vs_brute", "anyhit_blocker_bits",
        "anyhit_blockers_verify"] + (["cull_vs_xla"] if interpret else [])
    bad = [(n, r) for n, r in results if not r["ok"]]
    assert not bad, bad
    blocked = dict(results)["anyhit_vs_xla"]["blocked"]
    assert 0 < blocked < 1024                      # both outcomes occur
