"""Full-pipeline render tests (golden-style, SURVEY.md par.4.2-4.4).

Compile-heavy: configs are tiny and deliberately shared across tests so the
jit cache is reused.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer import film as fm
from pathtracer.accel.lbvh import build_scene_bvh
from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.render import Renderer, render_frame
from pathtracer.scene.build import MaterialDesc, SceneBuilder
from pathtracer.scene.procedural import cornell_box, icosphere


def test_furnace_exact():
    """White-furnace: convex lambertian sphere under a constant-1 envmap.

    Cosine-sampled bounces always escape a convex body, so every camera ray
    that hits the sphere returns exactly albedo * 1.0 (see test body for the
    estimator algebra). This pins the whole integrator chain - camera,
    intersection, BSDF sampling, throughput, sky - to an analytic value.
    """
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(albedo=(0.6, 0.6, 0.6), roughness=1.0))
    sv, sf = icosphere(1.0, (0, 0, 0), 3)
    b.add_mesh(sv, sf, m)
    b.set_envmap(np.ones((4, 8, 3), np.float32))
    scene = b.finalize()

    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3,
                       sky="envmap", emission_gain=1.0, intersector="brute")
    cam = Camera(position=(0, 0, 3))
    cam.look_at((0, 0, 0))
    img = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    # Diffuse part contributes exactly albedo per sample; the always-on
    # 0.04-F0 GGX lobe of the reference BRDF (common.glsl:156-163) adds a
    # small positive spec term on top.
    center = img[8, 8]
    assert 0.595 < center[0] < 0.70, center
    np.testing.assert_allclose(center[0], center[1], atol=1e-6)  # grey in = grey out
    # background pixels see the envmap directly: exactly 1
    corner = img[0, 0]
    np.testing.assert_allclose(corner, 1.0, atol=1e-3)


@pytest.fixture(scope="module")
def cornell_setup():
    scene = cornell_box().finalize()
    scene_bvh = build_scene_bvh(scene)
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=3,
                       intersector="brute")
    return scene, scene_bvh, cam, cfg


def test_cornell_brute_nonzero_finite(cornell_setup):
    scene, _, cam, cfg = cornell_setup
    img = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    assert np.isfinite(img).all()
    assert img.mean() > 0.05
    # red wall (image columns ~6-7) vs green wall (~16-18) at this camera:
    left = img[8:16, 6:8].mean(axis=(0, 1))
    right = img[8:16, 16:19].mean(axis=(0, 1))
    assert left[0] > 2 * left[1]   # red dominant
    assert right[1] > 2 * right[0]  # green dominant


def test_bvh_matches_brute_end_to_end(cornell_setup):
    """Same rays + same RNG, only the intersector differs -> images match."""
    scene, scene_bvh, cam, cfg = cornell_setup
    img_brute = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    cfg_bvh = dataclasses.replace(cfg, intersector="bvh")
    img_bvh = np.asarray(render_frame(scene_bvh, cfg_bvh, cam.state(), 0))
    np.testing.assert_allclose(img_bvh, img_brute, rtol=1e-3, atol=1e-3)


def test_cluster_matches_brute_end_to_end(cornell_setup):
    """Packet (cluster) traversal renders the same image as the oracle."""
    from pathtracer.accel.cluster import build_scene_clusters

    scene, _, cam, cfg = cornell_setup
    img_brute = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    scene_cl = build_scene_clusters(scene)
    cfg_cl = dataclasses.replace(cfg, intersector="cluster")
    img_cl = np.asarray(render_frame(scene_cl, cfg_cl, cam.state(), 0))
    np.testing.assert_allclose(img_cl, img_brute, rtol=1e-3, atol=1e-3)


def test_render_deterministic(cornell_setup):
    scene, _, cam, cfg = cornell_setup
    a = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    b = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(render_frame(scene, cfg, cam.state(), 1))
    assert not np.array_equal(a, c)  # frames draw fresh samples


def test_progressive_accumulation_and_reset(cornell_setup):
    scene, _, cam, cfg = cornell_setup
    r = Renderer(scene, cfg, cam)
    r.camera.moved = False
    f1 = r.step()
    assert int(f1.frame) == 1
    f2 = r.step()
    assert int(f2.frame) == 2
    # accumulation must equal the mean of the two frame estimates
    e0 = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    e1 = np.asarray(render_frame(scene, cfg, cam.state(), 1))
    np.testing.assert_allclose(np.asarray(f2.accum), (e0 + e1) / 2, rtol=1e-5,
                               atol=1e-6)
    # camera move resets (main.cpp:678-681)
    r.camera.process_keyboard("forward", 0.01)
    f3 = r.step()
    assert int(f3.frame) == 1


def test_checkpoint_resume_exact(cornell_setup, tmp_path):
    """Save at frame 1, resume, render frame 2 -> bit-identical to straight
    run (counter-based RNG makes resume exact, SURVEY.md par.5)."""
    scene, _, cam, cfg = cornell_setup
    r = Renderer(scene, cfg, cam)
    r.camera.moved = False
    r.step()
    fm.save_checkpoint(str(tmp_path / "ck.npz"), r.film)
    straight = r.step()

    r2 = Renderer(scene, cfg, cam)
    r2.camera.moved = False
    r2.film = fm.load_checkpoint(str(tmp_path / "ck.npz"))
    resumed = r2.step()
    np.testing.assert_array_equal(np.asarray(straight.accum),
                                  np.asarray(resumed.accum))


def test_reference_quirks_mode_runs(cornell_setup):
    scene, _, cam, cfg = cornell_setup
    qcfg = dataclasses.replace(cfg, reference_quirks=True)
    img = np.asarray(render_frame(scene, qcfg, cam.state(), 0))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_primary_priming_exact():
    """Verified primary-hit prediction changes NOTHING in the estimate.

    spp=2 so sample 1 traverses with sample 0's primary hits as per-ray
    t_max bounds; the scene is >256 tris so the real cluster path (not the
    tiny-scene brute route) is exercised. Predictions are re-verified, so
    the image must match the unprimed render to float rounding.
    """
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import render_frame_with_stats

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    assert scene.n_tris > 256
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster")
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    base, rays_b = render_frame_with_stats(scene, cfg, cam.state(), 0)
    primed, rays_p = render_frame_with_stats(scene, cfg_p, cam.state(), 0)
    np.testing.assert_allclose(np.asarray(primed), np.asarray(base),
                               rtol=1e-5, atol=1e-6)
    # the ray COUNT is also unchanged: priming only bounds t_max
    np.testing.assert_allclose(float(rays_p), float(rays_b), rtol=1e-6)


def test_primary_priming_cross_frame_exact():
    """Priming chained across progressive frames (Renderer) is exact too."""
    from pathtracer.accel.cluster import build_scene_clusters

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3,
                       intersector="cluster")
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    rb, rp = Renderer(scene, cfg, cam), Renderer(scene, cfg_p, cam)
    rb.camera.moved = rp.camera.moved = False
    for _ in range(2):   # frame 2's sample is primed by frame 1's hits
        fb, fp = rb.step(), rp.step()
    np.testing.assert_allclose(np.asarray(fp.accum), np.asarray(fb.accum),
                               rtol=1e-5, atol=1e-6)
    assert rp._prime is not None
    assert int(jnp.max(rp._prime[:, 0])) >= 0  # primary hits recorded
    assert int(jnp.max(rp._prime[:, 1])) >= 0  # shadow blockers found


def test_env_nee_priming_exact():
    """Env-NEE blocker priming (prime[:, 2]) changes nothing either."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import render_frame_with_stats

    b = cornell_box()   # enclosed: env shadow rays mostly blocked
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    env = np.ones((8, 16, 3), np.float32)
    env[2, 3] = 50.0                      # hotspot: importance matters
    b.set_envmap(env)
    scene = build_scene_clusters(b.finalize())
    assert scene.n_tris > 256
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       sky="envmap", env_importance_sampling=True,
                       intersector="cluster")
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    base, rays_b = render_frame_with_stats(scene, cfg, cam.state(), 0)
    primed, rays_p = render_frame_with_stats(scene, cfg_p, cam.state(), 0)
    np.testing.assert_allclose(np.asarray(primed), np.asarray(base),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(rays_p), float(rays_b), rtol=1e-6)


def test_priming_quirks_mode_exact():
    """Priming exactness holds in reference_quirks mode too (the quirk
    shadow scheme aims behind the light; verification follows the same
    segment, so hints stay conclusive)."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import render_frame_with_stats

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster", reference_quirks=True)
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    base, rays_b = render_frame_with_stats(scene, cfg, cam.state(), 0)
    primed, rays_p = render_frame_with_stats(scene, cfg_p, cam.state(), 0)
    np.testing.assert_allclose(np.asarray(primed), np.asarray(base),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(rays_p), float(rays_b), rtol=1e-6)


def test_spp_batched_frame_matches_loop():
    """cfg.spp_batch traces all spp samples as ONE wavefront; the
    estimator is identical to the per-sample loop (the RNG keys on
    (pixel, frame*spp + s) either way) - only float summation order
    differs. Exercises the real cluster path (>256 tris), both plain
    and with verified priming (which must stay correctness-neutral in
    batched mode: hints scatter last-writer-wins across a pixel's
    sample lanes and are re-verified on use)."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import render_frame_with_stats

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    assert scene.n_tris > 256
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=3,
                       intersector="cluster")
    base, rays_b = render_frame_with_stats(scene, cfg, cam.state(), 0)
    cfg_b = dataclasses.replace(cfg, spp_batch=True)
    batched, rays_k = render_frame_with_stats(scene, cfg_b, cam.state(), 0)
    np.testing.assert_allclose(np.asarray(batched), np.asarray(base),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(rays_k), float(rays_b), rtol=1e-6)

    cfg_bp = dataclasses.replace(cfg_b, primary_priming=True)
    primed, rays_p, prime = render_frame_with_stats(
        scene, cfg_bp, cam.state(), 0, return_prime=True)
    np.testing.assert_allclose(np.asarray(primed), np.asarray(base),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(rays_p), float(rays_b), rtol=1e-6)
    assert prime.shape == (16 * 16, 3)

    # G-buffer (denoiser input) in batched mode: per-PIXEL shapes and
    # the same SVGF moment semantics as the loop
    rg, _, gb = render_frame_with_stats(scene, cfg_b, cam.state(), 0,
                                        gbuffer=True)
    _, _, gl = render_frame_with_stats(scene, cfg, cam.state(), 0,
                                       gbuffer=True)
    assert gb["normal"].shape == (16 * 16, 3)
    assert gb["depth"].shape == (16 * 16,)
    np.testing.assert_allclose(np.asarray(gb["m1"]), np.asarray(gl["m1"]),
                               rtol=1e-4, atol=1e-5)
    # joint winner consistency: with spp duplicate writers per pixel the
    # scatter winner is unspecified PER OP, so normal/depth/albedo must
    # come from ONE sample (single row scatter). The failure mode is a
    # finite-depth pixel with a zeroed normal (it blacks out under the
    # a-trous weights) or an inf-depth pixel with a nonzero normal.
    nrm = np.asarray(gb["normal"])
    dep = np.asarray(gb["depth"])
    hit_px = np.isfinite(dep)
    assert (np.linalg.norm(nrm[hit_px], axis=1) > 0.9).all()
    assert (np.linalg.norm(nrm[~hit_px], axis=1) < 1e-6).all()


def test_frame_batched_matches_progressive_loop():
    """cfg.frame_batch folds F frames' spp pools into ONE wavefront; the
    film after one batched step must match F per-frame steps (identical
    sample set - RNG keys on frame*spp + s either way), with and without
    verified priming, and the ray counters must agree."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import Renderer

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    base_cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                            intersector="cluster", spp_batch=True)
    for priming in (False, True):
        cfg = dataclasses.replace(base_cfg, primary_priming=priming)
        cfg_f = dataclasses.replace(cfg, frame_batch=2)
        r1 = Renderer(scene, cfg, cam)
        r2 = Renderer(scene, cfg_f, cam)
        r1.camera.moved = r2.camera.moved = False
        r1.step(), r1.step()
        r2.step()
        assert int(r1.film.frame) == int(r2.film.frame) == 2
        np.testing.assert_allclose(np.asarray(r2.film.accum),
                                   np.asarray(r1.film.accum),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"priming={priming}")
        if priming:
            assert r2._prime is not None
            assert int(jnp.max(r2._prime[:, 0])) >= 0


def test_frame_batch_requires_spp_batch():
    with pytest.raises(ValueError):
        RenderConfig(width=8, height=8, spp=1, frame_batch=2)


def test_auto_frame_batch_matches_single_steps():
    """Renderer(auto_frame_batch=F): the step after construction (or a
    camera move) renders ONE frame for latency; each static step after
    that folds F frames. The film must match single-frame stepping at
    the same frame count (identical sample set), and a camera move must
    drop back to a 1-frame step."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import Renderer

    scene = build_scene_clusters(cornell_box().finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster")
    ra = Renderer(scene, cfg, cam, auto_frame_batch=3)
    ra.camera.moved = False
    ra.step()                                     # latency step: 1 frame
    assert int(ra.film.frame) == 1
    ra.step()                                     # throughput step: 3
    assert int(ra.film.frame) == 4

    rb = Renderer(scene, cfg, Camera(position=(0.5, 0.5, 2.2)))
    rb.camera.look_at((0.5, 0.5, 0.0))
    rb.camera.moved = False
    for _ in range(4):
        rb.step()
    np.testing.assert_allclose(np.asarray(ra.film.accum),
                               np.asarray(rb.film.accum),
                               rtol=1e-4, atol=1e-5)

    ra.camera.moved = True                        # a move resets + drops
    ra.step()                                     # back to 1-frame step
    assert int(ra.film.frame) == 1


def test_pool_parts_split_exact(monkeypatch):
    """PT_MAX_WAVEFRONT caps the batched pool: the spatially-split parts
    path must reproduce the single-wavefront render exactly (same sample
    set; pool DENSITY per pixel is what the column win rides on), with
    priming and the G-buffer composing."""
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import Renderer

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster", spp_batch=True,
                       frame_batch=2, primary_priming=True, denoise=True)

    def run():
        r = Renderer(scene, cfg, cam)
        r.camera.moved = False
        r.step()
        return (np.asarray(r.film.accum), np.asarray(r._prime),
                {k: np.asarray(v) for k, v in (r._gbuf or {}).items()})

    whole_img, whole_prime, whole_gb = run()
    # 16x16 x 2 spp x 2 frames = 1024 lanes; cap at 512 -> 2 parts
    monkeypatch.setenv("PT_MAX_WAVEFRONT", "512")
    part_img, part_prime, part_gb = run()
    np.testing.assert_allclose(part_img, whole_img, rtol=1e-5, atol=1e-6)
    # hints: parts see only their own pixels' lanes, but every returned
    # hint row must still be a valid (verified-on-use) prediction
    assert part_prime.shape == whole_prime.shape
    assert (part_prime[:, 0] >= -1).all()
    assert (part_prime[:, 0] >= 0).any()
    for k in ("normal", "depth", "albedo", "m1", "m2"):
        np.testing.assert_allclose(part_gb[k], whole_gb[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_env_nee_cell_interleaving_unbiased():
    """Cell-interleaved env-NEE draws (cfg.env_nee_cell) keep the
    estimator unbiased: the white furnace with env NEE + MIS must still
    return albedo on the sphere and exactly 1.0 on the background, and
    the cell=8 / cell=1 images must agree in MEAN within MC noise (the
    per-pixel estimator is identical; only cross-pixel correlation of
    the env-direction streams changes)."""
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(albedo=(0.6, 0.6, 0.6), roughness=1.0))
    sv, sf = icosphere(1.0, (0, 0, 0), 3)
    b.add_mesh(sv, sf, m)
    b.set_envmap(np.ones((4, 8, 3), np.float32))
    scene = b.finalize()

    base = RenderConfig(width=16, height=16, spp=4, max_depth=3,
                        sky="envmap", emission_gain=1.0,
                        env_importance_sampling=True, intersector="brute")
    cam = Camera(position=(0, 0, 3))
    cam.look_at((0, 0, 0))
    imgs = {}
    for cell in (1, 8):
        cfg = dataclasses.replace(base, env_nee_cell=cell)
        imgs[cell] = np.asarray(render_frame(scene, cfg, cam.state(), 0))
        center = imgs[cell][8, 8]
        assert 0.595 < center[0] < 0.70, (cell, center)
        np.testing.assert_allclose(imgs[cell][0, 0], 1.0, atol=1e-3)
    # means agree within MC noise (constant furnace -> tiny variance)
    np.testing.assert_allclose(imgs[8].mean(), imgs[1].mean(), rtol=2e-2)
    # and the draws really are shared: with cell=8 a 16x16 frame has 4
    # cells, so at most 4 distinct env directions per (sample, depth)
    assert not np.allclose(imgs[8], imgs[1])

    # env shadow-ray RR (cfg.env_shadow_rr) is unbiased too: disabling
    # it must agree in mean within MC noise (RR only fires at bounce>=1
    # where throughput < 1, weighting survivors 1/q)
    cfg_norr = dataclasses.replace(base, env_shadow_rr=0.0)
    img_norr = np.asarray(render_frame(scene, cfg_norr, cam.state(), 0))
    np.testing.assert_allclose(img_norr.mean(), imgs[1].mean(), rtol=2e-2)
    np.testing.assert_allclose(img_norr[0, 0], 1.0, atol=1e-3)


def test_motion_preview_semantics(cornell_setup):
    """Motion preview (Renderer motion_preview=s): moving-camera steps
    render a low-res preview WITHOUT touching the film, and the first
    static step resumes full-res accumulation bit-identically to a
    renderer without preview."""
    from pathtracer.render import Renderer

    scene, _, cam_f, cfg = cornell_setup

    def fresh_cam():
        cam = Camera(position=(0.5, 0.5, 2.2))
        cam.look_at((0.5, 0.5, 0.0))
        return cam

    r = Renderer(scene, cfg, fresh_cam(), motion_preview=2)
    r.camera.process_mouse(10.0, 0.0)      # sets camera.moved
    film = r.step()                         # preview step
    assert int(film.frame) == 0             # film untouched
    assert r._preview is not None
    img = r.display()
    assert img.shape == (cfg.height, cfg.width, 3)
    # static now: next step renders the REAL frame 1
    film = r.step()
    assert int(film.frame) == 1
    assert r._preview is None               # preview cleared

    # bit-identical to a no-preview renderer after the same move
    r2 = Renderer(scene, cfg, fresh_cam())
    r2.camera.process_mouse(10.0, 0.0)
    r2.step()
    np.testing.assert_array_equal(np.asarray(r.film.accum),
                                  np.asarray(r2.film.accum))


def test_env_nee_batched_frames_window():
    """render_frame_batched with frames > cfg.frame_batch (the adaptive
    viewer path) must reproduce the progressive frames' estimator: the
    env-NEE dedup table sizes its sample window from the TRUE pool
    (regression: an under-sized window would silently clamp late
    frames onto the wrong draw streams)."""
    from pathtracer.render import render_frame, render_frame_batched

    b = SceneBuilder()
    m = b.add_material(MaterialDesc(albedo=(0.6, 0.6, 0.6), roughness=1.0))
    sv, sf = icosphere(1.0, (0, 0, 0), 2)
    b.add_mesh(sv, sf, m)
    env = np.ones((4, 8, 3), np.float32)
    env[1, 2] = 25.0
    b.set_envmap(env)
    scene = b.finalize()
    cam = Camera(position=(0, 0, 3))
    cam.look_at((0, 0, 0))

    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       sky="envmap", emission_gain=1.0,
                       env_importance_sampling=True, intersector="brute",
                       spp_batch=True)  # frame_batch stays 1
    F = 2
    batched_sum = render_frame_batched(
        scene, cfg, cam.state(), jnp.uint32(0), frames=F)[0]
    loop = sum(np.asarray(render_frame(scene, cfg, cam.state(), f))
               for f in range(F))
    np.testing.assert_allclose(np.asarray(batched_sum), loop,
                               rtol=2e-5, atol=2e-5)


def test_clamp_radiance(cornell_setup):
    """cfg.clamp_radiance bounds per-sample radiance (firefly clamp,
    off by default = bit-identical estimator)."""
    scene, _, cam, cfg = cornell_setup
    base = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    off = np.asarray(render_frame(
        scene, dataclasses.replace(cfg, clamp_radiance=0.0),
        cam.state(), 0))
    np.testing.assert_array_equal(base, off)
    c = dataclasses.replace(cfg, clamp_radiance=0.5)
    img = np.asarray(render_frame(scene, c, cam.state(), 0))
    assert img.max() <= 0.5 + 1e-6
    assert base.max() > 0.5          # the clamp actually binds here
    # unclamped regions agree
    mask = base <= 0.5
    np.testing.assert_allclose(img[mask], base[mask], rtol=1e-6)
