"""Multi-device sharding tests on the 8-virtual-CPU-device mesh.

SURVEY.md par.4.5 "distributed without a cluster": shard_map + psum logic
validated with forced host platform device count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel.lbvh import build_scene_bvh
from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.parallel.sharding import make_mesh, render_frame_sharded
from pathtracer.render import render_frame
from pathtracer.scene.procedural import cornell_box


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def setup():
    scene = build_scene_bvh(cornell_box().finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    # 16x16=256 pixels: divisible by tile=4; spp=2 divisible by sample=2
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="bvh")
    return scene, cam, cfg


def test_mesh_factorization():
    m = make_mesh(jax.devices()[:8])
    assert m.shape["tile"] * m.shape["sample"] == 8
    m = make_mesh(jax.devices()[:8], tile=8, sample=1)
    assert m.shape["tile"] == 8


def test_sharded_matches_single_chip(setup):
    """Sharding layout must not change the estimate (same RNG counters)."""
    scene, cam, cfg = setup
    mesh = make_mesh(jax.devices()[:8])  # tile=4, sample=2
    sharded = np.asarray(render_frame_sharded(scene, cfg, cam.state(), 0,
                                              mesh))
    single = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)


def test_sharded_different_layouts_agree(setup):
    scene, cam, cfg = setup
    m1 = make_mesh(jax.devices()[:8], tile=8, sample=1)
    m2 = make_mesh(jax.devices()[:8], tile=4, sample=2)
    a = np.asarray(render_frame_sharded(scene, cfg, cam.state(), 0, m1))
    b = np.asarray(render_frame_sharded(scene, cfg, cam.state(), 0, m2))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out = np.asarray(jax.block_until_ready(out))
    assert np.isfinite(out).all()


def test_sharded_swizzle_fallback_resolution(setup):
    """Resolutions not divisible by the 8x8 block still render correctly
    sharded (the swizzle falls back to row-major lane order)."""
    import dataclasses

    scene, cam, cfg = setup
    cfg12 = dataclasses.replace(cfg, width=12, height=12)
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)
    sharded = np.asarray(render_frame_sharded(scene, cfg12, cam.state(), 0,
                                              mesh))
    single = np.asarray(render_frame(scene, cfg12, cam.state(), 0))
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)


def test_sharded_spp_batch_matches_loop(setup):
    """cfg.spp_batch on the mesh: one wavefront per shard, same estimate."""
    import dataclasses

    scene, cam, cfg = setup
    cfg4 = dataclasses.replace(cfg, spp=4)
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)  # local_spp=2
    loop = np.asarray(render_frame_sharded(scene, cfg4, cam.state(), 0,
                                           mesh))
    batched = np.asarray(render_frame_sharded(
        scene, dataclasses.replace(cfg4, spp_batch=True), cam.state(), 0,
        mesh))
    np.testing.assert_allclose(batched, loop, rtol=1e-4, atol=1e-5)
    single = np.asarray(render_frame(scene, cfg4, cam.state(), 0))
    np.testing.assert_allclose(batched, single, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cluster_setup():
    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.scene.build import MaterialDesc
    from pathtracer.scene.procedural import icosphere

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    m = b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2), roughness=0.4))
    b.add_mesh(sv, sf, m)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster")
    return scene, cam, cfg


def test_sharded_priming_exact(cluster_setup):
    """Priming on the mesh is exact AND records hints (hints shard on
    the tile axis in lane order)."""
    import dataclasses

    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    rb = Renderer(scene, cfg, cam, mesh=mesh)
    rp = Renderer(scene, cfg_p, cam, mesh=mesh)
    rb.camera.moved = rp.camera.moved = False
    for _ in range(2):   # frame 2 is primed by frame 1's hints
        fb, fp = rb.step(), rp.step()
    np.testing.assert_allclose(np.asarray(fp.accum), np.asarray(fb.accum),
                               rtol=1e-5, atol=1e-6)
    assert rp._prime is not None
    assert int(jnp.max(rp._prime[:, 0])) >= 0   # primary hits recorded
    assert int(jnp.max(rp._prime[:, 1])) >= 0   # shadow blockers found


def test_sharded_gbuffer_matches_single_chip(cluster_setup):
    """The sharded G-buffer (loop branch: per-field spp sums) matches the
    single-chip one; the denoised display runs end to end on the mesh."""
    import dataclasses

    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)
    cfg_d = dataclasses.replace(cfg, denoise=True)
    rs = Renderer(scene, cfg_d, cam, mesh=mesh)
    r1 = Renderer(scene, cfg_d, cam)
    rs.camera.moved = r1.camera.moved = False
    rs.step(), r1.step()
    assert rs._gbuf is not None and r1._gbuf is not None
    for k in ("normal", "depth", "albedo", "m1", "m2"):
        a, b = np.asarray(rs._gbuf[k]), np.asarray(r1._gbuf[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(rs.display()),
                               np.asarray(r1.display()),
                               rtol=1e-4, atol=1e-5)


def test_sharded_gbuffer_frame_batch_local_spp_one(cluster_setup):
    """G-buffer on the batched sharded path with local_spp == 1 (spp 2
    over a sample=2 axis, frame_batch 2): features must come through as
    the one-winner values UNDIVIDED (regression: the normalization used
    to key on cfg.spp_batch and local_spp > 1, which disagreed with the
    branch taken and divided normal/depth/albedo by spp)."""
    import dataclasses

    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)  # local_spp=1
    cfg_f = dataclasses.replace(cfg, denoise=True, spp_batch=True,
                                frame_batch=2)
    rs = Renderer(scene, cfg_f, cam, mesh=mesh)
    r1 = Renderer(scene, cfg_f, cam)
    rs.camera.moved = r1.camera.moved = False
    rs.step(), r1.step()
    assert int(rs.film.frame) == int(r1.film.frame) == 2
    # moments are true sums -> exact across layouts
    for k in ("m1", "m2"):
        np.testing.assert_allclose(np.asarray(rs._gbuf[k]),
                                   np.asarray(r1._gbuf[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # features: the duplicate-writer WINNER is unspecified per scatter
    # (path.py primary G-buffer comment), so exact equality cannot be
    # pinned at AA edges; pin the scaling invariants the /spp
    # double-division broke instead: hit normals unit-length, sky
    # albedo exactly neutral 1
    normal = np.asarray(rs._gbuf["normal"])
    depth = np.asarray(rs._gbuf["depth"])
    albedo = np.asarray(rs._gbuf["albedo"])
    hit = np.isfinite(depth)
    assert hit.any()
    nn = np.linalg.norm(normal[hit], axis=-1)
    np.testing.assert_allclose(nn, 1.0, rtol=1e-4, err_msg="unit normal")
    if (~hit).any():
        np.testing.assert_allclose(albedo[~hit], 1.0, rtol=1e-6,
                                   err_msg="sky albedo neutral")
    # the film itself stays exact across layouts
    np.testing.assert_allclose(np.asarray(rs.film.accum),
                               np.asarray(r1.film.accum),
                               rtol=1e-4, atol=1e-5)


def test_sharded_frame_batch_matches_progressive(cluster_setup):
    """frames=F on the mesh: one batched sharded step == F sharded
    steps' accumulation (cfg.frame_batch across the sample shards)."""
    import dataclasses

    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)
    cfg_b = dataclasses.replace(cfg, spp_batch=True)
    cfg_f = dataclasses.replace(cfg_b, frame_batch=2)
    r1 = Renderer(scene, cfg_b, cam, mesh=mesh)
    r2 = Renderer(scene, cfg_f, cam, mesh=mesh)
    r1.camera.moved = r2.camera.moved = False
    r1.step(), r1.step()
    r2.step()
    assert int(r1.film.frame) == int(r2.film.frame) == 2
    np.testing.assert_allclose(np.asarray(r2.film.accum),
                               np.asarray(r1.film.accum),
                               rtol=1e-4, atol=1e-5)
    # and the sharded batched step matches the single-chip batched step
    r3 = Renderer(scene, cfg_f, cam)
    r3.camera.moved = False
    r3.step()
    np.testing.assert_allclose(np.asarray(r2.film.accum),
                               np.asarray(r3.film.accum),
                               rtol=1e-4, atol=1e-5)


def test_sharded_auto_frame_batch_matches_single_steps(cluster_setup):
    """Renderer(mesh=..., auto_frame_batch=F): the adaptive interactive
    policy applies on the sharded path too (ADVICE r4: it used to be
    silently inert with --mesh) — post-construction/post-move step is 1
    frame for latency, static steps fold F frames, and the film matches
    single-frame sharded stepping at the same frame count."""
    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)
    ra = Renderer(scene, cfg, cam, mesh=mesh, auto_frame_batch=3)
    ra.camera.moved = False
    ra.step()                                     # latency step: 1 frame
    assert int(ra.film.frame) == 1
    ra.step()                                     # throughput step: 3
    assert int(ra.film.frame) == 4

    rb = Renderer(scene, cfg, Camera(position=(0.5, 0.5, 2.2)), mesh=mesh)
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


def test_sharded_env_nee_frame_batch(cluster_setup):
    """Env-NEE (importance sampling + the r5 per-(cell,sample) dedup
    table, whose window sizes off spp*frames) composes with frames>1 on
    the mesh: one 2-frame batched sharded step == two progressive
    sharded steps == the single-chip batched step."""
    import dataclasses

    from pathtracer.accel.cluster import build_scene_clusters
    from pathtracer.render import Renderer
    from pathtracer.scene.procedural import cornell_box

    b = cornell_box(materials_suite=True)
    env = np.zeros((32, 64, 3), np.float32)
    env[:16] = (0.4, 0.5, 0.8)
    env[20:24, 30:34] = 50.0
    b.set_envmap(env)
    scene = build_scene_clusters(b.finalize())
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster", sky="envmap",
                       env_importance_sampling=True, spp_batch=True)
    cfg_f = dataclasses.replace(cfg, frame_batch=2)
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)

    rb = Renderer(scene, cfg_f, cam, mesh=mesh)
    rp = Renderer(scene, cfg, Camera(position=(0.5, 0.5, 2.2)), mesh=mesh)
    rp.camera.look_at((0.5, 0.5, 0.0))
    rb.camera.moved = rp.camera.moved = False
    rb.step()
    rp.step(), rp.step()
    assert int(rb.film.frame) == int(rp.film.frame) == 2
    np.testing.assert_allclose(np.asarray(rb.film.accum),
                               np.asarray(rp.film.accum),
                               rtol=1e-4, atol=1e-5)

    r1 = Renderer(scene, cfg_f, Camera(position=(0.5, 0.5, 2.2)))
    r1.camera.look_at((0.5, 0.5, 0.0))
    r1.camera.moved = False
    r1.step()
    np.testing.assert_allclose(np.asarray(rb.film.accum),
                               np.asarray(r1.film.accum),
                               rtol=1e-4, atol=1e-5)


def test_sharded_motion_preview(cluster_setup):
    """Motion preview composes with a mesh: the moving-camera step is a
    tiny single-device render (film untouched), and the first static
    step resumes SHARDED accumulation identically to a no-preview
    sharded renderer after the same move."""
    from pathtracer.render import Renderer

    scene, cam, cfg = cluster_setup
    mesh = make_mesh(jax.devices()[:8], tile=4, sample=2)

    def fresh_cam():
        c = Camera(position=(0.5, 0.5, 2.2))
        c.look_at((0.5, 0.5, 0.0))
        return c

    r = Renderer(scene, cfg, fresh_cam(), mesh=mesh, motion_preview=2)
    r.camera.process_mouse(10.0, 0.0)
    film = r.step()                         # preview step
    assert int(film.frame) == 0
    assert r._preview is not None
    assert r.display().shape == (cfg.height, cfg.width, 3)
    film = r.step()                         # static: real sharded frame
    assert int(film.frame) == 1
    assert r._preview is None

    r2 = Renderer(scene, cfg, fresh_cam(), mesh=mesh)
    r2.camera.process_mouse(10.0, 0.0)
    r2.step()
    np.testing.assert_allclose(np.asarray(r.film.accum),
                               np.asarray(r2.film.accum),
                               rtol=1e-5, atol=1e-6)


def test_sharded_dof_matches_single_chip(cluster_setup):
    """Thin-lens DoF threads through the sharded path identically (the
    lens draw keys on (pixel, sample) like every other stream)."""
    import dataclasses

    import numpy as np

    from pathtracer.parallel.sharding import make_mesh, render_frame_sharded
    from pathtracer.render import render_frame

    scene, cam, cfg = cluster_setup
    dcfg = dataclasses.replace(cfg, aperture=0.3, focus_dist=2.0)
    single = np.asarray(render_frame(scene, dcfg, cam.state(), 0))
    mesh = make_mesh(jax.devices("cpu")[:8], tile=4, sample=2)
    sharded = np.asarray(
        render_frame_sharded(scene, dcfg, cam.state(), 0, mesh))
    np.testing.assert_allclose(sharded, single, rtol=2e-5, atol=2e-5)


def test_sharded_triton_route_matches_single_chip(cluster_setup,
                                                  monkeypatch):
    """The GPU route (Triton cull + sweep) inside shard_map, its kernels in
    the Pallas interpreter: the mesh must not change the estimate."""
    from pathtracer.kernels import packet, triton_cull, triton_sweep

    monkeypatch.setattr(packet, "resolve_backend",
                        lambda backend, platform=None, interpret=False:
                        "triton")
    for mod, name in ((triton_sweep, "sweep_closest"),
                      (triton_sweep, "sweep_occluded"),
                      (triton_cull, "tile_cull")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, **k: _fn(
            *a, **{**k, "interpret": True}))
    scene, cam, cfg = cluster_setup
    import dataclasses

    cfg = dataclasses.replace(cfg, spp=4, spp_batch=True)
    mesh = make_mesh(jax.devices()[:4], tile=2, sample=2)
    sharded = np.asarray(render_frame_sharded(scene, cfg, cam.state(), 0,
                                              mesh))
    single = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    assert np.isfinite(sharded).all() and sharded.mean() > 0
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)
