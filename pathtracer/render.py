"""Top-level render API: frame rendering + progressive accumulation loop.

Replaces the reference's pipeline assembly + frame loop (main.cpp:407-731):
instead of descriptor sets, an SBT and `traceRaysKHR`, a frame is one jitted
function of (scene pytree, camera state, frame index); XLA compilation is
the pipeline build (SURVEY.md par.1 L5). The interactive swapchain loop
becomes the headless `Renderer` driver with camera-move accumulation resets
(main.cpp:662-731 semantics).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pathtracer import config as config_mod
from pathtracer import film as film_mod
from pathtracer.config import RenderConfig
from pathtracer.integrator import camera as cam_mod
from pathtracer.integrator import path as path_mod
from pathtracer.kernels import intersect as isect
from pathtracer.kernels import packet
from pathtracer.kernels import traverse
from pathtracer.scene.types import Scene


def make_intersectors(scene: Scene, cfg: RenderConfig):
    """Build (intersect_fn, occluded_fn) closures for the chosen backend.

    Both closures carry the route they run as `.backend`: "brute", "bvh",
    or the sweep route packet.resolve_backend picked for the cluster
    intersector ("triton" or "xla").
    """
    v0, v1, v2 = scene.tri_vertices(jnp.arange(scene.n_tris))
    # Tiny scenes: the packet machinery (sort + cull + schedule + sweep)
    # costs more than just testing every triangle densely.
    use_brute = (cfg.intersector == "brute"
                 or (cfg.intersector == "cluster" and scene.n_tris <= 256))
    if use_brute:
        def intersect_fn(o, d, t_min, t_max, primary=False):
            return isect.intersect_brute(o, d, v0, v1, v2, t_min, t_max)

        def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
            return isect.occluded_brute(o, d, t_max, v0, v1, v2,
                                        want_blocker=want_blocker)
    elif cfg.intersector == "cluster":
        if scene.clusters is None:
            raise ValueError(
                "cfg.intersector='cluster' but scene has no cluster accel; "
                "call accel.cluster.build_scene_clusters(scene) first")
        accel = scene.clusters
        accel_fine = scene.clusters_fine or accel
        backend = packet.resolve_backend(cfg.traversal_backend)
        # With integrator-owned wavefront sorting (path.py), rays arrive
        # already compacted + coherence-ordered: skip the packet layer's
        # per-chunk sorts entirely.
        sort_rays = (not cfg.wavefront_sort) and cfg.packet_sort

        def intersect_fn(o, d, t_min, t_max, primary=False):
            # Primary rays arrive in swizzled 8x8 pixel-block order, which
            # is already tighter than the coherence sort's bins, so they
            # skip the sort. Closest-hit calls traverse the fine accel;
            # PT_BOUNCE_ACCEL=morton sends bounce rays to the coarse one.
            import os

            a = accel if (not primary and os.environ.get(
                "PT_BOUNCE_ACCEL") == "morton") else accel_fine
            return packet.intersect_clusters(a, o, d, t_min, t_max,
                                             backend=backend,
                                             sort_rays=sort_rays
                                             and not primary)

        def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
            # Shadow rays traverse the coarse accel; PT_OCCL_ACCEL=fine
            # routes them through the fine one.
            import os

            a = accel_fine if os.environ.get(
                "PT_OCCL_ACCEL") == "fine" else accel
            return packet.occluded_clusters(a, o, d, t_max,
                                            backend=backend,
                                            sort_rays=sort_rays,
                                            want_blocker=want_blocker)
    else:
        if scene.bvh is None:
            raise ValueError(
                "cfg.intersector='bvh' but scene has no BVH; call "
                "accel.lbvh.build_scene_bvh(scene) first")
        # Packed once per frame; XLA CSEs the O(n) pack across all bounces.
        packed = traverse.pack_bvh(scene.bvh, scene.indices, scene.positions)

        def intersect_fn(o, d, t_min, t_max, primary=False):
            return traverse.intersect_packed(packed, o, d, t_min, t_max)

        def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
            blocked = traverse.occluded_packed(packed, o, d, t_max)
            if want_blocker:
                # BVH backend reports no blocker ids: hints stay empty
                # (priming then never accelerates, still exact).
                return blocked, jnp.full(o.shape[:1], -1, jnp.int32)
            return blocked

    intersect_fn.backend = occluded_fn.backend = (
        "brute" if use_brute else
        backend if cfg.intersector == "cluster" else "bvh")
    return intersect_fn, occluded_fn


# Pixel-block swizzle: consecutive lanes cover BLOCK_W x BLOCK_H pixel
# blocks, so each traversal tile (kernels/packet.TILE_RAYS rays) is a
# compact screen square instead of a scanline - tighter tile frusta,
# smaller cluster unions. Pure index math + reshapes; pixel ids keep their
# true row-major values so per-pixel RNG streams are swizzle-invariant.
BLOCK_W = 8
BLOCK_H = 8


def _swizzled_pixel_ids(w: int, h: int):
    """Flat pixel ids in (block_y, block_x, in_y, in_x) order, or None."""
    if w % BLOCK_W or h % BLOCK_H:
        return None
    ys = jnp.arange(h).reshape(h // BLOCK_H, BLOCK_H)
    xs = jnp.arange(w).reshape(w // BLOCK_W, BLOCK_W)
    y = ys[:, None, :, None]                       # [by, 1, iy, 1]
    x = xs[None, :, None, :]                       # [1, bx, 1, ix]
    return (y * w + x).reshape(-1).astype(jnp.int32)


def _render_sample_impl(scene, cfg, cam, frame_idx, s, prime,
                        want_gbuffer=False):
    intersect_fn, occluded_fn = make_intersectors(scene, cfg)
    w, h = cfg.width, cfg.height
    n = w * h
    swizzled = _swizzled_pixel_ids(w, h)
    pixel_ids = (swizzled if swizzled is not None
                 else jnp.arange(n, dtype=jnp.int32))
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)

    sample_ids = jnp.full(
        (n,), frame_idx * cfg.spp + jnp.asarray(s, jnp.uint32), jnp.uint32)
    o, d = cam_mod.generate_primary_rays(
        cam, w, h, cfg.fov_deg, pixel_ids, sample_ids, cfg.seed,
        cfg.sampler, aperture=cfg.aperture, focus_dist=cfg.focus_dist)
    radiance, pix_out, rays, prime_out, gbuf = path_mod.trace_paths(
        scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn, occluded_fn,
        prime=prime, want_gbuffer=want_gbuffer, sample_window=1)
    # Lanes come back in the last bounce's wavefront order; one scatter by
    # the riding pixel ids lands them row-major (this also absorbs the
    # un-swizzle of the pixel-block layout).
    img = jnp.zeros((n, 3), jnp.float32).at[pix_out].set(
        radiance, unique_indices=True)
    return img.reshape(h, w, 3), rays, prime_out, gbuf


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_sample(scene: Scene, cfg: RenderConfig,
                  cam: cam_mod.CameraState, frame_idx, s):
    """Render ONE sample per pixel: the unit device program.

    Returns (linear radiance f32[H, W, 3] of this sample, rays f32 scalar).
    Deterministic in (cfg.seed, frame_idx, s): the counter-based RNG keys
    every draw on (pixel, frame*spp + s, depth, use).
    """
    img, rays, _, _ = _render_sample_impl(scene, cfg, cam, frame_idx, s,
                                          None)
    return img, rays


@functools.partial(jax.jit, static_argnames=("cfg", "gbuffer"))
def render_sample_primed(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx, s, prime,
                         gbuffer: bool = False):
    """render_sample + verified priming (path.trace_paths).

    prime: i32[W*H, 3] previous sample's per-pixel hints (primary hit,
    bounce-0 NEE blocker, bounce-0 env-NEE blocker; -1 = none). Returns
    (radiance, rays, this sample's hints[, gbuf]) - chain across the spp
    loop. Same estimator as render_sample: predictions are re-verified,
    never trusted. gbuffer=True also returns the primary-hit G-buffer
    dict (normal/depth/albedo in pixel order) for the denoiser.
    """
    out = _render_sample_impl(scene, cfg, cam, frame_idx, s, prime,
                              want_gbuffer=gbuffer)
    return out if gbuffer else out[:3]


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_sample_gbuffer(scene: Scene, cfg: RenderConfig,
                          cam: cam_mod.CameraState, frame_idx, s):
    """render_sample + primary-hit G-buffer (no priming)."""
    img, rays, _, gbuf = _render_sample_impl(scene, cfg, cam, frame_idx, s,
                                             None, want_gbuffer=True)
    return img, rays, gbuf


@functools.partial(jax.jit,
                   static_argnames=("cfg", "gbuffer", "primed", "spp_eff",
                                    "split"))
def _trace_pool_part(scene: Scene, cfg: RenderConfig,
                     cam: cam_mod.CameraState, frame_idx, pix_part,
                     prime_part, spp_eff: int, gbuffer: bool,
                     primed: bool, split: bool):
    """Trace ALL spp_eff samples of one spatial pixel part as a wavefront.

    The jitted inner of render_frame_batched: one part = one XLA program,
    so multi-part pools never coexist in device memory. Returns the part's pixel-
    scattered radiance SUM [m, 3] in part-row order (split=True) or
    pixel order (single part), rays, hints and G-buffer rows.
    """
    w, h = cfg.width, cfg.height
    m = pix_part.shape[0]
    intersect_fn, occluded_fn = make_intersectors(scene, cfg)
    spp = cfg.spp
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)
    # sample-major lane order: s-th segment keeps the swizzled 8x8
    # pixel-block structure, so primary tiles stay compact screen squares
    pixel_ids = jnp.tile(pix_part, spp_eff)
    sample_ids = (frame_idx * spp
                  + jnp.repeat(jnp.arange(spp_eff, dtype=jnp.uint32), m))
    o, d = cam_mod.generate_primary_rays(
        cam, w, h, cfg.fov_deg, pixel_ids, sample_ids, cfg.seed,
        cfg.sampler, aperture=cfg.aperture, focus_dist=cfg.focus_dist)
    local = (jnp.tile(jnp.arange(m, dtype=jnp.int32), spp_eff)
             if split else None)
    radiance, pix_out, rays, prime_p, gbuf_p = path_mod.trace_paths(
        scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn,
        occluded_fn, prime=prime_part if primed else None,
        want_gbuffer=gbuffer, n_pixels=m, local_pix=local,
        sample_window=spp_eff)
    # spp lanes share a pixel: scatter-ADD (caller divides by spp).
    # Lanes may return permuted (cfg.wavefront_sort), so the part row
    # derives from the returned GLOBAL pixel ids via the inverse part
    # table, never from input lane order.
    if split:
        inv_part = jnp.zeros((w * h,), jnp.int32).at[pix_part].set(
            jnp.arange(m, dtype=jnp.int32))
        row = inv_part[pix_out]
    else:
        row = pix_out
    part_img = jnp.zeros((m, 3), jnp.float32).at[row].add(radiance)
    if gbuf_p is not None:
        lum = jnp.sum(radiance * jnp.asarray([0.2126, 0.7152, 0.0722]),
                      axis=-1)
        gbuf_p = dict(
            gbuf_p,
            m1=jnp.zeros((m,), jnp.float32).at[row].add(lum),
            m2=jnp.zeros((m,), jnp.float32).at[row].add(lum * lum))
    return part_img, rays, prime_p, gbuf_p


def render_frame_batched(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx,
                         prime=None, gbuffer: bool = False,
                         primed: bool = False, frames: int = 1):
    """Render ALL cfg.spp samples of `frames` frames as ONE wavefront.

    spp * frames * W * H lanes traced together (cfg.spp_batch /
    cfg.frame_batch): the coherence sort pools every sample's rays,
    which cuts the bounce sweep columns per ray (an exact count, see
    bench/pair_metrics.py), and the cross-frame pool extends that growth
    past the per-frame spp. The estimator is IDENTICAL to the per-sample
    loop - the RNG keys every draw on (pixel, frame*spp + s, depth, use)
    either way, and `frames` consecutive frames' sample indices are the
    contiguous range frame_idx*spp + [0, spp*frames) - only float
    summation order differs. Returns (SUM of the frames' mean radiance
    f32[H, W, 3] - accumulate with film.accumulate_many(..., frames) -
    rays, prime_out, gbuf) with gbuf carrying SVGF moments m1/m2 when
    gbuffer=True (also summed over frames; weight by `frames` in
    running means).
    """
    import os

    w, h = cfg.width, cfg.height
    n = w * h
    spp = cfg.spp
    spp_eff = spp * frames
    swizzled = _swizzled_pixel_ids(w, h)
    base_pix = (swizzled if swizzled is not None
                else jnp.arange(n, dtype=jnp.int32))
    if primed and prime is None:
        prime = jnp.full((n, 3), -1, jnp.int32)

    # The wavefront is capped at PT_MAX_WAVEFRONT lanes
    # (config.POOL_SATURATION_LANES) to bound the integrator's per-lane
    # state in device memory. The column win of sample batching comes
    # from lanes PER PIXEL (pool density), not total pool size, so the
    # pool splits into spatial PARTS along the swizzled lane order: each
    # part traces ALL spp_eff samples of a contiguous run of 8x8 pixel
    # blocks, as its own jitted XLA program (parts never coexist in
    # device memory).
    cap = int(os.environ.get("PT_MAX_WAVEFRONT",
                             str(config_mod.POOL_SATURATION_LANES)))
    parts = max(1, -(-(n * spp_eff) // cap))
    if parts == 1:
        part_img, rays, prime_out, gbuf = _trace_pool_part(
            scene, cfg, cam, frame_idx, base_pix, prime, spp_eff,
            gbuffer, primed, False)
        img = part_img / spp
        if gbuffer and gbuf is not None:
            m1 = gbuf.pop("m1") / spp
            m2 = gbuf.pop("m2") / spp
            gbuf = dict(gbuf, m1=m1.reshape(h, w), m2=m2.reshape(h, w))
        return img.reshape(h, w, 3), rays, prime_out, gbuf

    bounds = [n * p // parts for p in range(parts + 1)]
    img = jnp.zeros((n, 3), jnp.float32)
    rays = None
    prime_parts = []
    gb_parts = []
    for p in range(parts):
        a, b_ = bounds[p], bounds[p + 1]
        pix_part = base_pix[a:b_]
        part_img, rays_p, prime_p, gbuf_p = _trace_pool_part(
            scene, cfg, cam, frame_idx, pix_part,
            prime[pix_part] if primed else None, spp_eff, gbuffer,
            primed, True)
        img = img.at[pix_part].add(part_img, unique_indices=True)
        rays = rays_p if rays is None else rays + rays_p
        prime_parts.append(prime_p)
        gb_parts.append(gbuf_p)
    img = img / spp

    prime_out = None
    if primed:
        # parts partition the swizzled lane order; re-scatter their
        # row-local hint outputs back to pixel order
        lane_prime = jnp.concatenate(prime_parts, axis=0)
        prime_out = jnp.zeros((n, 3), jnp.int32).at[base_pix].set(
            lane_prime, unique_indices=True)
    gbuf = None
    if gbuffer and gb_parts and gb_parts[0] is not None:
        cat = {k: jnp.concatenate([g[k] for g in gb_parts], axis=0)
               for k in gb_parts[0]}
        unswz = lambda a: jnp.zeros(  # noqa: E731
            (n,) + a.shape[1:], a.dtype).at[base_pix].set(
                a, unique_indices=True)
        gbuf = {k: unswz(v) for k, v in cat.items()}
        m1 = gbuf.pop("m1") / spp
        m2 = gbuf.pop("m2") / spp
        # SVGF moments in (h, w) image layout, matching the spp loop
        gbuf = dict(gbuf, m1=m1.reshape(h, w), m2=m2.reshape(h, w))
    return img.reshape(h, w, 3), rays, prime_out, gbuf


def render_frame_with_stats(scene: Scene, cfg: RenderConfig,
                            cam: cam_mod.CameraState, frame_idx,
                            prime=None, return_prime: bool = False,
                            gbuffer: bool = False):
    """Render one frame's radiance estimate (mean of cfg.spp samples).

    HOST-level spp loop over per-sample programs: dispatches chain
    asynchronously on-device, each compiled program stays at one sample's
    size, and spp scales linearly.

    prime/return_prime: with cfg.primary_priming, the per-pixel primary
    hits chain across the spp loop AND (via the caller threading prime
    through successive frames, see Renderer.step) across the progressive
    loop - the camera is static between frames by construction
    (main.cpp:678-681 resets on movement), so the last sample's hits are
    a valid prediction for the next frame's first sample.
    """
    radiance = None
    rays = None
    gb = None
    want_gb = gbuffer and cfg.max_depth > 1
    priming = cfg.primary_priming and cfg.intersector == "cluster"
    if cfg.spp_batch and cfg.spp > 1:
        radiance, rays, prime_o, gb = render_frame_batched(
            scene, cfg, cam, frame_idx, prime=prime if priming else None,
            gbuffer=want_gb, primed=priming)
        if priming:
            prime = prime_o
        out = (radiance, rays)     # already the spp mean
        if return_prime:
            out = out + (prime,)
        if gbuffer:
            out = out + (gb,)
        return out
    for s in range(cfg.spp):
        if priming:
            if prime is None:
                prime = jnp.full((cfg.width * cfg.height, 3), -1,
                                 jnp.int32)
            out_s = render_sample_primed(scene, cfg, cam, frame_idx, s,
                                         prime, gbuffer=want_gb)
            if want_gb:
                r, k, prime, g = out_s
            else:
                r, k, prime = out_s
        elif want_gb:
            r, k, g = render_sample_gbuffer(scene, cfg, cam, frame_idx, s)
        else:
            r, k = render_sample(scene, cfg, cam, frame_idx, s)
        radiance = r if radiance is None else radiance + r
        rays = k if rays is None else rays + k
        if want_gb:
            # luminance moments of the per-sample estimate: the denoiser's
            # variance guide (SVGF) - E[l^2]-E[l]^2 over all samples
            lum = jnp.sum(r * jnp.asarray([0.2126, 0.7152, 0.0722]),
                          axis=-1)
            g = dict(g, m1=lum, m2=lum * lum)
            gb = g if gb is None else {n_: gb[n_] + g[n_] for n_ in gb}
    if gb is not None:
        gb = {n_: v / cfg.spp for n_, v in gb.items()}
    out = (radiance / cfg.spp, rays)               # raygen.rgen:297
    if return_prime:
        out = out + (prime,)
    if gbuffer:
        out = out + (gb,)
    return out


def render_frame(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                 frame_idx) -> jnp.ndarray:
    """Render one frame's linear radiance f32[H, W, 3]."""
    radiance, _ = render_frame_with_stats(scene, cfg, cam, frame_idx)
    return radiance


def render_step(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                film: film_mod.Film) -> film_mod.Film:
    """One progressive step: render at film.frame and fold into the film."""
    radiance = render_frame(scene, cfg, cam, film.frame.astype(jnp.uint32))
    return film_mod.accumulate(film, radiance)


class Renderer:
    """Headless progressive renderer - the frame-loop driver (main.cpp L7).

    Owns (scene, cfg, camera, film). `step()` renders one frame and
    accumulates; moving the camera resets accumulation (main.cpp:678-681).
    """

    def __init__(self, scene: Scene, cfg: RenderConfig,
                 camera: Optional[cam_mod.Camera] = None, mesh=None,
                 auto_frame_batch: int = 0, motion_preview: int = 0):
        if cfg.intersector == "bvh" and scene.bvh is None:
            from pathtracer.accel import lbvh

            scene = lbvh.build_scene_bvh(scene)
        if cfg.intersector == "cluster" and scene.clusters is None:
            from pathtracer.accel import cluster

            scene = cluster.build_scene_clusters(scene)
        self.scene = scene
        self.cfg = cfg
        self.camera = camera or cam_mod.Camera()
        # Optional jax.sharding.Mesh: frames render via shard_map over a
        # (tile, sample) device mesh (parallel/sharding.py). Priming and
        # the G-buffer/denoiser compose: hints and G-buffer rows shard
        # on the tile axis in lane order (render_frame_sharded).
        self.mesh = mesh
        self.film = film_mod.new_film(cfg.width, cfg.height)
        # primary-hit prediction chained across frames (cfg.primary_priming)
        self._prime = None
        # running-mean primary-hit G-buffer for the denoiser (cfg.denoise)
        self._gbuf = None
        self._gbuf_frames = 0
        # runtime display-filter toggle (the viewer flips it; the frozen
        # cfg stays the source of truth for G-buffer capture)
        self.denoise = cfg.denoise
        # runtime display-transform override (viewer 't' key cycles it;
        # cfg.tonemap stays the configured default)
        self.tonemap = cfg.tonemap
        # Adaptive cross-frame batching (viewer throughput mode): when
        # auto_frame_batch = F > 1, the step AFTER a camera move renders
        # one frame (latency - instant visual feedback), and every
        # static-camera step after that renders F frames' pools as one
        # wavefront. At interactive scales the per-frame pool is far
        # below config.POOL_SATURATION_LANES, so the joint pool cuts
        # swept columns AND amortizes per-step dispatch. Sample set (and
        # estimator) identical to F single steps; only float summation
        # order differs.
        self.auto_frame_batch = int(auto_frame_batch)
        self._frames_done = 0
        # Motion preview (viewer latency mode): with motion_preview =
        # s > 1, the step AFTER a camera move renders a 1-spp frame at
        # (W/s, H/s) instead of full resolution and display() upscales
        # it, so an s=2 preview cuts the moving-camera step ~4x in lanes.
        # The accumulation path is untouched: the preview never enters
        # the film, and the first static step renders full-res frame 1
        # exactly as before.
        self.motion_preview = int(motion_preview)
        self._preview = None
        # exact ray count of the last step (device scalar; None after a
        # preview or a mesh step, whose rays are not counted)
        self.last_rays = None

    def reset(self):
        self.film = film_mod.new_film(self.cfg.width, self.cfg.height)
        self._gbuf = None
        self._gbuf_frames = 0
        self._frames_done = 0
        # NOTE: self._prime is deliberately KEPT across camera moves -
        # hints are re-verified against the new rays, so stale ones cost
        # one cheap dense test and fresh ones (small motions leave most
        # pixels on the same surface) still shortcut traversal. Exactness
        # is camera-independent.

    def _step_preview(self) -> film_mod.Film:
        """Moving-camera step: low-res 1-spp preview, film untouched."""
        import dataclasses

        s = self.motion_preview
        w = max(16, (self.cfg.width // s) // 8 * 8)
        h = max(16, (self.cfg.height // s) // 8 * 8)
        # depth 3 is visually indistinguishable in a moving preview and
        # cuts the step's bounce work ~2x; the preview never enters the
        # film, so full-depth accuracy resumes with the first static
        # frame
        cfg_p = dataclasses.replace(
            self.cfg, width=w, height=h, spp=1, spp_batch=False,
            frame_batch=1, denoise=False, primary_priming=False,
            max_depth=min(3, self.cfg.max_depth))
        self._preview = render_frame(self.scene, cfg_p,
                                     self.camera.state(),
                                     jnp.uint32(0))
        return self.film

    def step(self) -> film_mod.Film:
        if self.camera.moved:
            self.reset()
            self.camera.moved = False
            # the preview also applies with a mesh: it is a tiny
            # single-device render (film and sharded state untouched),
            # so sharded interactive sessions keep move latency too
            if self.motion_preview > 1:
                return self._step_preview()
        self._preview = None
        self.last_rays = None
        if self.mesh is not None:
            from pathtracer.parallel import sharding

            want_gb = ((self.cfg.denoise or self.cfg.capture_gbuffer)
                   and self.cfg.max_depth > 1)
            priming = (self.cfg.primary_priming
                       and self.cfg.intersector == "cluster")
            if priming and self._prime is None:
                self._prime = jnp.full(
                    (self.cfg.width * self.cfg.height, 3), -1, jnp.int32)
            F = self.cfg.frame_batch
            if F == 1 and self.auto_frame_batch > 1 and self._frames_done > 0:
                # same adaptive policy as the single-chip branch below:
                # static camera => batched throughput step, post-move
                # step stays single-frame for latency
                F = self.auto_frame_batch
            out = sharding.render_frame_sharded(
                self.scene, self.cfg, self.camera.state(),
                self.film.frame.astype(jnp.uint32), self.mesh,
                prime=self._prime if priming else None,
                gbuffer=want_gb, return_aux=True, frames=F)
            radiance, prime_o, gb = out
            if priming:
                self._prime = prime_o
            if want_gb and gb is not None:
                gb = dict(gb, m1=gb["m1"] / F, m2=gb["m2"] / F)
                if self._gbuf is None:
                    self._gbuf = gb
                else:
                    k = self._gbuf_frames
                    self._gbuf = {n: (v * k + gb[n] * F) / (k + F)
                                  for n, v in self._gbuf.items()}
                self._gbuf_frames += F
            self.film = film_mod.accumulate_many(self.film, radiance, F)
            self._frames_done += F
            return self.film
        want_gb = ((self.cfg.denoise or self.cfg.capture_gbuffer)
                   and self.cfg.max_depth > 1)
        F = self.cfg.frame_batch
        if F == 1 and self.auto_frame_batch > 1 and self._frames_done > 0:
            # static camera + at least one frame shown: switch to the
            # batched wavefront (throughput mode); a camera move resets
            # _frames_done so the next step is a 1-frame latency step
            F = self.auto_frame_batch
        if F > 1:
            # cross-frame batched step: F frames' spp pools as
            # ONE wavefront; the film folds all their means at once
            priming = (self.cfg.primary_priming
                       and self.cfg.intersector == "cluster")
            radiance_sum, self.last_rays, prime_o, gb = render_frame_batched(
                self.scene, self.cfg, self.camera.state(),
                self.film.frame.astype(jnp.uint32),
                prime=self._prime if priming else None,
                gbuffer=want_gb, primed=priming, frames=F)
            if priming:
                self._prime = prime_o
            if want_gb and gb is not None:
                # moments come back SUMMED over the F frames; features
                # (normal/depth/albedo) are one primary winner's values
                gb = dict(gb, m1=gb["m1"] / F, m2=gb["m2"] / F)
                if self._gbuf is None:
                    self._gbuf = gb
                else:
                    k = self._gbuf_frames
                    self._gbuf = {n: (v * k + gb[n] * F) / (k + F)
                                  for n, v in self._gbuf.items()}
                self._gbuf_frames += F
            self.film = film_mod.accumulate_many(self.film, radiance_sum,
                                                 F)
            self._frames_done += F
            return self.film
        out = render_frame_with_stats(
            self.scene, self.cfg, self.camera.state(),
            self.film.frame.astype(jnp.uint32), prime=self._prime,
            return_prime=True, gbuffer=want_gb)
        if want_gb:
            radiance, self.last_rays, self._prime, gb = out
            if gb is not None:
                if self._gbuf is None:
                    self._gbuf = gb
                else:   # running mean, like the film accumulation
                    k = self._gbuf_frames
                    self._gbuf = {n: (v * k + gb[n]) / (k + 1)
                                  for n, v in self._gbuf.items()}
                self._gbuf_frames += 1
        else:
            radiance, self.last_rays, self._prime = out
        self.film = film_mod.accumulate(self.film, radiance)
        self._frames_done += 1
        return self.film

    def run(self, n_frames: int) -> film_mod.Film:
        # run() renders EXACTLY n_frames: adaptive batching (a viewer
        # latency/throughput policy) is suspended so the count is exact
        # and no extra per-F programs compile.
        saved = self.auto_frame_batch
        self.auto_frame_batch = 0
        try:
            for _ in range(n_frames):
                self.step()
        finally:
            self.auto_frame_batch = saved
        jax.block_until_ready(self.film.accum)
        return self.film

    def display(self) -> np.ndarray:
        """Tone-mapped current image (u8-ready f32 [H,W,3] in [0,1]).

        With cfg.denoise, the accumulated linear radiance is filtered by
        the edge-aware a-trous denoiser (film/denoise.py) before tone
        mapping; the film itself is never modified.
        """
        if self._preview is not None:
            # moving camera: nearest-upscale the low-res preview to the
            # display resolution (the terminal viewer re-downsamples to
            # character cells anyway, so nearest costs nothing visible)
            p = np.asarray(film_mod.to_display(self._preview,
                                               self.tonemap))
            ys = (np.arange(self.cfg.height) * p.shape[0]
                  ) // self.cfg.height
            xs = (np.arange(self.cfg.width) * p.shape[1]) // self.cfg.width
            return p[ys][:, xs]
        linear = self.film.accum
        if self.denoise and self._gbuf is not None:
            from pathtracer.film import denoise as dn

            h, w = self.cfg.height, self.cfg.width
            # variance of the MEAN estimate from the luminance moments:
            # (E[l^2] - E[l]^2) / n_samples over all spp x frames
            n_s = max(1, self._gbuf_frames * self.cfg.spp)
            # a 1-3 sample second moment is degenerate (var ~ 0 kills
            # every weight); fall back to the exposure-relative guide
            # until enough samples accumulated (SVGF's warmup problem)
            var = ((self._gbuf["m2"] - self._gbuf["m1"] ** 2) / n_s
                   if n_s >= 4 else None)
            linear = dn.atrous_denoise(
                linear,
                self._gbuf["normal"].reshape(h, w, 3),
                self._gbuf["depth"].reshape(h, w),
                self._gbuf["albedo"].reshape(h, w, 3),
                iterations=self.cfg.denoise_iterations,
                variance=var)
        return np.asarray(film_mod.to_display(linear, self.tonemap))

    def save_png(self, path: str):
        film_mod.write_png(path, self.display())

    def aovs(self) -> dict:
        """Display-ready AOVs from the primary-hit G-buffer.

        Returns {} until a frame rendered with G-buffer capture
        (cfg.denoise or cfg.capture_gbuffer). normal maps [-1,1] to
        [0,1]; depth is 1/(1+d) (sky -> 0); albedo is linear [0,1].
        """
        if self._gbuf is None:
            return {}
        h, w = self.cfg.height, self.cfg.width
        n = np.asarray(self._gbuf["normal"]).reshape(h, w, 3)
        d = np.asarray(self._gbuf["depth"]).reshape(h, w)
        a = np.asarray(self._gbuf["albedo"]).reshape(h, w, 3)
        return {
            "normal": np.clip(n * 0.5 + 0.5, 0.0, 1.0),
            "depth": np.repeat((1.0 / (1.0 + np.where(
                np.isfinite(d), d, np.inf)))[..., None], 3, axis=-1),
            "albedo": np.clip(a, 0.0, 1.0),
        }


def render_progressive(scene: Scene, cfg: RenderConfig,
                       camera: cam_mod.Camera, n_frames: int):
    """Convenience: run n_frames of progressive accumulation, return film."""
    r = Renderer(scene, cfg, camera)
    return r.run(n_frames)
