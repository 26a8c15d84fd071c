"""Multi-device rendering: shard_map over a (tile, sample) device mesh.

The reference has no cross-device story at all (SURVEY.md par.2.3: one
queue, one GPU, host-synced every frame). The scaling model is the
renderer's analog of data + "sequence" parallelism:

- **tile axis** (dp analog): the flat pixel/ray index space is sharded -
  each device traces its slice of the framebuffer. Rays are embarrassingly
  parallel; no communication needed.
- **sample axis** (the spp dimension): samples-per-pixel are sharded and
  reduced with a `psum` - the only collective in the whole renderer
  (SURVEY.md par.5 "Long-context": the final accumulation is the single
  cross-device reduction).

Scene + BVH are replicated (read-only, like the reference's single device-
local copies); the per-frame output is resharded/gathered by XLA from the
tile-sharded result. The mesh follows the algorithm alone: the cards of
one host are joined all to all (NVLink), so no device order is preferred.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pathtracer.config import RenderConfig
from pathtracer.integrator import camera as cam_mod
from pathtracer.integrator import path as path_mod
from pathtracer.kernels import packet
from pathtracer.render import make_intersectors, _swizzled_pixel_ids
from pathtracer.scene.types import Scene


def make_mesh(devices: Optional[Sequence] = None,
              tile: Optional[int] = None,
              sample: Optional[int] = None) -> Mesh:
    """Build a (tile, sample) mesh over the given devices.

    Default factorization: sample=2 if the device count is even else 1,
    everything else on the tile axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tile is None or sample is None:
        sample = 2 if n % 2 == 0 and n >= 2 else 1
        tile = n // sample
    assert tile * sample == n, (tile, sample, n)
    arr = np.asarray(devices).reshape(tile, sample)
    return Mesh(arr, axis_names=("tile", "sample"))


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "gbuffer", "return_aux",
                                    "frames"))
def render_frame_sharded(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx,
                         mesh: Mesh, prime=None, gbuffer: bool = False,
                         return_aux: bool = False, frames: int = 1):
    """Render one frame across the mesh. Returns radiance f32[H, W, 3].

    Bit-compatible with the single-chip `render_frame`: the counter-based
    RNG keys on (pixel, global sample) so the sharding layout does not
    change the estimate (determinism across layouts).

    prime: optional i32[n_pix, 3] per-PIXEL verified-hint columns
    (render.py render_frame_with_stats semantics). Hints shard on the
    tile axis in LANE order; each shard verifies its own slice, and the
    sample shards' hint outputs merge with a pmax (hints are verified-
    never-trusted, so ANY sample's prediction is exact by construction).
    gbuffer: also return the primary-hit G-buffer + SVGF moments for the
    denoiser, same dict layout as render_frame_batched. return_aux=True
    switches the return to (radiance, prime_out, gbuf).
    """
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    w, h = cfg.width, cfg.height
    n_pix = w * h
    if n_pix % n_tile != 0:
        raise ValueError(f"pixels {n_pix} not divisible by tile axis {n_tile}")
    if cfg.spp % n_sample != 0:
        raise ValueError(f"spp {cfg.spp} not divisible by sample axis "
                         f"{n_sample}")
    local_spp = cfg.spp // n_sample

    # 8x8 pixel-block swizzle, same as the single-chip path (render.py):
    # each shard's contiguous lane slice is then a run of compact screen
    # blocks, not scanlines - x4.9 fewer primary columns (an exact count).
    # Lanes ride TRUE pixel ids (RNG streams stay layout-invariant); the
    # inverse permutation maps returned pixel ids back to lane slots.
    sw = _swizzled_pixel_ids(w, h)
    pixel_ids = sw if sw is not None else jnp.arange(n_pix, dtype=jnp.int32)
    inv_perm = jnp.zeros((n_pix,), jnp.int32).at[pixel_ids].set(
        jnp.arange(n_pix, dtype=jnp.int32))
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)

    want_gb = gbuffer and cfg.max_depth > 1
    # hints ride in LANE order so the tile axis shards them with their
    # pixels (the swizzle makes pixel-id ranges and lane ranges disagree)
    prime_lane = prime[pixel_ids] if prime is not None else None
    lum_w = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)

    def shard_fn(scene, cam, frame_idx, pixel_ids_local, inv_perm,
                 prime_local):
        intersect_fn, occluded_fn = make_intersectors(scene, cfg)
        s_rank = jax.lax.axis_index("sample").astype(jnp.uint32)
        m = pixel_ids_local.shape[0]
        offset = jax.lax.axis_index("tile").astype(jnp.int32) * m
        radiance = jnp.zeros((m, 3), jnp.float32)
        lane_rows = jnp.arange(m, dtype=jnp.int32)
        prime_out = None
        gbuf = None
        # frames > 1 forces the batched wavefront even without
        # cfg.spp_batch (the Renderer's ADAPTIVE frame batching passes
        # frames=F with an unchanged cfg; the loop branch below renders
        # only ONE frame, which would under-credit accumulate_many's
        # F-frame fold)
        batched = (cfg.spp_batch or frames > 1) and local_spp * frames > 1
        if batched:
            # spp-batched shard wavefront (cfg.spp_batch):
            # the shard's local_spp samples (x frames frames, with
            # cfg.frame_batch) trace as ONE wavefront so the coherence
            # sort pools them - the same x1.49 bounce column win as
            # single-chip render_frame_batched, per shard. RNG keys are
            # (pixel, global sample) either way, so the estimate matches
            # the loop up to float summation order.
            lanes_pp = local_spp * frames
            pix_b = jnp.tile(pixel_ids_local, lanes_pp)
            # frame f's shard samples: (frame_idx+f)*spp + s_rank*local_spp
            # + [0, local_spp) - each repeated per pixel
            sids = (frame_idx * cfg.spp + s_rank * local_spp
                    + (jnp.arange(frames, dtype=jnp.uint32)[:, None]
                       * jnp.uint32(cfg.spp)
                       + jnp.arange(local_spp, dtype=jnp.uint32)[None, :]
                       ).reshape(-1))
            sample_ids = jnp.repeat(sids, m)
            o, d = cam_mod.generate_primary_rays(
                cam, w, h, cfg.fov_deg, pix_b, sample_ids, cfg.seed,
                cfg.sampler, aperture=cfg.aperture,
                focus_dist=cfg.focus_dist)
            r, pix_out, _, prime_o, gb = path_mod.trace_paths(
                scene, cfg, o, d, pix_b, sample_ids,
                intersect_fn, occluded_fn, prime=prime_local,
                want_gbuffer=want_gb, n_pixels=m,
                local_pix=jnp.tile(lane_rows, lanes_pp),
                sample_window=cfg.spp * frames)
            local = inv_perm[pix_out] - offset
            radiance = radiance.at[local].add(r)   # spp duplicates: ADD
            prime_out = prime_o
            if want_gb:
                lum = jnp.sum(r * lum_w, axis=-1)
                sel = s_rank == 0
                # features: ONE sample shard's winner (matches the
                # single-chip batched scatter's one-winner semantics);
                # moments: true sums over every sample
                gbuf = {
                    "normal": jnp.where(sel, gb["normal"], 0.0),
                    "depth": jnp.where(sel, gb["depth"], 0.0),
                    "albedo": jnp.where(sel, gb["albedo"], 0.0),
                    "m1": jnp.zeros((m,), jnp.float32).at[local].add(lum),
                    "m2": jnp.zeros((m,), jnp.float32).at[local].add(
                        lum * lum),
                }
        else:
            gb_acc = None
            for s in range(local_spp):
                gs = (frame_idx * cfg.spp + s_rank * local_spp
                      + jnp.uint32(s))
                sample_ids = jnp.full((m,), gs, jnp.uint32)
                o, d = cam_mod.generate_primary_rays(
                    cam, w, h, cfg.fov_deg, pixel_ids_local, sample_ids,
                    cfg.seed, cfg.sampler, aperture=cfg.aperture,
                    focus_dist=cfg.focus_dist)
                r, pix_out, _, prime_o, gb = path_mod.trace_paths(
                    scene, cfg, o, d, pixel_ids_local, sample_ids,
                    intersect_fn, occluded_fn, prime=prime_local,
                    want_gbuffer=want_gb, n_pixels=m,
                    local_pix=lane_rows, sample_window=1)
                if prime_local is not None:
                    # chain hints across the local spp loop, like the
                    # single-chip render_frame_with_stats
                    prime_local = prime_o
                    prime_out = prime_o
                # lanes return in wavefront order; scatter-add by lane
                # slot (inverse swizzle maps pixel id -> global lane,
                # minus this tile shard's lane offset)
                local = inv_perm[pix_out] - offset
                radiance = radiance.at[local].add(r, unique_indices=True)
                if want_gb:
                    lum = jnp.zeros((m,), jnp.float32).at[local].set(
                        jnp.sum(r * lum_w, axis=-1), unique_indices=True)
                    gb_s = dict(gb, m1=lum, m2=lum * lum)
                    gb_acc = gb_s if gb_acc is None else {
                        k: gb_acc[k] + gb_s[k] for k in gb_acc}
            gbuf = gb_acc
        # the one collective family: reduce the sample shards.
        radiance = jax.lax.psum(radiance, "sample") / cfg.spp
        out = (radiance,)
        if prime_local is not None:
            # any sample shard's hints are exact (verified-never-trusted);
            # pmax picks a valid one (-1 = none) without extra traffic
            out = out + (jax.lax.pmax(prime_out, "sample"),)
        if want_gb:
            gbuf = jax.tree_util.tree_map(
                lambda x: jax.lax.psum(x, "sample"), gbuf)
            if batched:
                # batched: features already one winner; moments are sums
                gbuf = dict(gbuf, m1=gbuf["m1"] / cfg.spp,
                            m2=gbuf["m2"] / cfg.spp)
            else:
                # loop: every field is a sum over all spp samples
                gbuf = {k: v / cfg.spp for k, v in gbuf.items()}
            out = out + (gbuf,)
        return out

    out_specs = (P("tile"),)
    if prime_lane is not None:
        out_specs = out_specs + (P("tile"),)
    if want_gb:
        out_specs = out_specs + ({k: P("tile") for k in
                                  ("normal", "depth", "albedo",
                                   "m1", "m2")},)
    # The varying-manual-axes checker runs wherever it can: every loop
    # carry in the integrator and the XLA traversal derives its varying
    # axes from the shard-varying ray arrays (the _like trick,
    # kernels/traverse.py / path.py "Carry inits"). A Pallas kernel body
    # does not carry those types (a lax.cond in the Triton sweep sees
    # mismatched branches), so the Triton route turns the check off.
    check_vma = (cfg.intersector != "cluster" or packet.resolve_backend(
        cfg.traversal_backend) != "triton")
    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P(),
                  P("tile") if prime_lane is not None else P()),
        out_specs=out_specs,
        check_vma=check_vma,
    )(scene, cam, frame_idx, pixel_ids, inv_perm, prime_lane)
    # shards return lane-order arrays; one global scatter un-swizzles
    # back to row-major (identity when no swizzle applied).
    img = jnp.zeros((n_pix, 3), jnp.float32).at[pixel_ids].set(
        sharded[0], unique_indices=True)
    img = img.reshape(h, w, 3)
    if not return_aux:
        return img
    k = 1
    prime_out = None
    gbuf = None
    if prime_lane is not None:
        prime_out = jnp.zeros((n_pix, 3), jnp.int32).at[pixel_ids].set(
            sharded[k], unique_indices=True)
        k += 1
    if want_gb:
        gb_lane = sharded[k]
        unswz = lambda a: jnp.zeros(  # noqa: E731
            (n_pix,) + a.shape[1:], a.dtype).at[pixel_ids].set(
                a, unique_indices=True)
        gbuf = {kk: unswz(v) for kk, v in gb_lane.items()}
        # display expects the SVGF moments in image layout (render.py)
        gbuf["m1"] = gbuf["m1"].reshape(h, w)
        gbuf["m2"] = gbuf["m2"].reshape(h, w)
    return img, prime_out, gbuf
