"""Packet column counts on the real bounce-1 batch, for the bench output.

Computed ON the benched scene from exact schedule/stop data (counts, not
timings, so every platform agrees):

  tile_visited_cols_mean  columns a tile's sweep visits (lower bound:
                          schedule entries in front of the tile's
                          slowest ray stop)
  ray_needed_cols_mean    columns each ray individually needs
  packet_waste            visited/needed - the structural SIMT-style
                          overshoot of tile-granular sweeping
  sweep_pairs_g           ray-triangle pair tests the visited columns
                          represent (cols x TILE_RAYS x K)

The batch is cosine-scattered from true primary hits (bounce1_rays), the
batch every sweep measurement of this repository uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def bounce1_rays(scene, cfg, camera, n_rays: int):
    """The real bounce-1 batch: n_rays cosine-scattered rays from the
    primary hits of the first n_rays pixels (row-major) of frame 0.

    Rays whose primary ray missed are parked (origin 1e30), as the
    integrator parks dead lanes. Returns (o, d) f32[n_rays, 3].
    """
    from pathtracer.integrator import camera as cam_mod
    from pathtracer.kernels import packet
    from pathtracer.sampling import rng as rng_mod
    from pathtracer.utils import vmath

    accel = scene.clusters_fine if scene.clusters_fine is not None \
        else scene.clusters
    w, h = cfg.width, cfg.height
    cs = camera.state() if hasattr(camera, "state") else camera
    pix = jnp.arange(n_rays, dtype=jnp.int32) % (w * h)
    samp = jnp.zeros((n_rays,), jnp.uint32)

    @jax.jit
    def batch():
        o, d = cam_mod.generate_primary_rays(cs, w, h, cfg.fov_deg, pix,
                                             samp, 0)
        hit = packet.intersect_clusters(accel, o, d, 1e-3, 1e20,
                                        sort_rays=False)
        live = jnp.isfinite(hit.t)
        tri = jnp.maximum(hit.tri, 0)
        v0, v1, v2 = scene.tri_vertices(tri)
        gn = vmath.normalize(jnp.cross(v1 - v0, v2 - v0))
        gn = jnp.where(jnp.sum(gn * d, axis=-1, keepdims=True) > 0,
                       -gn, gn)
        p = o + hit.t[:, None] * d
        u1, u2 = rng_mod.uniform2(pix.astype(jnp.uint32), samp, 7, 0, 0)
        t_, b_ = vmath.onb(gn)
        r = jnp.sqrt(u1)
        phi = 2 * jnp.pi * u2
        local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                           jnp.sqrt(jnp.maximum(0.0, 1 - u1))], axis=-1)
        d2 = vmath.normalize(local[:, 0:1] * t_ + local[:, 1:2] * b_
                             + local[:, 2:3] * gn)
        o2 = jnp.where(live[:, None], p + gn * 1e-3,
                       jnp.full_like(p, 1e30))
        d2 = jnp.where(live[:, None], d2, jnp.array([[0.0, 0.0, 1.0]]))
        return o2, d2

    return jax.block_until_ready(batch())


def bounce1_pair_metrics(scene, cfg, camera, max_rays: int = 1 << 21):
    """Exact visited/needed column stats on the real bounce-1 batch.

    Returns a JSON-ready dict (see module docstring). Counts are exact
    data products of the schedule + stop rule, so every platform agrees.
    """
    from pathtracer.kernels import packet

    accel = scene.clusters_fine if scene.clusters_fine is not None \
        else scene.clusters
    tile_rays = packet.TILE_RAYS
    n = min(cfg.width * cfg.height, max_rays) // tile_rays * tile_rays
    k = accel.tris_per_cluster

    @jax.jit
    def schedule_stats(o2, d2):
        order, _ = packet._coherence_order(accel, o2, d2, 2)
        o_s, d_s = o2[order], d2[order]
        n_tiles = n // tile_rays
        tile_tnear = packet._tile_cull(accel, o_s, d_s, 1e-3, 1e20,
                                       n_tiles, tile_rays)
        st, _ = packet._sorted_schedule(tile_tnear, 1)
        hit = packet.intersect_clusters(accel, o_s, d_s, 1e-3, 1e20,
                                        sort_rays=False)
        cap = packet._scene_exit(accel, o_s, d_s, 1e20)
        best = jnp.minimum(
            jnp.where(jnp.isfinite(hit.t), hit.t, jnp.inf),
            cap).reshape(n_tiles, tile_rays)
        live = (o_s[:, 0] < 1e29).reshape(n_tiles, tile_rays)
        tile_live = jnp.any(live, axis=1)
        vis = jnp.sum(st < jnp.max(jnp.where(live, best, 0.0), axis=1,
                                   keepdims=True), axis=1)

        def need_block(args):
            st_b, best_b = args
            return jnp.sum(st_b[:, None, :] < best_b[:, :, None], axis=2)

        cb = 512
        pad = (-n_tiles) % cb
        st_p = jnp.concatenate(
            [st, jnp.full((pad, st.shape[1]), jnp.inf)], 0) if pad else st
        best_p = jnp.concatenate(
            [best, jnp.zeros((pad, tile_rays))], 0) if pad else best
        nb = st_p.shape[0] // cb
        need = jax.lax.map(
            need_block,
            (st_p.reshape(nb, cb, -1),
             best_p.reshape(nb, cb, tile_rays)))
        need = need.reshape(-1, tile_rays)[:n_tiles]
        return (jnp.where(tile_live, vis, 0),
                jnp.where(live, need, 0), tile_live, live)

    o2, d2 = bounce1_rays(scene, cfg, camera, n)
    vis, need, tile_live, live = jax.block_until_ready(
        schedule_stats(o2, d2))
    vis = np.asarray(vis)[np.asarray(tile_live)]
    need = np.asarray(need)[np.asarray(live)]
    if vis.size == 0 or need.size == 0:
        return {"error": "no live rays in bounce-1 batch"}

    visited_mean = float(vis.mean())
    needed_mean = float(need.mean())
    # per-ray columns the packet actually pays, amortized over live rays
    per_ray_paid = float(vis.sum()) * tile_rays / max(1, need.size)
    waste = per_ray_paid / max(1e-9, needed_mean)

    pairs = float(vis.sum()) * tile_rays * k
    return {
        "rays_probed": int(need.size),
        "tile_visited_cols_mean": round(visited_mean, 1),
        "ray_needed_cols_mean": round(needed_mean, 1),
        "packet_waste": round(waste, 2),
        "sweep_pairs_g": round(pairs / 1e9, 2),
        "tris_per_cluster": int(k),
    }
