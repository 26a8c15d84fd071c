"""Packet (tile) traversal over the flat cluster accel.

The replacement for hardware BVH traversal (raygen.rgen:129, shadow walk
raygen.rgen:206-231). All control flow here is per-TILE (a tile =
TILE_RAYS consecutive rays), so every irregular access is amortized over
the whole tile:

1. **Coherence sort** - rays are sorted by direction bin + origin Morton
   code over the WHOLE wavefront so that a tile's rays want the same
   clusters; launches then proceed in chunks, and because dead lanes sort
   to the tail, fully-dead tail chunks skip entirely (the sort pool and
   the skip granule are decoupled). The sort/permute move only the
   [n, 7] ray arrays, never integrator state. Primary rays instead arrive
   unsorted in swizzled pixel-block order (render.py) - already tighter
   than any key.
2. **Dense cull** - slab-test every ray against every cluster AABB,
   reduced on the fly to a per-tile matrix `tile_tnear[tiles, C]` = min
   entry distance over the tile's rays that hit the cluster (inf where no
   ray hits). The "triton" route runs it as a Triton kernel
   (kernels/triton_cull.py), the "xla" route as plain XLA (_tile_cull).
3. **Sorted schedule** - each tile's cluster list is sorted near-to-far
   ONCE (lax.sort outside the loop); the sweep then just walks columns.
4. **Sweep** - two routes, named by `backend` (resolve_backend):
   "triton" runs each tile's sweep as one program of a Pallas Triton
   kernel (kernels/triton_sweep.py) with its own early exit; "xla" is a
   lockstep while_loop that opens CLUSTERS_PER_ITER columns per iteration
   with per-TILE block gathers and dense Moller-Trumbore. Exhausted
   columns re-test cluster 0: harmless (real intersections only ever
   refine the result) and keeps shapes static.
5. **Termination** - a tile stops when its nearest remaining cluster lies
   beyond every ray's current best hit, where best_t starts at the
   per-ray scene-exit distance (_scene_exit), not t_max - so miss rays
   stop at the scene bounds. Shadow sweeps stop when every lane is
   blocked.

Best-of-K extraction is argmin + iota-compare one-hot sums, and integer
payloads that travel with floats ride as float VALUES (exact below 2^24).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from pathtracer.accel.cluster import ClusterAccel
from pathtracer.kernels.intersect import DET_EPS, Hit

# Rays per tile (packet width): 64 = 8x8 pixel squares for the swizzled
# primary trace. Tuned on the previous accelerator; untested on the GPU.
TILE_RAYS = int(os.environ.get("PT_TILE_RAYS", "64"))
# Tiles per chunked launch. The coherence sort runs over the WHOLE
# wavefront (the sort pool is decoupled from the launch granule - see
# intersect_clusters), so the chunk is only the dead-lane SKIP GRANULE:
# after the global sort parks dead lanes at the tail, fully-dead tail
# chunks skip cull+schedule+sweep via the chunk_live lax.cond. Tuned on
# the previous accelerator; untested on the GPU.
CHUNK_TILES = int(os.environ.get("PT_CHUNK_TILES", "2048"))
# Clusters per block of the XLA cull and of _first_cluster (bounds the
# [tiles, R, CULL_BLOCK] transients). Untested on the GPU.
CULL_BLOCK = 256
FIRSTCLUSTER_RAY_BLOCK = 1 << 20   # rays per _first_cluster block (global
# sort scope sees the whole spp-batched wavefront - up to ~8M lanes -
# so the [rays, CULL_BLOCK] transients are bounded on BOTH axes)
CLUSTERS_PER_ITER = 2    # clusters each tile opens per XLA loop iteration

# The sweep route "auto" resolves to on each platform.
AUTO_BACKEND = {"gpu": "triton", "cpu": "xla"}
BACKENDS = ("triton", "xla")


def resolve_backend(backend: str, platform: str = None,
                    interpret: bool = False) -> str:
    """Name the sweep route for a traversal call, with no fallback.

    "auto" picks AUTO_BACKEND[platform] (platform defaults to JAX's
    default backend) and raises on a platform that has no route. "triton"
    compiles only for the GPU; elsewhere it needs interpret=True, which
    runs the kernel in the Pallas interpreter.
    """
    platform = platform or jax.default_backend()
    if backend == "auto":
        if platform not in AUTO_BACKEND:
            raise ValueError(
                f"no traversal backend for platform {platform!r}")
        return AUTO_BACKEND[platform]
    if backend not in BACKENDS:
        raise ValueError(f"unknown traversal backend: {backend!r}")
    if backend == "triton" and platform != "gpu" and not interpret:
        raise ValueError(
            f"the Triton sweep compiles only for the GPU, not {platform!r}; "
            "pass interpret=True to run it in the Pallas interpreter")
    return backend


def _safe_inv(d):
    tiny = 1e-20
    d_safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    return 1.0 / d_safe


def _like(ref, value, dtype):
    """Constant with data-dependence on `ref` (shard_map carry-type trick)."""
    return (ref * 0).astype(dtype) + jnp.asarray(value, dtype)


def _mixed_key(m, m_bits: int, d, dir_bits: int):
    """6D-interleaved coherence key (PT_KEY_SCHEME=mixed).

    The default key is direction-MAJOR: all 3*dir_bits direction bits
    above all origin-Morton bits, so a tile is tight in direction but
    its origins may span the whole scene at coarse direction bins. This
    variant interleaves the direction bits (themselves axis-interleaved,
    MSB first) evenly THROUGH the origin-Morton bits from the MSB down -
    a Bresenham merge of the two bit streams - so sorted neighbors are
    close in origin AND direction simultaneously. The top 32 bits of the
    merged stream form the u32 key (the dropped tail is origin detail
    far below 64-ray tile granularity).
    """
    db3 = 3 * dir_bits
    levels = jnp.float32((1 << dir_bits) - 1e-3)
    q = jnp.clip((d * 0.5 + 0.5) * levels, 0,
                 (1 << dir_bits) - 1).astype(jnp.uint32)
    md = jnp.zeros_like(q[:, 0])
    for i in range(dir_bits - 1, -1, -1):          # MSB first
        for ax in range(3):
            md = (md << jnp.uint32(1)) | ((q[:, ax] >> jnp.uint32(i))
                                          & jnp.uint32(1))

    total = m_bits + db3
    key = jnp.zeros_like(m)
    mi = di = 0                                    # bits consumed
    for pos in range(min(total, 32)):
        # Bresenham: emit a direction bit when its stream is behind its
        # even share of the merged prefix.
        if di * total <= pos * db3 and di < db3:
            bit = (md >> jnp.uint32(db3 - 1 - di)) & jnp.uint32(1)
            di += 1
        else:
            bit = (m >> jnp.uint32(m_bits - 1 - mi)) & jnp.uint32(1)
            mi += 1
        key = (key << jnp.uint32(1)) | bit
    return key


def _first_cluster(accel: ClusterAccel, o, d):
    """Per-ray nearest-cluster id + entry distance (the schedule prefix).

    argmin over clusters of the slab-test entry distance - i.e. the first
    cluster the ray's own near-to-far schedule would visit. Blocked over
    CULL_BLOCK clusters like _tile_cull; parked rays get id 0 / inf.
    Unlike the cull this runs at the GLOBAL sort scope (the whole
    wavefront, spp-batched up to ~8M lanes), so rays are ALSO blocked to
    bound the [rays, CULL_BLOCK] transients.
    """
    n = o.shape[0]
    ray_block = FIRSTCLUSTER_RAY_BLOCK

    def block(o, d):
        m = o.shape[0]
        inv = _safe_inv(d)
        c = accel.aabb_lo.shape[0]
        best_t = jnp.full((m,), jnp.inf, jnp.float32)
        best_i = jnp.zeros((m,), jnp.int32)
        for c0 in range(0, c, CULL_BLOCK):
            lo = accel.aabb_lo[c0:c0 + CULL_BLOCK]
            hi = accel.aabb_hi[c0:c0 + CULL_BLOCK]
            t1 = (lo[None, :, :] - o[:, None, :]) * inv[:, None, :]
            t2 = (hi[None, :, :] - o[:, None, :]) * inv[:, None, :]
            tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
            tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
            tn = jnp.where((tf >= jnp.maximum(tn, 0.0)) & (tf > 0.0),
                           jnp.maximum(tn, 0.0), jnp.inf)
            j = jnp.argmin(tn, axis=1)
            tj = tn[jnp.arange(m), j]
            better = tj < best_t
            best_t = jnp.where(better, tj, best_t)
            best_i = jnp.where(better, (c0 + j).astype(jnp.int32), best_i)
        return best_i, best_t

    if n <= ray_block:
        return block(o, d)
    outs = [block(o[r0:r0 + ray_block], d[r0:r0 + ray_block])
            for r0 in range(0, n, ray_block)]
    return (jnp.concatenate([x[0] for x in outs]),
            jnp.concatenate([x[1] for x in outs]))


def _coherence_key(accel: ClusterAccel, o, d, dir_bits: int = None,
                   scheme: str = None):
    """u32 coherence key per ray: direction bin + origin Morton.

    dir_bits = per-axis direction quantization bits: 1 = sign octant
    (8 bins), 2 = 64 bins, 3 = 512 bins. Defaults per call type were
    swept on the previous accelerator (untested on the GPU): closest-hit
    bounce rays take 3, occlusion rays 2 - shadow rays all aim at the
    lights, so direction carries less entropy than origin. Parked/dead
    lanes (origin >= 1e29) sort strictly last so they fill whole tiles
    (and whole chunks, which then skip via the chunk_live lax.cond).
    """
    import os

    from pathtracer.accel import morton as morton_mod

    if dir_bits is None:
        dir_bits = int(os.environ.get("PT_DIR_BITS", "2"))
    finite = accel.aabb_lo[:, 0] < 1e29           # skip pad clusters
    lo = jnp.min(jnp.where(finite[:, None], accel.aabb_lo, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(finite[:, None], accel.aabb_hi, -jnp.inf), axis=0)
    if dir_bits <= 1:
        dbin = ((d[:, 0] > 0).astype(jnp.uint32)
                + 2 * (d[:, 1] > 0).astype(jnp.uint32)
                + 4 * (d[:, 2] > 0).astype(jnp.uint32))
    else:
        levels = jnp.float32((1 << dir_bits) - 1e-3)
        q = jnp.clip((d * 0.5 + 0.5) * levels, 0,
                     (1 << dir_bits) - 1).astype(jnp.uint32)
        dbin = ((q[:, 0] << jnp.uint32(2 * dir_bits))
                | (q[:, 1] << jnp.uint32(dir_bits)) | q[:, 2])
    db = 3 * dir_bits
    m = morton_mod.morton_codes(o, lo=lo, hi=hi)  # 30-bit
    # per-call scheme override (occlusion batches take PT_KEY_SCHEME_OCCL
    # in occluded_clusters; the default for both is dirmajor), falling
    # back to the global env knob
    scheme = scheme or os.environ.get("PT_KEY_SCHEME", "dirmajor")
    if scheme == "mixed" and dir_bits >= 2:
        key = _mixed_key(m, 30, d, dir_bits)
    elif scheme == "firstcluster":
        # Key on the ray's own schedule PREFIX: rays sharing their first
        # visited cluster tile together (directly optimizes near-schedule
        # overlap instead of proxying through origin/direction bits).
        # first-cluster id (<= 11 bits at C <= 2048) major, then the
        # direction bin, then origin-Morton detail.
        fc, _ = _first_cluster(accel, o, d)
        cb = max(1, int(accel.aabb_lo.shape[0] - 1).bit_length())
        rest = max(0, 32 - cb - db)
        key = ((fc.astype(jnp.uint32) << jnp.uint32(32 - cb))
               | (dbin << jnp.uint32(rest))
               | (m >> jnp.uint32(30 - rest if rest < 30 else 0)))
    else:
        key = (dbin << jnp.uint32(32 - db)) | (m >> jnp.uint32(db - 2))
    key = jnp.where(o[:, 0] >= 1e29, jnp.uint32(0xFFFFFFFF), key)
    return key


def _coherence_order(accel: ClusterAccel, o, d, dir_bits: int = None,
                     scheme: str = None):
    """Sort permutation grouping rays by coherence key (see _coherence_key).

    Chunk-local argsort of u32 keys; all downstream permutes gather from
    chunk-sized (small) tables. Returns (order, inv_order).
    """
    key = _coherence_key(accel, o, d, dir_bits, scheme)
    order = jnp.argsort(key).astype(jnp.int32)
    # inverse permutation by scatter (inv[order[i]] = i): one scatter vs
    # a second full argsort of the same length
    n = order.shape[0]
    inv = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    return order, inv


def _sort_rays_by_key(key, o, d, t_max):
    """Coherence-sort rays with the payload RIDING the sort network.

    Permuting the [n, 7] ray rows by a gather after an argsort, and
    un-permuting the hit payload after the sweep, are two random-access
    passes; a multi-operand lax.sort moves the payload inside the sort
    network - no gather anywhere (PT_PERMUTE=gather restores the gathers). Returns (o, d, t_max, ridx) with
    ridx i32[n] = each sorted lane's ORIGINAL index; _unsort_by_ridx
    restores ray order by sorting on ridx (a permutation, so the sort is
    exact and collision-free).
    """
    n = o.shape[0]
    ridx = jnp.arange(n, dtype=jnp.int32)
    (_, o0, o1, o2, d0, d1, d2, tm, ridx) = jax.lax.sort(
        (key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         jnp.asarray(t_max, jnp.float32), ridx),
        dimension=0, num_keys=1)
    return (jnp.stack([o0, o1, o2], axis=1),
            jnp.stack([d0, d1, d2], axis=1), tm, ridx)


def _unsort_by_ridx(ridx, arrs):
    """Restore original ray order: sort payload arrays by original index.

    arrs: tuple of [n] arrays (f32/i32/bool); bools ride as i32. The
    inverse of _sort_rays_by_key at the same cost class (one sort
    network pass, no gathers).
    """
    casts = [a.dtype for a in arrs]
    ops = tuple(a.astype(jnp.int32) if a.dtype == jnp.bool_ else a
                for a in arrs)
    out = jax.lax.sort((ridx,) + ops, dimension=0, num_keys=1)[1:]
    return tuple(o.astype(dt) if dt == jnp.bool_ else o
                 for o, dt in zip(out, casts))


def _scene_exit(accel: ClusterAccel, o, d, t_max):
    """Per-ray exit distance from the scene root AABB (caps best_t).

    A hit can never lie beyond the root box exit, so rays that miss all
    geometry stop driving the sweep at the scene boundary instead of
    t_max = 1e20. Rays missing the root box entirely get ~0.
    """
    finite = accel.aabb_lo[:, 0] < 1e29
    lo = jnp.min(jnp.where(finite[:, None], accel.aabb_lo, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(finite[:, None], accel.aabb_hi, -jnp.inf), axis=0)
    inv_d = _safe_inv(d)
    t1 = (lo[None] - o) * inv_d
    t2 = (hi[None] - o) * inv_d
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    cap = jnp.clip(t_far * 1.0001 + 1e-3, 0.0, t_max)
    return jnp.broadcast_to(jnp.asarray(cap, jnp.float32), o.shape[:-1])


def _tile_cull(accel: ClusterAccel, o, d, t_min, t_max, n_tiles,
               tile_rays):
    """Dense per-ray slab test reduced to per-tile nearest-entry matrix.

    Returns tile_tnear f32[n_tiles, C]: min over the tile's hitting rays of
    the cluster entry distance; +inf where no ray in the tile hits. Blocked
    over the cluster axis so transients stay at [tiles, R, CULL_BLOCK].
    """
    inv_d = _safe_inv(d)
    ot = o.reshape(n_tiles, tile_rays, 1, 3)
    it = inv_d.reshape(n_tiles, tile_rays, 1, 3)
    tmx = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],)) \
        .reshape(n_tiles, tile_rays, 1)

    c = accel.aabb_lo.shape[0]
    pad = (-c) % CULL_BLOCK
    lo_all = accel.aabb_lo
    hi_all = accel.aabb_hi
    if pad:
        far = jnp.full((pad, 3), 1e30, jnp.float32)
        lo_all = jnp.concatenate([lo_all, far])
        hi_all = jnp.concatenate([hi_all, far])
    nb = lo_all.shape[0] // CULL_BLOCK
    lo_b = lo_all.reshape(nb, CULL_BLOCK, 3)
    hi_b = hi_all.reshape(nb, CULL_BLOCK, 3)

    def block(args):
        lo, hi = args
        t1 = (lo[None, None] - ot) * it
        t2 = (hi[None, None] - ot) * it
        t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)   # [tiles, R, B]
        t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= tmx)
        entry = jnp.where(hit, jnp.maximum(t_near, 0.0), jnp.inf)
        return jnp.min(entry, axis=1)                    # [tiles, B]

    if nb == 1:
        tile_tnear = block((lo_b[0], hi_b[0]))
    else:
        tile_tnear = jax.lax.map(block, (lo_b, hi_b))    # [nb, tiles, B]
        tile_tnear = jnp.moveaxis(tile_tnear, 0, 1) \
            .reshape(n_tiles, nb * CULL_BLOCK)
    return tile_tnear[:, :c]                             # [tiles, C]


def _cull_fn(cull: str, backend: str, interpret: bool = False):
    """The cull for a traversal call: per-ray slab test or tile frustum.

    The "triton" route runs the per-ray cull as a Triton kernel
    (kernels/triton_cull.py, bit-identical to _tile_cull): one program
    per tile keeps the slab test in registers, where XLA writes its
    [tiles, R, CULL_BLOCK] transients to memory between fusions.
    """
    if cull == "frustum":
        return _frustum_cull
    if backend != "triton":
        return _tile_cull

    def cull_triton(accel, o, d, t_min, t_max, n_tiles, tile_rays):
        from pathtracer.kernels import triton_cull

        return triton_cull.tile_cull(
            accel.aabb_lo, accel.aabb_hi, o, _safe_inv(d), t_max,
            t_min=t_min, n_tiles=n_tiles, tile_rays=tile_rays,
            interpret=interpret)
    return cull_triton


def _frustum_cull(accel: ClusterAccel, o, d, t_min, t_max, n_tiles,
                  tile_rays):
    """Conservative per-TILE interval slab test: [tiles, C] in one pass.

    Interval arithmetic over each tile's origin range and 1/direction range
    (mixed-sign direction axes widen to +-huge = conservative pass). ~50
    flops per (tile, cluster) - three orders of magnitude cheaper than the
    per-ray cull, at the price of looser tile_tnear (more false-positive
    cluster visits). The right trade once clusters are small.
    """
    inv_d = _safe_inv(d)
    ot = o.reshape(n_tiles, tile_rays, 3)
    it = inv_d.reshape(n_tiles, tile_rays, 3)
    o_lo = jnp.min(ot, axis=1)[:, None, :]     # [tiles, 1, 3]
    o_hi = jnp.max(ot, axis=1)[:, None, :]
    i_lo = jnp.min(it, axis=1)[:, None, :]
    i_hi = jnp.max(it, axis=1)[:, None, :]
    tmx = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    tmx = jnp.max(tmx.reshape(n_tiles, tile_rays), axis=1)   # [tiles]

    lo = accel.aabb_lo[None]                   # [1, C, 3]
    hi = accel.aabb_hi[None]

    def iprod(a_lo, a_hi):
        """Interval product (a_lo..a_hi) * (i_lo..i_hi): (lower, upper)."""
        p1 = a_lo * i_lo
        p2 = a_lo * i_hi
        p3 = a_hi * i_lo
        p4 = a_hi * i_hi
        return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

    t1_lo, t1_hi = iprod(lo - o_hi, lo - o_lo)          # [tiles, C, 3]
    t2_lo, t2_hi = iprod(hi - o_hi, hi - o_lo)
    near_lower = jnp.max(jnp.minimum(t1_lo, t2_lo), axis=-1)  # [tiles, C]
    far_upper = jnp.min(jnp.maximum(t1_hi, t2_hi), axis=-1)
    hit = ((near_lower <= far_upper) & (far_upper >= t_min)
           & (near_lower <= tmx[:, None]))
    return jnp.where(hit, jnp.maximum(near_lower, 0.0), jnp.inf)


def _sorted_schedule(tile_tnear, cpi):
    """Sort each tile's cluster list near-to-far ONCE, padded to cpi.

    The traversal loop then just slices consecutive columns - no per-
    iteration argmin/masking (small ops dominate loop-body cost on this
    platform). Returns (sorted_tnear, sorted_cids) f32/i32 [tiles, C'].
    Non-visited clusters stay +inf.
    """
    tiles, c = tile_tnear.shape
    pad = (-c) % cpi
    if pad:
        tile_tnear = jnp.concatenate(
            [tile_tnear, jnp.full((tiles, pad), jnp.inf, jnp.float32)],
            axis=1)
    # measured neutral on the previous accelerator (untested on the GPU);
    # kept as an option, default off (the f32 path has no quantization
    # semantics to reason about)
    if (os.environ.get("PT_SCHED_PACK", "0") != "0"
            and tile_tnear.shape[1] <= (1 << 12)):
        return _packed_schedule_sort(tile_tnear)
    ids = jnp.broadcast_to(
        jnp.arange(tile_tnear.shape[1], dtype=jnp.int32)[None, :],
        tile_tnear.shape)
    st, si = jax.lax.sort((tile_tnear, ids), dimension=1, num_keys=1)
    # pad ids point past C; clamp to 0 (harmless re-test of cluster 0)
    si = jnp.where(jnp.isfinite(st), si, 0)
    return st, si


def _packed_schedule_sort(tile_tnear):
    """One-operand u32 schedule sort: (quantized entry << 12) | cid.

    The (f32 key, i32 id) two-operand lax.sort moves twice the bytes
    through the sort network; entry distances only steer VISIT ORDER
    (a heuristic) and the closest kernel's early-out lower bound, so a
    20-bit FLOOR quantization is safe: the dequantized lower bound
    st_q <= true entry keeps the stop rule conservative (walks at most
    one extra quantum), and order-only tie flips are between equal-t
    duplicate references. Requires C' <= 4096 ids (caller checks).
    """
    tiles, c = tile_tnear.shape
    fin = jnp.isfinite(tile_tnear)
    mag = jnp.where(fin, tile_tnear, 0.0)
    scale = jnp.maximum(jnp.max(mag), 1e-20)
    maxq = (1 << 20) - 2
    q = jnp.minimum((mag * (maxq / scale)).astype(jnp.uint32),
                    jnp.uint32(maxq))
    key = jnp.where(fin,
                    (q << 12) | jnp.arange(c, dtype=jnp.uint32)[None, :],
                    jnp.uint32(0xFFFFFFFF))
    key = jax.lax.sort(key, dimension=1)
    valid = key != jnp.uint32(0xFFFFFFFF)
    qs = (key >> 12).astype(jnp.float32)
    # -1 quantum: f32 rounding in the quantize multiply may round a
    # bucket UP; the closest stop rule needs st <= true entry strictly
    qs = jnp.maximum(qs - 1.0, 0.0)
    st = jnp.where(valid, qs * (scale / maxq), jnp.inf)
    si = jnp.where(valid, (key & jnp.uint32(0xFFF)).astype(jnp.int32), 0)
    return st, si


def _mt_closest(block, o, d, t_min, t_max):
    """MT test of a tile's rays against its fetched cluster blocks.

    block: f32[tiles, Kc, 12]; o/d: f32[tiles, R, 3]; t_max: f32[tiles, R].
    Returns (t, u, v, tri_id) of the best hit per ray ([tiles, R] each).
    """
    v0 = block[:, None, :, 0:3]              # [tiles, 1, Kc, 3]
    e1 = block[:, None, :, 3:6]
    e2 = block[:, None, :, 6:9]
    # id+1 as float value (see accel/cluster.py: denormal-flush hazard)
    tid = jnp.round(block[:, :, 9]).astype(jnp.int32) - 1

    ob = o[:, :, None, :]                    # [tiles, R, 1, 3]
    db = d[:, :, None, :]
    pvec = jnp.cross(db, e2)
    det = jnp.sum(e1 * pvec, axis=-1)        # [tiles, R, Kc]
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / det, 0.0)
    tvec = ob - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(db * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = ((jnp.abs(det) > DET_EPS)
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max[:, :, None]))
    t = jnp.where(ok, t, jnp.inf)
    tj = jnp.min(t, axis=-1)                          # [tiles, R]
    j = jnp.argmin(t, axis=-1)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, t.shape, 2)
    sel = k_iota == j[..., None]
    self32 = sel.astype(jnp.float32)
    uj = jnp.sum(u * self32, axis=-1)
    vj = jnp.sum(v * self32, axis=-1)
    idj = jnp.sum(jnp.where(sel, tid[:, None, :], 0), axis=-1)
    idj = jnp.where(jnp.isfinite(tj), idj, -1)
    return tj, uj, vj, idj


def _mt_any_front(block, o, d, t_max, want_id=False):
    """Any front-facing hit below t_max (shadow policy raygen.rgen:214-218).

    want_id: also return i32[tiles, R] = id of SOME blocking triangle
    (-1 where none) - the shadow-priming hint.
    """
    v0 = block[:, None, :, 0:3]
    e1 = block[:, None, :, 3:6]
    e2 = block[:, None, :, 6:9]
    ob = o[:, :, None, :]
    db = d[:, :, None, :]
    pvec = jnp.cross(db, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / det, 0.0)
    tvec = ob - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(db * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    gn = jnp.cross(e1, e2)
    front = jnp.sum(db * gn, axis=-1) < 0.0
    ok = ((jnp.abs(det) > DET_EPS)
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0) & (t < t_max[:, :, None]) & front)
    any_ok = jnp.any(ok, axis=-1)                     # [tiles, R]
    if not want_id:
        return any_ok
    tid = jnp.round(block[:, :, 9]).astype(jnp.int32) - 1
    j = jnp.argmax(ok, axis=-1)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, ok.shape, 2)
    sel = k_iota == j[..., None]
    idj = jnp.sum(jnp.where(sel, tid[:, None, :], 0), axis=-1)
    return any_ok, jnp.where(any_ok, idj, -1)


def _fetch_blocks(accel, cids):
    """Gather + flatten CPI cluster blocks per tile: [tiles, CPI*K, 12]."""
    blk = accel.blocks[cids]                 # [tiles, CPI, K, 12]
    s = blk.shape
    return blk.reshape(s[0], s[1] * s[2], s[3])


def _unsort_hit(t, tri, u, v, n, inv):
    """Reshape + (optionally) invert the coherence sort with ONE gather."""
    if inv is None:
        return Hit(t=t.reshape(n), tri=tri.reshape(n), u=u.reshape(n),
                   v=v.reshape(n))
    # tri rides as a float VALUE (exact for ids < 2^24) so one gather
    # moves the whole packed hit.
    tri_f = tri.reshape(n).astype(jnp.float32)
    packed = jnp.stack(
        [t.reshape(n), tri_f, u.reshape(n), v.reshape(n)], axis=1)[inv]
    return Hit(
        t=packed[:, 0],
        tri=jnp.round(packed[:, 1]).astype(jnp.int32),
        u=packed[:, 2], v=packed[:, 3])


def _intersect_chunk(accel: ClusterAccel, t_min, sort_rays,
                     tile_rays, cpi, cull, backend="xla", dir_bits=None,
                     interpret=False):
    seg_min = t_min

    def run(rays):
        # Static-shape stream compaction, chunk level: when the integrator
        # compacts dead lanes to the wavefront tail (path.py wavefront_sort),
        # whole chunks of parked rays skip the cull + schedule + sweep via
        # a real branch (lax.cond executes one side).
        def dead(rays):
            z = (rays[0][:, 0] + rays[1][:, 0]) * 0.0
            return Hit(t=z + jnp.inf, tri=z.astype(jnp.int32) - 1,
                       u=z, v=z)

        return jax.lax.cond(chunk_live(rays[0]), _run_live, dead, rays)

    def _run_live(rays):
        o_in, d_in, tmax_in = rays
        n = o_in.shape[0]
        n_tiles = n // tile_rays
        ref = o_in[..., 0] + d_in[..., 0]

        if sort_rays:
            order, inv = _coherence_order(accel, o_in, d_in, dir_bits)
            odt = jnp.concatenate(
                [o_in, d_in, tmax_in[:, None]], axis=1)[order]
            o = odt[:, 0:3]
            d = odt[:, 3:6]
            t_max = odt[:, 6]
        else:
            o, d, t_max = o_in, d_in, tmax_in

        cull_fn = _cull_fn(cull, backend, interpret)
        tile_tnear = cull_fn(accel, o, d, seg_min, t_max, n_tiles,
                             tile_rays)
        ot = o.reshape(n_tiles, tile_rays, 3)
        dt = d.reshape(n_tiles, tile_rays, 3)

        t_cap = _scene_exit(accel, o, d, t_max).reshape(n_tiles, tile_rays)

        if backend == "triton":
            from pathtracer.kernels import triton_sweep

            st, si = _sorted_schedule(tile_tnear, 1)
            t, tri, u, v = triton_sweep.sweep_closest(
                st, si, triton_sweep.pack_rays(ot, dt, t_cap),
                accel.blocks_t, t_min, interpret=interpret)
            t = jnp.where(tri >= 0, t, jnp.inf)
            return _unsort_hit(t, tri, u, v, n, inv if sort_rays else None)

        st, si = _sorted_schedule(tile_tnear, cpi)
        n_cols = st.shape[1]

        state = (
            _like(ref[0], 0, jnp.int32),              # column cursor
            t_cap + _like(ref, 0.0, jnp.float32).reshape(n_tiles, tile_rays),
            _like(ref, -1, jnp.int32).reshape(n_tiles, tile_rays),
            _like(ref, 0.0, jnp.float32).reshape(n_tiles, tile_rays),
            _like(ref, 0.0, jnp.float32).reshape(n_tiles, tile_rays),
        )

        def cond(state):
            j, best_t, *_ = state
            # a tile is live while its next unvisited cluster could still
            # beat SOME ray's current best hit
            nearest = jax.lax.dynamic_slice_in_dim(st, j, 1, 1)[:, 0]
            return (j < n_cols) & jnp.any(
                nearest < jnp.max(best_t, axis=1))

        def body(state):
            j, best_t, best_tri, best_u, best_v = state
            cids = jax.lax.dynamic_slice_in_dim(si, j, cpi, 1)  # [tiles,cpi]

            block = _fetch_blocks(accel, cids)
            t, u, v, tri = _mt_closest(block, ot, dt, t_min, best_t)
            better = (t < best_t) & (tri >= 0)
            best_t = jnp.where(better, t, best_t)
            best_tri = jnp.where(better, tri, best_tri)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            return j + cpi, best_t, best_tri, best_u, best_v

        _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(
            cond, body, state)
        best_t = jnp.where(best_tri >= 0, best_t, jnp.inf)
        return _unsort_hit(best_t, best_tri, best_u, best_v, n,
                           inv if sort_rays else None)

    return run


def _occluded_chunk(accel: ClusterAccel, sort_rays, tile_rays, cpi, cull,
                    backend="xla", dir_bits=None, interpret=False,
                    want_blocker=False):
    def run(rays):
        def dead(rays):
            blocked = (rays[0][:, 0] + rays[1][:, 0]) * 0.0 > 1.0
            if want_blocker:
                return blocked, (rays[0][:, 0] * 0).astype(jnp.int32) - 1
            return blocked

        return jax.lax.cond(chunk_live(rays[0]), _run_live, dead, rays)

    def _run_live(rays):
        o_in, d_in, tmax_in = rays
        n = o_in.shape[0]
        n_tiles = n // tile_rays
        ref = o_in[..., 0] + d_in[..., 0]

        if sort_rays:
            order, inv = _coherence_order(
                accel, o_in, d_in, dir_bits,
                scheme=os.environ.get("PT_KEY_SCHEME_OCCL", "dirmajor"))
            odt = jnp.concatenate(
                [o_in, d_in, tmax_in[:, None]], axis=1)[order]
            o = odt[:, 0:3]
            d = odt[:, 3:6]
            t_max = odt[:, 6]
        else:
            o, d, t_max = o_in, d_in, tmax_in

        cull_fn = _cull_fn(cull, backend, interpret)
        tile_tnear = cull_fn(accel, o, d, 0.0, t_max, n_tiles,
                             tile_rays)
        ot = o.reshape(n_tiles, tile_rays, 3)
        dt = d.reshape(n_tiles, tile_rays, 3)
        tm = t_max.reshape(n_tiles, tile_rays)

        if backend == "triton":
            from pathtracer.kernels import triton_sweep

            st, si = _sorted_schedule(tile_tnear, 1)
            out = triton_sweep.sweep_occluded(
                st, si, triton_sweep.pack_rays(ot, dt, tm), accel.blocks_t,
                interpret=interpret, want_blocker=want_blocker)
            out = (out[0] > 0, out[1]) if want_blocker else out > 0
            out = jax.tree_util.tree_map(lambda x: x.reshape(n), out)
            if sort_rays:
                out = jax.tree_util.tree_map(lambda x: x[inv], out)
            return out

        st, si = _sorted_schedule(tile_tnear, cpi)
        n_cols = st.shape[1]

        state = (
            _like(ref[0], 0, jnp.int32),
            _like(ref, 0, jnp.int32).astype(bool).reshape(n_tiles, tile_rays),
            _like(ref, -1, jnp.int32).reshape(n_tiles, tile_rays),
        )

        def cond(state):
            j, blocked, _ = state
            nearest = jax.lax.dynamic_slice_in_dim(st, j, 1, 1)[:, 0]
            live = (nearest < jnp.inf) & jnp.any(~blocked, axis=1)
            return (j < n_cols) & jnp.any(live)

        def body(state):
            j, blocked, btri = state
            nearest = jax.lax.dynamic_slice_in_dim(st, j, 1, 1)[:, 0]
            live = (nearest < jnp.inf) & jnp.any(~blocked, axis=1)
            cids = jax.lax.dynamic_slice_in_dim(si, j, cpi, 1)

            block = _fetch_blocks(accel, cids)
            if want_blocker:
                newly, nid = _mt_any_front(block, ot, dt, tm,
                                           want_id=True)
                upd = newly & live[:, None] & ~blocked
                btri = jnp.where(upd, nid, btri)
            else:
                newly = _mt_any_front(block, ot, dt, tm)
            blocked = blocked | (newly & live[:, None])
            return j + cpi, blocked, btri

        _, blocked, btri = jax.lax.while_loop(cond, body, state)
        blocked = blocked.reshape(n)
        if want_blocker:
            btri = btri.reshape(n)
            if sort_rays:
                return blocked[inv], btri[inv]
            return blocked, btri
        if sort_rays:
            blocked = blocked[inv]
        return blocked

    return run


# Pad lanes are PARKED rays (origin at _PARK, unit direction, tmax 0):
# their results are sliced off, they never hit anything, and - unlike
# replicating lane 0 - they keep fully-padded chunks in the dead-chunk
# fast path (the lax.cond skip below).
_PARK = 1e30
_PAD_VALUES = (_PARK, 1.0, 0.0)


def _pad_rays(arrs, n, multiple):
    pad = (-n) % multiple
    if pad:
        arrs = tuple(
            jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], _PAD_VALUES[i],
                             a.dtype)])
            for i, a in enumerate(arrs))
    return arrs, n + pad


def chunk_live(o):
    """A chunk is live if ANY lane is not parked (origins < _PARK)."""
    return jnp.any(o[:, 0] < 1e29)


def _chunk_map(fn, rays, n, tile_rays, chunk_rays):
    """lax.map over fixed-size chunks of the ray axis."""
    chunk = chunk_rays
    (rays, total) = _pad_rays(rays, n, tile_rays)
    if total <= chunk:
        out = fn(rays)
        return jax.tree_util.tree_map(lambda x: x[:n], out)
    (rays, total) = _pad_rays(rays, total, chunk)
    c = total // chunk
    chunked = tuple(r.reshape((c, chunk) + r.shape[1:]) for r in rays)
    out = jax.lax.map(fn, chunked)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((total,) + x.shape[2:])[:n], out)


def intersect_clusters(accel: ClusterAccel, o, d, t_min, t_max,
                       sort_rays: bool = True, tile_rays: int = None,
                       cpi: int = None, chunk_rays: int = None,
                       cull: str = "ray", backend: str = "auto",
                       dir_bits: int = None,
                       interpret: bool = False) -> Hit:
    """Closest hit of rays o/d [N,3] via packet traversal.

    t_max may be a scalar or per-ray [N]. backend names the sweep route
    (resolve_backend); interpret=True runs the Triton kernel in the
    Pallas interpreter.
    """
    backend = resolve_backend(backend, interpret=interpret)
    if dir_bits is None:
        # 3 bits/axis with the fine (K=128) default clusters: tight cull
        # bounds make tile direction-tightness pay (re-sweep if cluster
        # granularity moves).
        dir_bits = int(os.environ.get("PT_CLOSEST_DB", "3"))
    tile_rays = tile_rays or TILE_RAYS
    cpi = cpi or CLUSTERS_PER_ITER
    chunk_rays = chunk_rays or CHUNK_TILES * TILE_RAYS
    n = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:-1])
    # Global coherence sort, chunked launches: the sort POOL (tile
    # quality) is the whole wavefront while the lax.map chunk stays the
    # dead-lane skip granule - the global sort parks dead lanes at the
    # tail, so fully-dead tail chunks skip via chunk_live. Only pays when
    # the wavefront actually splits into chunks.
    inv = None
    ridx = None
    if (sort_rays and n > chunk_rays
            and os.environ.get("PT_SORT_SCOPE", "global") == "global"):
        if os.environ.get("PT_PERMUTE", "sortnet") == "gather":
            order, inv = _coherence_order(accel, o, d, dir_bits)
            odt = jnp.concatenate([o, d, t_max[:, None]], axis=1)[order]
            o, d, t_max = odt[:, 0:3], odt[:, 3:6], odt[:, 6]
        else:
            key = _coherence_key(accel, o, d, dir_bits)
            o, d, t_max, ridx = _sort_rays_by_key(key, o, d, t_max)
        sort_rays = False
    hit = _chunk_map(
        _intersect_chunk(accel, t_min, sort_rays, tile_rays, cpi,
                         cull, backend, dir_bits, interpret),
        (o, d, t_max), n, tile_rays, chunk_rays)
    if ridx is not None:
        t, tri, u, v = _unsort_by_ridx(ridx, (hit.t, hit.tri, hit.u,
                                              hit.v))
        return Hit(t=t, tri=tri, u=u, v=v)
    if inv is None:
        return hit
    return _unsort_hit(hit.t, hit.tri, hit.u, hit.v, n, inv)


def occluded_clusters(accel: ClusterAccel, o, d, t_max,
                      sort_rays: bool = True, tile_rays: int = None,
                      cpi: int = None, chunk_rays: int = None,
                      cull: str = "ray", backend: str = "auto",
                      dir_bits: int = None, interpret: bool = False,
                      want_blocker: bool = False):
    """Any-hit (front-facing) visibility via packet traversal.

    want_blocker: also return i32[N] blocker-triangle hints (-1 open).
    backend/interpret as in intersect_clusters.
    """
    backend = resolve_backend(backend, interpret=interpret)
    if dir_bits is None:
        dir_bits = int(os.environ.get("PT_OCCL_DB", "2"))
    tile_rays = tile_rays or TILE_RAYS
    cpi = cpi or CLUSTERS_PER_ITER
    chunk_rays = chunk_rays or CHUNK_TILES * TILE_RAYS
    n = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:-1])
    # global sort pool + chunked skip granule (see intersect_clusters)
    inv = None
    ridx = None
    if (sort_rays and n > chunk_rays
            and os.environ.get("PT_SORT_SCOPE", "global") == "global"):
        scheme = os.environ.get("PT_KEY_SCHEME_OCCL", "dirmajor")
        if os.environ.get("PT_PERMUTE", "sortnet") == "gather":
            order, inv = _coherence_order(accel, o, d, dir_bits,
                                          scheme=scheme)
            odt = jnp.concatenate([o, d, t_max[:, None]], axis=1)[order]
            o, d, t_max = odt[:, 0:3], odt[:, 3:6], odt[:, 6]
        else:
            key = _coherence_key(accel, o, d, dir_bits, scheme=scheme)
            o, d, t_max, ridx = _sort_rays_by_key(key, o, d, t_max)
        sort_rays = False
    out = _chunk_map(
        _occluded_chunk(accel, sort_rays, tile_rays, cpi, cull, backend,
                        dir_bits, interpret, want_blocker),
        (o, d, t_max), n, tile_rays, chunk_rays)
    if ridx is not None:
        leaves, treedef = jax.tree_util.tree_flatten(out)
        return jax.tree_util.tree_unflatten(
            treedef, _unsort_by_ridx(ridx, tuple(leaves)))
    if inv is not None:
        out = jax.tree_util.tree_map(lambda x: x[inv], out)
    return out
