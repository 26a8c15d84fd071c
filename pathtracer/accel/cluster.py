"""Cluster acceleration structure for packet (tile) traversal.

The replacement for the driver-built BVH (core/accel.h:21-45), built on
one hypothesis about wide vector machines: dense ray-AABB slab tests are
cheap, gathers of WIDE rows from SMALL tables are fast, and per-ray
pointer chasing through large tables is slow. So the spatial index stays
SMALL and FLAT (a few thousand clusters), is tested densely, and triangle
data is fetched in large per-TILE blocks instead of per-ray pointers.

Build (all jittable XLA ops, runs on-device - the "driver" is XLA):
1. Morton-sort triangles by centroid (accel/morton.py), so consecutive
   triangles are spatially local.
2. Chunk the sorted order into clusters of K triangles (K chosen so the
   cluster count C <= max_clusters). Cluster AABBs are reshape+min/max.
3. Pre-bake each cluster's triangles as one wide row:
   [C, K, 12] f32 = (v0, e1, e2, orig_tri_id + 1, pad2) per triangle -
   the Moller-Trumbore-ready layout fetched per (tile, cluster) visit.

Padding triangles are placed at +1e30 with zero edges: their AABB never
passes a slab test against any finite ray segment and their determinant is
exactly 0, so they can never produce hits.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

from pathtracer.accel import morton as morton_mod
from pathtracer.scene.types import Scene

_PAD_POS = 1e30


def _choose_k(n_tris: int, max_clusters: int, min_k: int = 128) -> int:
    """Smallest power-of-two cluster size >= min_k with <= max_clusters.

    min_k defaults to 128: the sweep loads one [16, K] block per visit
    and tests it as a dense [R, K] vector op, so a small K only adds
    per-visit overhead.
    """
    k = min_k
    while (n_tris + k - 1) // k > max_clusters:
        k *= 2
    return k


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterAccel:
    """Flat two-level accel: C cluster AABBs + pre-baked triangle blocks."""

    aabb_lo: jnp.ndarray   # f32 [C, 3]
    aabb_hi: jnp.ndarray   # f32 [C, 3]
    blocks: jnp.ndarray    # f32 [C, K, 12]: v0, e1, e2, tri_id+1, pad, pad
    # Component-major Baldwin-Weber copy for the sweep kernel
    # (kernels/triton_sweep.py): triangles on the last axis, one [16, K]
    # block loaded per (tile, cluster) visit. Rows 0-2 n = e1 x e2, row 3
    # plane offset d, rows 4-7 r1/c1, rows 8-11 r2/c2, row 12 tri_id+1
    # (as a float VALUE), rows 13-15 v0 (see _finish_build).
    blocks_t: jnp.ndarray  # f32 [C, 16, K]

    @property
    def n_clusters(self) -> int:
        return self.aabb_lo.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.blocks.shape[1]


def _median_order(centroids, n_segments: int, axis_mode: str = "longest"):
    """Recursive median-split (k-d) ordering over equal-size segments.

    log2(n_segments) rounds; each round picks a split axis per segment
    and sorts the segment's contents along it (two-key lax.sort: segment
    id, then coordinate). Consecutive K-blocks of the result are
    median-split clusters - much tighter AABBs than fixed Morton chunks.
    Pad centroids (1e30) sort to segment tails.

    axis_mode: "longest" = each segment's longest centroid-extent axis
    (1 sort/round); "sa" = SAH-lite - evaluate the median split on ALL
    three axes and keep the one minimizing the children's summed AABB
    surface area (4 sorts/round).
    """
    n = centroids.shape[0]            # n % n_segments == 0; both pow2
    levels = n_segments.bit_length() - 1
    order = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)

    def child_sa(ordered, nseg, s):
        """Summed child-AABB surface area per segment after a median cut."""
        ca = centroids[ordered]
        va = (ca[:, 0] < 1e29)[:, None]
        cs2 = ca.reshape(nseg * 2, s // 2, 3)
        vs2 = va.reshape(nseg * 2, s // 2, 1)
        lo2 = jnp.min(jnp.where(vs2, cs2, jnp.inf), axis=1)
        hi2 = jnp.max(jnp.where(vs2, cs2, -jnp.inf), axis=1)
        e = jnp.nan_to_num(hi2 - lo2, neginf=0.0, posinf=0.0)
        sa = e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2]
        return sa.reshape(nseg, 2).sum(axis=1)

    for lvl in range(levels):
        nseg = 1 << lvl
        s = n // nseg
        c = centroids[order]
        valid = (c[:, 0] < 1e29)[:, None]
        seg = pos // s
        if axis_mode == "sa" and s >= 2:
            costs = []
            for a in range(3):
                coord = jnp.where(valid[:, 0], c[:, a], jnp.inf)
                _, _, ord_a = jax.lax.sort((seg, coord, order), num_keys=2)
                costs.append(child_sa(ord_a, nseg, s))
            axis = jnp.argmin(jnp.stack(costs, axis=1), axis=1)  # [nseg]
        else:
            cs = c.reshape(nseg, s, 3)
            vs = valid.reshape(nseg, s, 1)
            lo = jnp.min(jnp.where(vs, cs, jnp.inf), axis=1)
            hi = jnp.max(jnp.where(vs, cs, -jnp.inf), axis=1)
            ext = jnp.nan_to_num(hi - lo, neginf=0.0, posinf=0.0)
            axis = jnp.argmax(ext, axis=1)                       # [nseg]
        ax_per = jnp.repeat(axis, s)
        coord = jnp.take_along_axis(c, ax_per[:, None], axis=1)[:, 0]
        coord = jnp.where(valid[:, 0], coord, jnp.inf)
        _, _, order = jax.lax.sort((seg, coord, order), num_keys=2)
    return order


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _box_area(lo, hi):
    """Summed-face AABB surface-area proxy (numpy, broadcasting)."""
    import numpy as np

    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
        + e[..., 0] * e[..., 2]


def _binned_object_best(cen, lo_rows, hi_rows, n_bins):
    """Best binned-SAH object split over the 3 axes (shared by the leaf
    builders; the C++ port in native/pathtracer_native.cpp mirrors this
    exact cost model - keep them in sync).

    cen/lo_rows/hi_rows: f32[n, 3] row centroids and row AABBs.
    Returns (cost, mask_left) or None (degenerate centroid box).
    """
    import numpy as np

    n = cen.shape[0]
    clo, chi = cen.min(axis=0), cen.max(axis=0)
    ext = chi - clo
    best = None
    for ax in range(3):
        if ext[ax] <= 0:
            continue
        b = np.minimum(((cen[:, ax] - clo[ax])
                        * (n_bins / ext[ax])).astype(np.int32),
                       n_bins - 1)
        cnt = np.bincount(b, minlength=n_bins)
        blo = np.full((n_bins, 3), np.inf, np.float32)
        bhi = np.full((n_bins, 3), -np.inf, np.float32)
        np.minimum.at(blo, b, lo_rows)
        np.maximum.at(bhi, b, hi_rows)
        plo = np.minimum.accumulate(blo, axis=0)
        phi = np.maximum.accumulate(bhi, axis=0)
        slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        nl = np.cumsum(cnt)[:-1]
        nr = n - nl
        cost = (_box_area(plo[:-1], phi[:-1]) * nl
                + _box_area(slo[1:], shi[1:]) * nr)
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        j = int(np.argmin(cost))
        if np.isfinite(cost[j]) and (best is None or cost[j] < best[0]):
            best = (float(cost[j]), b <= j)
    return best


def _sah_leaves(v0, v1, v2, k: int, n_bins: int = 16,
                deep_ratio: float = None):
    """Binned-SAH top-down leaf partition (host-side numpy build).

    Unlike the equal-size median/Morton chunkers, leaves here hold a
    VARIABLE number of triangles (<= k, padded to k downstream), so the
    split position follows the SAH minimum instead of the segment
    midpoint - the same quality/size trade the reference's driver AS
    build makes on the host (core/accel.h:21-45). Costs more (partially
    filled) clusters; buys tighter, less-overlapping AABBs = fewer
    visited sweep columns per ray, the binding cost.

    deep_ratio: if set, keep splitting BELOW k while the children's AABB
    areas sum to < deep_ratio * parent area. A visit costs one fixed
    column regardless of occupancy, and the expected visits/ray of a
    leaf set scales with total AABB area (surface-area heuristic), so
    sub-k splits pay exactly when they shrink summed area.

    Returns a list of int32 index arrays, one per leaf, each <= k long.
    """
    import numpy as np

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    cent = (v0 + v1 + v2) / 3.0
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)

    leaves = []
    stack = [np.arange(v0.shape[0], dtype=np.int32)]
    while stack:
        idx = stack.pop()
        n = idx.shape[0]
        small = n <= k
        if small and (deep_ratio is None or n < 32):
            leaves.append(idx)
            continue
        # per-bin AABBs over TRIANGLE bounds (not centroids)
        best = _binned_object_best(cent[idx], tlo[idx], thi[idx], n_bins)
        if best is None:
            if small:
                leaves.append(idx)
                continue
            # degenerate centroids: split by index halves
            stack.append(idx[: n // 2])
            stack.append(idx[n // 2:])
            continue
        _, left = best
        if small:
            # sub-k split: only where it shrinks summed leaf area
            li, ri = idx[left], idx[~left]
            pa = _box_area(tlo[idx].min(axis=0), thi[idx].max(axis=0))
            la = _box_area(tlo[li].min(axis=0), thi[li].max(axis=0))
            ra = _box_area(tlo[ri].min(axis=0), thi[ri].max(axis=0))
            if la + ra >= deep_ratio * pa:
                leaves.append(idx)
                continue
        stack.append(idx[left])
        stack.append(idx[~left])
    return leaves


def _sah_split_leaves(v0, v1, v2, k: int, n_bins: int = 16,
                      dup_budget: float = 1.5):
    """Binned-SAH leaf partition WITH spatial splits (SBVH-style).

    Large triangles (floors/walls) straddle any object-split boundary
    and bloat both children's AABBs. A spatial split instead chooses a
    plane and sends a straddling triangle to BOTH sides with its AABB
    clipped at the plane - the union of a triangle's clipped boxes
    covers its full AABB, so the conservative segment-vs-box cull still
    visits a covering cluster for every possible hit point (closest-hit
    takes the min over duplicates; any-hit is trivially unaffected).
    Duplication is capped at dup_budget * T references.

    At each node the binned object split (centroid bins, as
    _sah_leaves) competes with the best spatial split (uniform planes
    over the node box, refs distributed to every overlapped bin with
    clipped boxes) by SAH cost; the cheaper wins. Returns a list of
    UNIQUE-id int32 leaf arrays, each <= k long.
    """
    import numpy as np

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)

    area = _box_area

    # refs: (tri id, clipped AABB); start with one ref per triangle
    ref_tri = np.arange(t, dtype=np.int32)
    ref_lo = tlo.copy()
    ref_hi = thi.copy()
    budget = int(dup_budget * t)

    leaves = []
    stack = [np.arange(t, dtype=np.int64)]   # indices into ref arrays
    refs_total = t
    while stack:
        idx = stack.pop()
        n = idx.shape[0]
        if n <= k:
            leaves.append(idx)
            continue
        rlo, rhi = ref_lo[idx], ref_hi[idx]
        cen = (rlo + rhi) * 0.5
        nlo, nhi = rlo.min(axis=0), rhi.max(axis=0)

        # --- object split (centroid bins, SAH over ref boxes) ---
        obj = _binned_object_best(cen, rlo, rhi, n_bins)

        # --- spatial split (uniform planes over the NODE box) ---
        spa = None  # (cost, plane_x, axis)
        if refs_total < budget:
            nex = nhi - nlo
            for ax in range(3):
                if nex[ax] <= 0:
                    continue
                scale = n_bins / nex[ax]
                lob = np.clip(((rlo[:, ax] - nlo[ax]) * scale
                               ).astype(np.int32), 0, n_bins - 1)
                hib = np.clip(((rhi[:, ax] - nlo[ax]) * scale
                               ).astype(np.int32), 0, n_bins - 1)
                # entry/exit counts per plane
                enter = np.bincount(lob, minlength=n_bins)
                exit_ = np.bincount(hib, minlength=n_bins)
                nl = np.cumsum(enter)[:-1]             # refs left of plane
                nr = n - np.cumsum(exit_)[:-1]         # refs right of plane
                # bin-clipped boxes for bounds
                blo = np.full((n_bins, 3), np.inf, np.float32)
                bhi = np.full((n_bins, 3), -np.inf, np.float32)
                for bb in range(n_bins):
                    inb = (lob <= bb) & (hib >= bb)
                    if not inb.any():
                        continue
                    l = rlo[inb].copy()
                    h = rhi[inb].copy()
                    l[:, ax] = np.maximum(l[:, ax],
                                          nlo[ax] + bb / scale)
                    h[:, ax] = np.minimum(h[:, ax],
                                          nlo[ax] + (bb + 1) / scale)
                    blo[bb] = np.minimum(blo[bb], l.min(axis=0))
                    bhi[bb] = np.maximum(bhi[bb], h.max(axis=0))
                plo = np.minimum.accumulate(blo, axis=0)
                phi = np.maximum.accumulate(bhi, axis=0)
                slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                cost = (area(plo[:-1], phi[:-1]) * nl
                        + area(slo[1:], shi[1:]) * nr)
                cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
                j = int(np.argmin(cost))
                if np.isfinite(cost[j]) and (spa is None
                                             or cost[j] < spa[0]):
                    spa = (float(cost[j]), nlo[ax] + (j + 1) / scale, ax)

        if spa is not None and (obj is None or spa[0] < obj[0]):
            _, px, ax = spa
            go_l = ref_lo[idx, ax] < px
            go_r = ref_hi[idx, ax] > px
            on_plane = ~go_l & ~go_r            # degenerate: box == plane
            go_l |= on_plane
            both = go_l & go_r
            n_new = int(both.sum())
            commit = (go_l.sum() > 0 and go_r.sum() > 0
                      and refs_total + n_new <= budget)
            if commit:
                # straddlers: left keeps the ref clipped at px, right
                # gets a NEW clipped ref (mutate only once committed)
                li = idx[go_l]
                new0 = ref_lo.shape[0]
                ref_tri = np.concatenate([ref_tri, ref_tri[idx[both]]])
                nl_ = ref_lo[idx[both]].copy()
                nl_[:, ax] = np.maximum(nl_[:, ax], px)
                nh_ = ref_hi[idx[both]].copy()
                ref_lo = np.concatenate([ref_lo, nl_])
                ref_hi = np.concatenate([ref_hi, nh_])
                ref_hi[idx[both], ax] = px       # clip left copies
                ri = np.concatenate([
                    idx[go_r & ~both],
                    np.arange(new0, new0 + n_new, dtype=np.int64)])
                refs_total += n_new
                stack.append(li)
                stack.append(ri)
                continue
            # budget blown or one-sided plane: fall back to object split

        if obj is None:
            stack.append(idx[: n // 2])
            stack.append(idx[n // 2:])
            continue
        left = obj[1]
        stack.append(idx[left])
        stack.append(idx[~left])

    # leaves hold REF indices; map to tri ids (dedup within each leaf)
    # and return the CLIPPED-box union per leaf - the cluster AABB must
    # be the clipped union (not the full-triangle union, which would
    # re-expand over the split planes and erase the benefit). The MT
    # sweep still tests full triangles: extra hits beyond a clipped box
    # are true hits, and every possible hit point stays covered because
    # a triangle's clipped boxes union to its full AABB.
    ids = [np.unique(ref_tri[leaf]).astype(np.int32) for leaf in leaves]
    leaf_lo = np.stack([ref_lo[leaf].min(axis=0) for leaf in leaves])
    leaf_hi = np.stack([ref_hi[leaf].max(axis=0) for leaf in leaves])
    return ids, leaf_lo, leaf_hi


def build_clusters(v0, v1, v2, max_clusters: int = 512,
                   min_k: int = 128, method: str = "morton") -> ClusterAccel:
    """Build the cluster accel over triangles v0/v1/v2: f32[T, 3].

    method: "morton" = Morton-sort + fixed chunks; "median" = recursive
    median splits (_median_order), ~40% less total AABB surface area.
    NEITHER dominates on visited columns: median suits the coherent
    primary trace, Morton the incoherent bounce tiles, so production
    builds BOTH and picks per call (build_scene_clusters + render.py).
    """
    t = v0.shape[0]
    k = _choose_k(t, max_clusters, min_k)

    if method in ("sahleaf", "sahdeep", "sahsplit"):
        import numpy as np

        k = min_k  # occupancy is variable; cluster count floats instead
        box_override = None
        if method == "sahsplit":
            dup = float(os.environ.get("PT_SAH_DUP", "1.5"))
            res = None
            if os.environ.get("PT_NATIVE_BUILD", "1") != "0":
                from pathtracer.utils import native as native_mod

                res = native_mod.sah_split_build(
                    np.asarray(v0), np.asarray(v1), np.asarray(v2), k,
                    dup_budget=dup)
            if res is None:  # no toolchain: pure-Python oracle build
                res = _sah_split_leaves(
                    np.asarray(v0), np.asarray(v1), np.asarray(v2), k,
                    dup_budget=dup)
            leaves, leaf_lo, leaf_hi = res
            box_override = (leaf_lo, leaf_hi)
        else:
            deep = (float(os.environ.get("PT_SAH_DEEP", "0.8"))
                    if method == "sahdeep" else None)
            leaves = _sah_leaves(np.asarray(v0), np.asarray(v1),
                                 np.asarray(v2), k, deep_ratio=deep)
        # Morton-order the LEAVES: the SAH builds emit leaves in DFS
        # stack order; Morton order puts spatial siblings at neighbouring
        # cluster ids, so a tile's schedule reads nearby blocks.
        # Schedule quality is unaffected - cull + schedule treat ids
        # opaquely.
        if box_override is not None:
            cen = (box_override[0] + box_override[1]) * 0.5
        else:
            a0, a1, a2 = np.asarray(v0), np.asarray(v1), np.asarray(v2)
            cen = np.stack([
                (np.minimum(np.minimum(a0[l], a1[l]), a2[l]).min(0)
                 + np.maximum(np.maximum(a0[l], a1[l]), a2[l]).max(0))
                * 0.5 for l in leaves])
        code = np.asarray(morton_mod.morton_codes(jnp.asarray(cen)))
        lorder = np.argsort(code, kind="stable")
        leaves = [leaves[i] for i in lorder]
        if box_override is not None:
            box_override = (box_override[0][lorder],
                            box_override[1][lorder])
        # pad cluster count to a 128 multiple with empty clusters so
        # every downstream [*, C] op stays lane-aligned
        c = -(-len(leaves) // 128) * 128
        order = np.full((c * k,), -1, np.int64)
        for i, leaf in enumerate(leaves):
            order[i * k: i * k + leaf.shape[0]] = leaf
        n_real = sum(leaf.shape[0] for leaf in leaves)  # > t for sahsplit
        sid = jnp.asarray(order, jnp.int32)
        gather = jnp.maximum(sid, 0)
        real = (sid >= 0)[:, None]
        sv0 = jnp.where(real, jnp.asarray(v0)[gather], _PAD_POS)
        sv1 = jnp.where(real, jnp.asarray(v1)[gather], _PAD_POS)
        sv2 = jnp.where(real, jnp.asarray(v2)[gather], _PAD_POS)
        accel = _finish_build(sv0, sv1, sv2, sid, k, c * k - n_real, t)
        if box_override is not None:
            lo = np.full((c, 3), _PAD_POS, np.float32)
            hi = np.full((c, 3), _PAD_POS, np.float32)
            lo[: len(leaves)] = box_override[0]
            hi[: len(leaves)] = box_override[1]
            accel = dataclasses.replace(accel, aabb_lo=jnp.asarray(lo),
                                        aabb_hi=jnp.asarray(hi))
        return accel

    centroids = (v0 + v1 + v2) / 3.0
    if method in ("median", "sah"):
        # pad FIRST to (pow2 clusters) * k so segments stay equal-size
        c_pow2 = _next_pow2((t + k - 1) // k)
        pad_n = c_pow2 * k - t
        cent_p = jnp.concatenate(
            [centroids, jnp.full((pad_n, 3), _PAD_POS, jnp.float32)]) \
            if pad_n else centroids
        order_p = _median_order(
            cent_p, c_pow2, "sa" if method == "sah" else "longest")
        # positions > t are pads; map them to id -1
        sid = jnp.where(order_p < t, order_p, -1)
        padv = jnp.full((max(pad_n, 1), 3), _PAD_POS, jnp.float32)
        v0p = jnp.concatenate([v0, padv[:pad_n]]) if pad_n else v0
        v1p = jnp.concatenate([v1, padv[:pad_n]]) if pad_n else v1
        v2p = jnp.concatenate([v2, padv[:pad_n]]) if pad_n else v2
        gather = jnp.maximum(order_p, 0)
        sv0 = jnp.where((order_p < t)[:, None], v0p[gather], _PAD_POS)
        sv1 = jnp.where((order_p < t)[:, None], v1p[gather], _PAD_POS)
        sv2 = jnp.where((order_p < t)[:, None], v2p[gather], _PAD_POS)
        # zero edges for pads (sv1/sv2 already equal sv0 = _PAD_POS)
        pad = pad_n
        return _finish_build(sv0, sv1, sv2, sid, k, pad, t)

    codes = morton_mod.morton_codes(centroids)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)
    pad = (-t) % k

    sv0 = v0[order]
    sv1 = v1[order]
    sv2 = v2[order]
    sid = order

    if pad:
        padv = jnp.full((pad, 3), _PAD_POS, jnp.float32)
        pad0 = jnp.full((pad, 3), _PAD_POS, jnp.float32)
        sv0 = jnp.concatenate([sv0, padv])
        sv1 = jnp.concatenate([sv1, pad0])   # e1 = v1 - v0 = 0 for pads
        sv2 = jnp.concatenate([sv2, pad0])
        sid = jnp.concatenate(
            [sid, jnp.full((pad,), -1, jnp.int32)])
        # make pad edges exactly zero
        sv1 = sv1.at[t:].set(sv0[t:])
        sv2 = sv2.at[t:].set(sv0[t:])

    return _finish_build(sv0, sv1, sv2, sid, k, pad, t)


def _finish_build(sv0, sv1, sv2, sid, k, pad, t) -> ClusterAccel:
    """Cluster AABBs + pre-baked blocks over the ordered triangle arrays."""
    c = sv0.shape[0] // k

    lo = jnp.minimum(jnp.minimum(sv0, sv1), sv2).reshape(c, k, 3)
    hi = jnp.maximum(jnp.maximum(sv0, sv1), sv2).reshape(c, k, 3)
    # padded tris sit at +1e30: exclude them from real clusters' bounds by
    # construction; with median ordering pads can land in any tail
    # cluster, so always mask by sid when padding exists.
    if pad:
        valid = (sid >= 0).reshape(c, k, 1)
        lo = jnp.where(valid, lo, jnp.inf)
        hi = jnp.where(valid, hi, -jnp.inf)
    aabb_lo = jnp.min(lo, axis=1)
    aabb_hi = jnp.max(hi, axis=1)
    if pad:
        # fully-padded clusters (when pad >= k): finite far-away box
        empty = jnp.all(~valid, axis=1)[..., 0]
        aabb_lo = jnp.where(empty[:, None], _PAD_POS, aabb_lo)
        aabb_hi = jnp.where(empty[:, None], _PAD_POS, aabb_hi)

    # Triangle ids ride as FLOAT VALUES (id + 1; exact below 2^24), never
    # as bitcast integers: small int bit patterns are f32 denormals, which
    # a flush-to-zero vector unit would silently corrupt.
    id_val = (sid + 1).astype(jnp.float32)
    e1 = sv1 - sv0
    e2 = sv2 - sv0
    rows = jnp.concatenate(
        [sv0, e1, e2, id_val[:, None],
         jnp.zeros((sv0.shape[0], 2), jnp.float32)], axis=1)
    blocks = rows.reshape(c, k, 12)

    # Sweep-kernel layout: Baldwin-Weber precomputed transform. Per-pair
    # work drops from ~59 vector ops (cross products recomputed per
    # column) to ~46: n = e1 x e2 (== the classic MT determinant axis, so the
    # same DET_EPS reject semantics), plane offset d, and the two
    # barycentric row vectors r1 = (e2 x n)/|n|^2, r2 = (n x e1)/|n|^2
    # with offsets c1/c2 - u = r1.h + c1 at the plane hit point h. The
    # sweep uses v0 (rows 13-15) instead of d/c1/c2: t = n.(v0 - o)/n.dir
    # and u = r1.(o - v0 + t dir) subtract the vertex FIRST, so a hit far
    # from the world origin keeps its precision (the offset form loses
    # ~|o|/t ulps to cancellation).
    # Degenerate/pad triangles have n = 0 -> denom = 0 -> never hit.
    nrm = jnp.cross(e1, e2)
    dpl = jnp.sum(nrm * sv0, axis=1, keepdims=True)
    det = jnp.sum(nrm * nrm, axis=1, keepdims=True)
    inv_det = jnp.where(det > 0, 1.0 / jnp.where(det > 0, det, 1.0), 0.0)
    r1 = jnp.cross(e2, nrm) * inv_det
    c1 = -jnp.sum(r1 * sv0, axis=1, keepdims=True)
    r2 = jnp.cross(nrm, e1) * inv_det
    c2 = -jnp.sum(r2 * sv0, axis=1, keepdims=True)
    rows_bw = jnp.concatenate(
        [nrm, dpl, r1, c1, r2, c2, id_val[:, None], sv0], axis=1)  # [T, 16]
    bt = jnp.swapaxes(rows_bw.reshape(c, k, 16), 1, 2)        # [C, 16, K]
    return ClusterAccel(aabb_lo=aabb_lo, aabb_hi=aabb_hi, blocks=blocks,
                        blocks_t=bt)


def build_scene_clusters(scene: Scene, max_clusters: int = 2048,
                         method: str = "sahsplit") -> Scene:
    """Attach the packet-traversal accels to the scene.

    `clusters` serves occlusion batches; `clusters_fine` serves
    closest-hit (primary + bounce). Both default to the binned-SAH
    spatial-split build (SBVH-style): SAH leaves win EVERY batch class
    by exact visited-column counts (x1.55 primary / x1.46 bounce /
    x1.44 shadow vs median) and spatial splits stack another x1.13 /
    x1.02 / x1.21 by clipping the big floor/wall triangles that bloat
    leaf AABBs. Column counts are platform-free. PT_FINE_METHOD /
    PT_COARSE_METHOD env knobs override the builds for A/Bs
    (sahsplit | sahleaf | sahdeep | median | morton | sah).
    """
    fine_method = os.environ.get("PT_FINE_METHOD", "sahsplit")
    method = os.environ.get("PT_COARSE_METHOD", method)
    tri_ids = jnp.arange(scene.n_tris)
    v0, v1, v2 = scene.tri_vertices(tri_ids)
    if fine_method == method:
        accel = build_clusters(v0, v1, v2, max_clusters, method=method)
        return dataclasses.replace(scene, clusters=accel,
                                   clusters_fine=accel)
    return dataclasses.replace(
        scene,
        clusters=build_clusters(v0, v1, v2, max_clusters, method=method),
        clusters_fine=build_clusters(v0, v1, v2, max_clusters,
                                     method=fine_method))
