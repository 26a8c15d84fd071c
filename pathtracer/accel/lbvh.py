"""On-device LBVH builder: Morton sort + Karras radix tree + threaded layout.

Replaces the reference's driver-side acceleration-structure build
(core/accel.h:21-45, `buildAccelerationStructuresKHR`) with an entirely
on-device construction in XLA ops - SURVEY.md par.7 step 3, the net-new
engineering with no reference counterpart:

1. Morton codes over triangle centroids (accel/morton.py).
2. Stable radix sort of codes (XLA sort).
3. Karras 2012 binary radix tree: each internal node's (range, split) is
   computed independently -> fully parallel, no sequential insertion. The
   doubling/binary searches are fixed-trip-count vectorized loops.
4. AABB fit via a sparse-table RMQ over the sorted leaf AABBs: every radix
   tree node covers a *contiguous* leaf range, so its AABB is a range
   min/max - O(n log n) precompute, O(1) per node, no bottom-up sweeps.
5. Threaded (stackless) DFS layout: nodes sorted by (range_start asc,
   range_size desc) IS the DFS preorder of this tree; each node's miss/skip
   link is the first DFS node whose range starts after the node's range
   ends (a searchsorted). Traversal then needs no stack at all
   (kernels/traverse.py).

The whole build is jittable: `build_lbvh` is shapes-static in the triangle
count and runs on the accelerator (the reference calls into the driver;
here the "driver" is XLA).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pathtracer.accel import morton as morton_mod
from pathtracer.scene.types import Bvh, Scene

_I32 = jnp.int32


def _delta(codes, i, j, n):
    """Karras delta(i, j): common-prefix length of augmented keys.

    codes: uint32[n] sorted Morton codes. Out-of-range j -> -1. Equal codes
    fall back to the leaf index bits (Karras sec. 4: concat(code, index)),
    giving 32 + clz(i ^ j).
    """
    j_ok = (j >= 0) & (j < n)
    jc = jnp.clip(j, 0, n - 1)
    ci = codes[i]
    cj = codes[jc]
    x = ci ^ cj
    d_code = jax.lax.clz(x).astype(_I32)
    d_idx = (32 + jax.lax.clz((i.astype(jnp.uint32) ^ jc.astype(jnp.uint32)))
             .astype(_I32))
    d = jnp.where(x == 0, d_idx, d_code)
    return jnp.where(j_ok, d, -1)


def _radix_tree_ranges(codes, n):
    """Ranges + splits of the n-1 internal nodes (Karras 2012, Alg. fig. 4).

    Returns (first, last, split): i32[n-1] each; node i covers sorted leaves
    [first, last] and splits into [first, split], [split+1, last].
    """
    i = jnp.arange(n - 1, dtype=_I32)
    d = jnp.sign(_delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n)) \
        .astype(_I32)
    delta_min = _delta(codes, i, i - d, n)

    # upper bound on range length by doubling (fixed 32 trips).
    lmax = jnp.full_like(i, 2)
    for _ in range(32):
        probe = _delta(codes, i, i + lmax * d, n)
        grow = probe > delta_min
        lmax = jnp.where(grow, lmax * 2, lmax)

    # binary search the exact length.
    l = jnp.zeros_like(i)
    t = lmax // 2
    while_steps = 32
    for _ in range(while_steps):
        cand = l + t
        ok = (t > 0) & (_delta(codes, i, i + cand * d, n) > delta_min)
        l = jnp.where(ok, cand, l)
        t = t // 2
    j = i + l * d

    # split search: largest s with delta(i, i+s*d) > delta_node.
    delta_node = _delta(codes, i, j, n)
    s = jnp.zeros_like(i)
    t = (l + 1) // 2
    cont = jnp.ones_like(i, dtype=bool)
    for _ in range(while_steps):
        cand = s + t
        ok = cont & (_delta(codes, i, (i + cand * d), n) > delta_node)
        s = jnp.where(ok, cand, s)
        cont = cont & (t > 1)
        t = (t + 1) // 2
        # replicate `do { t = ceil(t/2) } while (t > 1)` with masking
    gamma = i + s * d + jnp.minimum(d, 0)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    return first, last, gamma


def _range_aabb(leaf_lo, leaf_hi, first, last):
    """AABB over contiguous leaf ranges via sparse-table RMQ.

    leaf_lo/hi: f32[n,3] AABBs of the sorted leaves. first/last: i32[m].
    Returns (lo, hi) f32[m,3].
    """
    n = leaf_lo.shape[0]
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    span = 1
    while span * 2 <= n:
        prev_lo, prev_hi = levels_lo[-1], levels_hi[-1]
        shift_idx = jnp.minimum(jnp.arange(n) + span, n - 1)
        levels_lo.append(jnp.minimum(prev_lo, prev_lo[shift_idx]))
        levels_hi.append(jnp.maximum(prev_hi, prev_hi[shift_idx]))
        span *= 2
    tab_lo = jnp.stack(levels_lo)   # [L, n, 3]
    tab_hi = jnp.stack(levels_hi)

    length = last - first + 1
    k = (31 - jax.lax.clz(length.astype(jnp.uint32)).astype(_I32))
    k = jnp.clip(k, 0, len(levels_lo) - 1)
    right = last - (1 << k) + 1
    lo = jnp.minimum(tab_lo[k, first], tab_lo[k, right])
    hi = jnp.maximum(tab_hi[k, first], tab_hi[k, right])
    return lo, hi


@functools.partial(jax.jit, static_argnames=())
def build_lbvh(v0, v1, v2) -> Bvh:
    """Build a threaded LBVH over triangles (v0, v1, v2: f32[T, 3]).

    Returns a Bvh with 2T-1 nodes in DFS preorder (root at index 0).
    """
    n = v0.shape[0]
    if n == 1:
        # degenerate single-leaf tree
        lo = jnp.minimum(jnp.minimum(v0, v1), v2)
        hi = jnp.maximum(jnp.maximum(v0, v1), v2)
        return Bvh(
            aabb_min=lo, aabb_max=hi,
            hit_link=jnp.full((1,), -1, _I32),
            miss_link=jnp.full((1,), -1, _I32),
            tri_id=jnp.zeros((1,), _I32),
        )

    centroids = (v0 + v1 + v2) / 3.0
    codes = morton_mod.morton_codes(centroids)
    order = jnp.argsort(codes, stable=True).astype(_I32)
    codes = codes[order]

    leaf_lo = jnp.minimum(jnp.minimum(v0, v1), v2)[order]
    leaf_hi = jnp.maximum(jnp.maximum(v0, v1), v2)[order]

    first, last, _gamma = _radix_tree_ranges(codes, n)
    int_lo, int_hi = _range_aabb(leaf_lo, leaf_hi, first, last)

    # --- threaded DFS layout over all 2n-1 nodes ---
    # internal nodes: ranges [first, last] (size >= 2); leaves: [i, i].
    leaf_ids = jnp.arange(n, dtype=_I32)
    all_first = jnp.concatenate([first, leaf_ids])
    all_last = jnp.concatenate([last, leaf_ids])
    all_lo = jnp.concatenate([int_lo, leaf_lo])
    all_hi = jnp.concatenate([int_hi, leaf_hi])
    all_tri = jnp.concatenate([jnp.full((n - 1,), -1, _I32), order])

    size = all_last - all_first + 1
    # DFS preorder == sort by (start asc, size desc). Two stable argsorts.
    o1 = jnp.argsort(-size, stable=True)
    o2 = jnp.argsort(all_first[o1], stable=True)
    dfs = o1[o2]

    d_first = all_first[dfs]
    d_last = all_last[dfs]

    # miss link: first DFS node whose range starts at d_last+1 (the DFS
    # successor outside the subtree); -1 if the subtree ends the array.
    succ = jnp.searchsorted(d_first, d_last + 1, side="left").astype(_I32)
    n_nodes = 2 * n - 1
    miss = jnp.where(d_last + 1 >= n, -1, succ)
    miss = jnp.where(miss >= n_nodes, -1, miss)

    d_tri = all_tri[dfs]
    is_leaf = d_tri >= 0
    nxt = jnp.arange(n_nodes, dtype=_I32) + 1
    hit = jnp.where(is_leaf, miss, jnp.where(nxt >= n_nodes, -1, nxt))

    return Bvh(
        aabb_min=all_lo[dfs], aabb_max=all_hi[dfs],
        hit_link=hit, miss_link=miss, tri_id=d_tri,
    )


def build_scene_bvh(scene: Scene) -> Scene:
    """Attach an LBVH over the scene's triangles (driver-free accel build)."""
    tri_ids = jnp.arange(scene.n_tris)
    v0, v1, v2 = scene.tri_vertices(tri_ids)
    return scene.with_bvh(build_lbvh(v0, v1, v2))
