"""Stackless threaded-BVH traversal (XLA vectorized, packed-node layout).

Replaces the hardware BVH traversal behind `traceRayEXT` (raygen.rgen:129)
and the shadow `rayQueryEXT` walk (raygen.rgen:206-231). The Bvh from
accel/lbvh.py is threaded: every node knows where traversal goes on AABB hit
(its first child = node+1 in DFS preorder, or for leaves the subtree skip)
and on miss (`miss_link`). Traversal is therefore a single per-ray pointer
chase with NO stack - ideal for a lockstep SPMD machine: a ray batch
advances one node per iteration of a `lax.while_loop`, with gathers for node
data and jnp.where merges instead of SIMT divergence.

Memory-system design (this is the hot loop - SURVEY.md par.7 hard parts
1-2, "gather-heavy workloads"):

- **One 32-byte gather per step.** Node data is packed into a single
  f32[n_nodes, 8] row: [lo.xyz, hi.xyz, miss_link_bits, tri_bits]. The
  internal-node hit link needs no storage (DFS preorder => first child is
  node+1), so one contiguous row-gather replaces the five separate gathers
  of the naive SoA layout (aabb_min/aabb_max/hit/miss/tri).
- **Pre-baked leaf triangles.** Leaf tests gather one f32[T, 9] row
  [v0, e1, e2] instead of chasing indices[tri] -> positions[i0..i2]
  (four dependent gathers). e1/e2 are precomputed Moller-Trumbore edges.
- **Chunked lockstep.** A single whole-batch while_loop runs until the
  WORST ray in the batch terminates: cost = max_trips x N. `lax.map` over
  fixed-size ray chunks gives each chunk its own trip count:
  cost = sum_chunks (chunk_max_trips x chunk). Primary rays are coherent in
  pixel order, so chunk maxima vary a lot - this is the ray-locality lever
  the BASELINE north star calls "sorting + compaction" done shapes-static.

Closest-hit keeps per-ray best (t, tri, u, v); shadow traversal early-outs
lanes as soon as a front-facing occluder is found (backface-skip policy of
raygen.rgen:214-218).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtracer.kernels.intersect import DET_EPS, Hit
from pathtracer.scene.types import Bvh
from pathtracer.utils import vmath

# Rays per lockstep chunk. 2**16 lanes x ~40B of gather traffic per step is
# comfortably bandwidth-bound; smaller chunks sharpen the per-chunk trip
# counts but add sequential lax.map steps.
RAY_CHUNK = 1 << 16


class PackedBvh(NamedTuple):
    """Gather-optimal traversal layout (see module docstring)."""

    nodes: jnp.ndarray  # f32 [n_nodes, 8]: lo3, hi3, miss+1, tri+1
    tris: jnp.ndarray   # f32 [T, 9]: v0, e1=v1-v0, e2=v2-v0


def pack_bvh(bvh: Bvh, indices, positions) -> PackedBvh:
    """Pack a threaded Bvh + mesh into the single-gather traversal layout.

    Pure jnp - safe both inside jit (recomputed per frame, O(n) fused and
    negligible next to traversal traffic) and ahead of time.
    """
    # links/ids ride as float VALUES (x+1, exact below 2^24), never as
    # bitcast integers: a vector unit that flushes f32 denormals to zero
    # or canonicalizes NaNs would corrupt bit-smuggled payloads.
    miss_val = (bvh.miss_link + 1).astype(jnp.float32)
    tri_val = (bvh.tri_id + 1).astype(jnp.float32)
    nodes = jnp.concatenate(
        [bvh.aabb_min, bvh.aabb_max, miss_val[:, None], tri_val[:, None]],
        axis=1)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    tris = jnp.concatenate([v0, v1 - v0, v2 - v0], axis=1)
    return PackedBvh(nodes=nodes, tris=tris)


def _safe_inv(d):
    """1/d with zero components nudged off zero (keeps slab test NaN-free)."""
    tiny = 1e-20
    d_safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    return 1.0 / d_safe


def _like(ref, value, dtype):
    """Constant-filled array deriving data-dependence from `ref`.

    Under shard_map's manual axes, a fresh constant is "unvarying" while the
    while_loop body output is varying - the carry types then mismatch. An
    init derived from a varying input (ref * 0 + value) inherits the varying
    axes and works both inside and outside shard_map.
    """
    return (ref * 0).astype(dtype) + jnp.asarray(value, dtype)


def _mt_packed(tri_rows, o, d, t_min, t_max):
    """Moller-Trumbore against pre-baked [N, 9] rows (v0, e1, e2)."""
    v0 = tri_rows[:, 0:3]
    e1 = tri_rows[:, 3:6]
    e2 = tri_rows[:, 6:9]
    pvec = vmath.cross(d, e2)
    det = vmath.dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / det, 0.0)
    tvec = o - v0
    u = vmath.dot(tvec, pvec) * inv_det
    qvec = vmath.cross(tvec, e1)
    v = vmath.dot(d, qvec) * inv_det
    t = vmath.dot(e2, qvec) * inv_det
    hit = ((jnp.abs(det) > DET_EPS)
           & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return t, u, v, hit, e1, e2


def _chunk_map(fn, rays, n):
    """Run fn over RAY_CHUNK-sized chunks of the leading ray axis.

    rays: tuple of [N, ...] arrays; fn maps a tuple of [C, ...] chunks to a
    tuple/struct of [C, ...] outputs. Pads N up to a chunk multiple (padded
    lanes compute garbage that is sliced off).
    """
    if n <= RAY_CHUNK:
        return fn(rays)
    pad = (-n) % RAY_CHUNK
    if pad:
        rays = tuple(
            jnp.concatenate([r, jnp.broadcast_to(r[:1], (pad,) + r.shape[1:])])
        for r in rays)
    total = n + pad
    c = total // RAY_CHUNK
    chunked = tuple(r.reshape((c, RAY_CHUNK) + r.shape[1:]) for r in rays)
    out = jax.lax.map(fn, chunked)
    out = jax.tree_util.tree_map(
        lambda x: x.reshape((total,) + x.shape[2:])[:n], out)
    return out


def _intersect_chunk(packed: PackedBvh, t_min, t_max):
    nodes = packed.nodes
    tris = packed.tris

    def run(rays):
        o, d = rays
        inv_d = _safe_inv(d)
        # Both o and d contribute: either alone can be replicated under
        # shard_map (e.g. primary-ray origins are the camera position).
        ref = o[..., 0] + d[..., 0]

        state = (
            _like(ref, 0, jnp.int32),                   # node ptr (root = 0)
            _like(ref, t_max, jnp.float32),             # best t
            _like(ref, -1, jnp.int32),                  # best tri
            _like(ref, 0.0, jnp.float32),               # best u
            _like(ref, 0.0, jnp.float32),               # best v
        )

        def cond(state):
            node, *_ = state
            return jnp.any(node >= 0)

        def body(state):
            node, best_t, best_tri, best_u, best_v = state
            live = node >= 0
            ni = jnp.maximum(node, 0)

            row = nodes[ni]                             # ONE 32B gather
            lo = row[:, 0:3]
            hi = row[:, 3:6]
            miss = jnp.round(row[:, 6]).astype(jnp.int32) - 1
            tri = jnp.round(row[:, 7]).astype(jnp.int32) - 1

            t1 = (lo - o) * inv_d
            t2 = (hi - o) * inv_d
            t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
            t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
            box_hit = ((t_near <= t_far) & (t_far >= t_min)
                       & (t_near <= best_t) & live)

            is_leaf = (tri >= 0) & box_hit

            # Leaf: test the one triangle (all lanes compute, masked merge).
            ti = jnp.maximum(tri, 0)
            t, u, v, tri_hit, _, _ = _mt_packed(tris[ti], o, d, t_min, best_t)
            better = is_leaf & tri_hit & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_tri = jnp.where(better, tri, best_tri)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)

            # Threaded step: internal hit -> first child (node+1 in DFS
            # preorder); leaf or miss -> skip link.
            nxt = jnp.where(box_hit & (tri < 0), ni + 1, miss)
            node = jnp.where(live, nxt, node)
            return node, best_t, best_tri, best_u, best_v

        _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(
            cond, body, state)
        best_t = jnp.where(best_tri >= 0, best_t, jnp.inf)
        return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)

    return run


def _occluded_chunk(packed: PackedBvh):
    nodes = packed.nodes
    tris = packed.tris

    def run(rays):
        o, d, t_max = rays
        inv_d = _safe_inv(d)
        ref = o[..., 0] + d[..., 0]

        state = (
            _like(ref, 0, jnp.int32),
            _like(ref, 0, jnp.int32).astype(bool),
        )

        def cond(state):
            node, _ = state
            return jnp.any(node >= 0)

        def body(state):
            node, blocked = state
            live = node >= 0
            ni = jnp.maximum(node, 0)

            row = nodes[ni]
            lo = row[:, 0:3]
            hi = row[:, 3:6]
            miss = jnp.round(row[:, 6]).astype(jnp.int32) - 1
            tri = jnp.round(row[:, 7]).astype(jnp.int32) - 1

            t1 = (lo - o) * inv_d
            t2 = (hi - o) * inv_d
            t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
            t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
            box_hit = ((t_near <= t_far) & (t_far >= 0.0)
                       & (t_near <= t_max) & live)

            is_leaf = (tri >= 0) & box_hit
            ti = jnp.maximum(tri, 0)
            t, _, _, tri_hit, e1, e2 = _mt_packed(
                tris[ti], o, d, 0.0, jnp.inf)
            # front-facing to the shadow ray: geometric normal opposes d
            # (raygen.rgen:215-218 backface-skip policy).
            gn = vmath.cross(e1, e2)
            front = vmath.dot(d, gn) < 0.0
            newly = is_leaf & tri_hit & front & (t < t_max)
            blocked = blocked | newly

            nxt = jnp.where(box_hit & (tri < 0), ni + 1, miss)
            nxt = jnp.where(blocked, -1, nxt)          # early out
            node = jnp.where(live, nxt, node)
            return node, blocked

        _, blocked = jax.lax.while_loop(cond, body, state)
        return blocked

    return run


def intersect_packed(packed: PackedBvh, o, d, t_min, t_max) -> Hit:
    """Closest hit for rays o/d [N,3] against a packed threaded BVH."""
    return _chunk_map(_intersect_chunk(packed, t_min, t_max), (o, d),
                      o.shape[0])


def occluded_packed(packed: PackedBvh, o, d, t_max):
    """Any-hit visibility with backface skip. Returns bool[N]."""
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:-1])
    return _chunk_map(_occluded_chunk(packed), (o, d, t_max),
                      o.shape[0])


def intersect_bvh(bvh: Bvh, indices, positions, o, d, t_min, t_max) -> Hit:
    """Closest hit for rays o/d [N,3] against the threaded BVH."""
    return intersect_packed(pack_bvh(bvh, indices, positions), o, d,
                            t_min, t_max)


def occluded_bvh(bvh: Bvh, indices, positions, o, d, t_max):
    """Any-hit visibility with backface skip (raygen.rgen:210-230).

    Returns bool[N]: True where a front-facing triangle blocks the segment.
    Lanes early-out (pointer -> -1) on the first qualifying hit.
    """
    return occluded_packed(pack_bvh(bvh, indices, positions), o, d, t_max)
