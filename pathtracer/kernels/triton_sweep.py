"""Cluster sweeps as Pallas Triton kernels for the GPU.

The inner loop of packet traversal (kernels/packet.py): every tile of
TILE_RAYS rays walks its own near-to-far cluster schedule and tests each
visited cluster's triangles densely. Here one program handles one tile and
the grid's programs run in parallel, in no order:

- a program reads its own schedule row (st, si) from device memory;
- it loops over that row and stops early: closest-hit once the next entry
  lies past every ray's best hit (best_t starts at the per-ray scene-exit
  cap), any-hit once every ray is blocked or the row is exhausted;
- each step loads one f32[16, K] Baldwin-Weber cluster block
  (accel/cluster._finish_build) by id. The next step's block is loaded
  before the current one is tested, so its latency hides behind the test;
  the whole accel (~23 MB at 262k triangles) stays in the card's L2;
- the [R, K] ray-triangle test runs in column sub-blocks of SUB_COLS, which
  bounds the [R, SUB_COLS] intermediates each thread keeps in registers.

The work is f32 elementwise (~47 ops per ray-triangle pair); no tensor
core applies. interpret=True runs the same kernels in the Pallas
interpreter, which is how the CPU tests reach them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pathtracer.kernels.intersect import DET_EPS

# Ray operand rows: ox oy oz dx dy dz, then the per-ray cap (closest: the
# scene-exit distance best_t starts from; any-hit: the segment's t_max),
# padded to a power of two as Triton blocks must be.
RAY_ROWS = 8
CAP_ROW = 6
# Block rows read per visit (accel/cluster.ClusterAccel.blocks_t): n,
# r1, r2, tri id + 1, v0. The plane and barycentric offsets (rows 3, 7,
# 11) are not read: subtracting v0 first keeps far hits precise.
BLOCK_ROWS = (0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 15)
TID = 9                      # position of the id row in BLOCK_ROWS
# Columns tested per sub-block and warps per program: at 8 warps a
# [64, 32] f32 intermediate is 8 values per thread. Chosen on an H100
# (SXM, 700 W) among 16/32/64/128 columns at 4 or 8 warps.
SUB_COLS = 32
NUM_WARPS = 8


def _ray_rows(rays_ref):
    """Ray components as [R, 1] columns plus the [R] cap row."""
    comps = tuple(rays_ref[i, :][:, None] for i in range(6))
    return comps, rays_ref[CAP_ROW, :]


def _load_cluster(blocks_ref, si_ref, col, n_cols, k, sub):
    """One cluster's BLOCK_ROWS, split into sub-blocks of `sub` columns:
    ((f32[sub] x 13) x k/sub).

    col is clamped to the schedule, so the prefetch past the last entry
    re-reads a valid cluster and is never tested.
    """
    cid = si_ref[jnp.minimum(col, n_cols - 1)]
    return tuple(
        tuple(blocks_ref[cid, i, pl.ds(s * sub, sub)]
              for i in BLOCK_ROWS)
        for s in range(k // sub))


def _bw_test(rows, ray, t_min, t_hi):
    """Baldwin-Weber test of R rays against one sub-block of triangles.

    rows: the 13 BLOCK_ROWS as f32[S]; ray: six f32[R, 1] components;
    t_hi: f32[R, 1] exclusive upper bound. Returns (t, u, v, denom), each
    f32[R, S], with t = +inf where the pair does not hit in (t_min, t_hi).
    denom = n . dir is the classic determinant, so DET_EPS keeps its
    meaning, and its sign is the facing test (front = denom < 0).
    """
    ox, oy, oz, dx, dy, dz = ray
    nx, ny, nz, r1x, r1y, r1z, r2x, r2y, r2z, _, v0x, v0y, v0z = (
        x[None, :] for x in rows)
    denom = dx * nx + dy * ny + dz * nz
    valid = jnp.abs(denom) > DET_EPS
    inv = jnp.where(valid, 1.0 / denom, 0.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    t = -(sx * nx + sy * ny + sz * nz) * inv
    hx = sx + t * dx
    hy = sy + t * dy
    hz = sz + t * dz
    u = r1x * hx + r1y * hy + r1z * hz
    v = r2x * hx + r2y * hy + r2z * hz
    ok = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_hi))
    return jnp.where(ok, t, jnp.inf), u, v, denom


def _tri_ids(rows):
    return rows[TID].astype(jnp.int32) - 1              # [S]; -1 = pad


def _closest_kernel(st_ref, si_ref, rays_ref, blocks_ref,
                    t_ref, tri_ref, u_ref, v_ref, *, t_min, n_cols, k, sub):
    ray, cap = _ray_rows(rays_ref)
    r = cap.shape[0]
    lane = jnp.arange(sub, dtype=jnp.int32)[None, :]

    def test(rows, hit):
        best_t, best_tri, best_u, best_v, max_best = hit
        t, u, v, _ = _bw_test(rows, ray, t_min, best_t[:, None])
        tj = jnp.min(t, axis=1)                          # [R]

        def extract(hit):
            best_t, best_tri, best_u, best_v, _ = hit
            sel = lane == jnp.argmin(t, axis=1)[:, None]
            uj = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
            vj = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
            idj = jnp.sum(jnp.where(sel, _tri_ids(rows)[None, :], 0), axis=1)
            # t is already gated on t < best_t: a finite tj improves
            better = (tj < jnp.inf) & (idj >= 0)
            best_t = jnp.where(better, tj, best_t)
            return (best_t, jnp.where(better, idj, best_tri),
                    jnp.where(better, uj, best_u),
                    jnp.where(better, vj, best_v), jnp.max(best_t))

        # most near-to-far columns improve no ray: skip the extraction
        return jax.lax.cond(jnp.min(tj) < jnp.inf, extract, lambda h: h, hit)

    def cond(carry):
        col, _, hit = carry
        nearest = st_ref[jnp.minimum(col, n_cols - 1)]
        return (col < n_cols) & (nearest < hit[4])

    def body(carry):
        col, cur, hit = carry
        nxt = _load_cluster(blocks_ref, si_ref, col + 1, n_cols, k, sub)
        for rows in cur:
            hit = test(rows, hit)
        return col + 1, nxt, hit

    hit0 = (cap, jnp.full((r,), -1, jnp.int32), jnp.zeros((r,), jnp.float32),
            jnp.zeros((r,), jnp.float32), jnp.max(cap))
    init = (jnp.int32(0),
            _load_cluster(blocks_ref, si_ref, 0, n_cols, k, sub), hit0)
    _, _, (best_t, best_tri, best_u, best_v, _) = jax.lax.while_loop(
        cond, body, init)
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    u_ref[...] = best_u
    v_ref[...] = best_v


def _occluded_kernel(st_ref, si_ref, rays_ref, blocks_ref, blocked_ref,
                     *rest, n_cols, k, sub, want_blocker):
    """Any front-facing hit in (0, t_max). With want_blocker a second
    output holds the id of SOME blocking triangle per ray (-1 open)."""
    ray, t_max = _ray_rows(rays_ref)
    r = t_max.shape[0]
    t_hi = t_max[:, None]
    lane = jnp.arange(sub, dtype=jnp.int32)[None, :]

    def test(rows, state):
        blocked, btri = state
        t, _, _, denom = _bw_test(rows, ray, 0.0, t_hi)
        hit = (t < jnp.inf) & (denom < 0.0)
        any_hit = jnp.max(hit.astype(jnp.int32), axis=1)     # [R]
        if want_blocker:
            new = any_hit > blocked

            def record(btri):
                th = jnp.where(hit, t, jnp.inf)
                sel = lane == jnp.argmin(th, axis=1)[:, None]
                idj = jnp.sum(jnp.where(sel, _tri_ids(rows)[None, :], 0),
                              axis=1)
                return jnp.where(new, idj, btri)

            btri = jax.lax.cond(jnp.max(new.astype(jnp.int32)) > 0,
                                record, lambda b: b, btri)
        return jnp.maximum(blocked, any_hit), btri

    def cond(carry):
        col, _, n_open, _ = carry
        nearest = st_ref[jnp.minimum(col, n_cols - 1)]
        return (col < n_cols) & (nearest < jnp.inf) & (n_open > 0)

    def body(carry):
        col, cur, _, state = carry
        nxt = _load_cluster(blocks_ref, si_ref, col + 1, n_cols, k, sub)
        for rows in cur:
            state = test(rows, state)
        return col + 1, nxt, r - jnp.sum(state[0]), state

    state0 = (jnp.zeros((r,), jnp.int32), jnp.full((r,), -1, jnp.int32))
    init = (jnp.int32(0),
            _load_cluster(blocks_ref, si_ref, 0, n_cols, k, sub),
            jnp.int32(r), state0)
    _, _, _, (blocked, btri) = jax.lax.while_loop(cond, body, init)
    blocked_ref[...] = blocked
    if want_blocker:
        rest[0][...] = btri


def _call(kernel, st, si, rays, blocks_t, out_dtypes, name, interpret):
    tiles, cs = st.shape
    r = rays.shape[2]
    c, rows, k = blocks_t.shape
    row_spec = pl.BlockSpec((None, cs), lambda i: (i, 0))
    out_spec = pl.BlockSpec((None, r), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(kernel, n_cols=cs, k=k, sub=sub_cols(k)),
        grid=(tiles,),
        in_specs=[row_spec, row_spec,
                  pl.BlockSpec((None, RAY_ROWS, r), lambda i: (i, 0, 0)),
                  pl.BlockSpec((c, rows, k), lambda i: (0, 0, 0))],
        out_specs=[out_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((tiles, r), dt)
                   for dt in out_dtypes],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name=name,
    )(st, si, rays, blocks_t)


def sub_cols(k: int) -> int:
    """Triangle columns per tested sub-block for cluster size k."""
    return min(k, SUB_COLS)


def pack_rays(o, d, cap):
    """Kernel ray operand f32[tiles, RAY_ROWS, R] from per-tile o/d
    [tiles, R, 3] and cap [tiles, R]."""
    pad = jnp.zeros_like(cap)
    return jnp.concatenate(
        [jnp.swapaxes(o, 1, 2), jnp.swapaxes(d, 1, 2), cap[:, None, :],
         pad[:, None, :]], axis=1)


def sweep_closest(st, si, rays, blocks_t, t_min, interpret=False):
    """Closest-hit sweep over all tiles.

    st/si: f32/i32[tiles, Cs] near-to-far schedule (inf-padded entries
    point at cluster 0); rays: f32[tiles, RAY_ROWS, R] from pack_rays with
    the per-ray scene-exit cap; blocks_t: f32[C, 16, K]. Returns
    (t, tri, u, v), each [tiles, R]; tri = -1 where nothing was hit.
    """
    return tuple(_call(
        functools.partial(_closest_kernel, t_min=float(t_min)),
        st, si, rays, blocks_t,
        (jnp.float32, jnp.int32, jnp.float32, jnp.float32),
        "sweep_closest", interpret))


def sweep_occluded(st, si, rays, blocks_t, interpret=False,
                   want_blocker=False):
    """Any-hit sweep. rays carries the per-ray t_max in its cap row.

    Returns blocked i32[tiles, R] (1 = blocked); with want_blocker,
    (blocked, blocker_tri i32[tiles, R], -1 where open).
    """
    out = _call(
        functools.partial(_occluded_kernel, want_blocker=want_blocker),
        st, si, rays, blocks_t,
        (jnp.int32,) * (2 if want_blocker else 1),
        "sweep_occluded", interpret)
    return tuple(out) if want_blocker else out[0]
