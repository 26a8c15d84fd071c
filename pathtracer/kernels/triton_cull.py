"""Per-ray cluster cull as a Pallas Triton kernel for the GPU.

The same contract as kernels/packet._tile_cull, bit for bit: slab-test
every ray of a tile against every cluster AABB and reduce over the tile's
rays to tile_tnear[tiles, C], the nearest entry distance of any hitting
ray (+inf where none hits). min is exact, so the reduction order cannot
change a bit.

One program handles one tile of R rays and loops over the clusters in
blocks of CULL_COLS columns, so the [R, CULL_COLS] slab-test values live
in registers and are reduced before the next block; the XLA version has
to materialize its [tiles, R, CULL_BLOCK] transients between fusions.
interpret=True runs the kernel in the Pallas interpreter (CPU tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Clusters per loop step and warps per program. Chosen on an H100 (SXM,
# 700 W) among 64/128/256 columns at 4, 8 or 16 warps.
CULL_COLS = 128
NUM_WARPS = 8
# Ray operand rows: ox oy oz, 1/dx 1/dy 1/dz, t_max, pad (a power of two).
RAY_ROWS = 8
_FAR = 1e30            # pad-box corner: no ray reaches it


def _cull_kernel(boxes_ref, rays_ref, out_ref, *, t_min, n_blocks):
    o = [rays_ref[i, :][:, None] for i in range(3)]
    inv = [rays_ref[3 + i, :][:, None] for i in range(3)]
    t_max = rays_ref[6, :][:, None]

    def body(b, carry):
        cols = pl.ds(b * CULL_COLS, CULL_COLS)
        t_near = t_far = None
        for a in range(3):
            t1 = (boxes_ref[a, cols][None, :] - o[a]) * inv[a]
            t2 = (boxes_ref[3 + a, cols][None, :] - o[a]) * inv[a]
            lo, hi = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
            t_near = lo if t_near is None else jnp.maximum(t_near, lo)
            t_far = hi if t_far is None else jnp.minimum(t_far, hi)
        hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max)
        entry = jnp.where(hit, jnp.maximum(t_near, 0.0), jnp.inf)
        out_ref[cols] = jnp.min(entry, axis=0)
        return carry

    jax.lax.fori_loop(0, n_blocks, body, 0)


def tile_cull(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
              tile_rays, interpret=False):
    """tile_tnear f32[n_tiles, C] for rays o/inv_d [n_tiles * tile_rays, 3]
    (inv_d = packet._safe_inv(d)) against boxes aabb_lo/aabb_hi [C, 3].
    t_max is a scalar or per-ray [n]; t_min a Python float."""
    c = aabb_lo.shape[0]
    far = jnp.full(((-c) % CULL_COLS, 3), _FAR, jnp.float32)
    boxes = jnp.concatenate([jnp.concatenate([aabb_lo, far]).T,
                             jnp.concatenate([aabb_hi, far]).T])  # [6, Cp]
    cp = boxes.shape[1]
    n = o.shape[0]
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    rays = jnp.concatenate([o, inv_d, tm[:, None], jnp.zeros((n, 1))],
                           axis=1).astype(jnp.float32)
    rays = jnp.swapaxes(rays.reshape(n_tiles, tile_rays, RAY_ROWS), 1, 2)
    out = pl.pallas_call(
        functools.partial(_cull_kernel, t_min=float(t_min),
                          n_blocks=cp // CULL_COLS),
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((6, cp), lambda i: (0, 0)),
                  pl.BlockSpec((None, RAY_ROWS, tile_rays),
                               lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, cp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles, cp), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="tile_cull",
    )(boxes, rays)
    return out[:, :c]
