"""Triton cull exactness vs the XLA _tile_cull (same contract).

The Triton cull (kernels/triton_cull.py) must return bit-identical
tile_tnear to packet._tile_cull: same slab test, same accept condition,
same entry clamp, same +inf fill, and min is exact. Runs the kernel the
GPU compiles in the Pallas interpreter on CPU (interpret=True).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel.cluster import build_clusters
from pathtracer.kernels import packet, triton_cull
from pathtracer.kernels.triton_cull import tile_cull


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed=1, park_tail=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park_tail:
        o[-park_tail:] = packet._PARK
        d[-park_tail:] = np.array([0.0, 0.0, 1.0], np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _both(accel, o, d, t_min, t_max, tile_rays=packet.TILE_RAYS):
    n_tiles = o.shape[0] // tile_rays
    ref = packet._tile_cull(accel, o, d, t_min, t_max, n_tiles, tile_rays)
    got = tile_cull(accel.aabb_lo, accel.aabb_hi, o, packet._safe_inv(d),
                    t_max, t_min=t_min, n_tiles=n_tiles, tile_rays=tile_rays,
                    interpret=True)
    assert got.shape == ref.shape == (n_tiles, accel.n_clusters)
    return np.asarray(got), np.asarray(ref)


def test_pallas_cull_matches_xla_cull():
    """Parked tail rays (t_max 0) and live rays in the same tiles."""
    accel = build_clusters(*map(jnp.asarray, _soup(500)), max_clusters=16)
    o, d = _rays(512, park_tail=70)
    t_max = np.full((512,), 1e20, np.float32)
    t_max[-70:] = 0.0
    got, ref = _both(accel, o, d, 1e-3, jnp.asarray(t_max))
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(ref).any() and np.isinf(ref).any()


def test_pallas_cull_nonmultiple_lane_clusters():
    """C not a multiple of CULL_COLS exercises the far-box padding."""
    accel = build_clusters(*map(jnp.asarray, _soup(90, seed=3)),
                           max_clusters=8)
    assert accel.n_clusters % triton_cull.CULL_COLS
    o, d = _rays(128, seed=4)
    got, ref = _both(accel, o, d, 0.0, jnp.full((128,), 50.0, jnp.float32))
    np.testing.assert_array_equal(got, ref)


def test_triton_cull_several_column_blocks():
    """More clusters than one CULL_COLS block, spread into distant islands
    with a short t_max, so whole blocks miss every ray of a tile."""
    v0, v1, v2 = _soup(3000, seed=11)
    off = (np.arange(3000)[:, None] // 300).astype(np.float32) * 25.0
    accel = build_clusters(*(jnp.asarray(v + off) for v in (v0, v1, v2)),
                           max_clusters=512, min_k=4)
    assert accel.n_clusters > 2 * triton_cull.CULL_COLS
    o, d = _rays(256, seed=12)
    got, ref = _both(accel, o, d, 1e-3, jnp.float32(40.0))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tile_rays", [16, 32, 128])
def test_triton_cull_tile_widths(tile_rays):
    accel = build_clusters(*map(jnp.asarray, _soup(400, seed=5)),
                           max_clusters=32)
    o, d = _rays(256, seed=6)
    got, ref = _both(accel, o, d, 1e-3, jnp.float32(1e20),
                     tile_rays=tile_rays)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cull,backend,name", [
    ("ray", "triton", "cull_triton"),
    ("ray", "xla", "_tile_cull"),
    ("frustum", "triton", "_frustum_cull"),
    ("frustum", "xla", "_frustum_cull"),
])
def test_cull_choice_follows_route(cull, backend, name):
    assert packet._cull_fn(cull, backend).__name__ == name
