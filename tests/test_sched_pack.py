"""Packed u32 schedule sort (PT_SCHED_PACK) vs the two-operand sort.

The packed variant (packet._packed_schedule_sort) replaces the
(f32 entry, i32 id) lax.sort with one u32 sort of (quantized entry <<
12 | cid). Contract it must keep:
  - same finite MEMBERSHIP per tile (which clusters are scheduled),
  - dequantized st is a CONSERVATIVE lower bound of the true entry
    (stop rule never fires early),
  - order is non-decreasing in the true entry up to one quantum,
  - end-to-end intersect/occluded results match the unpacked schedule
    on tie-free geometry,
    membership.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel.cluster import build_clusters
from pathtracer.kernels import packet


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return (jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _tnear(accel, o, d, n_tiles):
    return packet._tile_cull(accel, o, d, 1e-3,
                             jnp.full((o.shape[0],), 1e20, jnp.float32),
                             n_tiles, o.shape[0] // n_tiles)


def test_packed_matches_unpacked_membership_and_bound():
    accel = build_clusters(*_soup(2000), max_clusters=64)
    o, d = _rays(256)
    tn = _tnear(accel, o, d, 4)
    cpi = 4

    os.environ["PT_SCHED_PACK"] = "0"
    st0, si0 = packet._sorted_schedule(tn, cpi)
    os.environ["PT_SCHED_PACK"] = "1"
    try:
        st1, si1 = packet._sorted_schedule(tn, cpi)
    finally:
        os.environ.pop("PT_SCHED_PACK", None)

    st0, si0, st1, si1 = map(np.asarray, (st0, si0, st1, si1))
    tnn = np.asarray(tn)
    assert st0.shape == st1.shape and si0.shape == si1.shape

    for ti in range(tnn.shape[0]):
        f0 = set(si0[ti][np.isfinite(st0[ti])].tolist())
        f1 = set(si1[ti][np.isfinite(st1[ti])].tolist())
        assert f0 == f1, f"membership differs on tile {ti}"
        fin = np.isfinite(st1[ti])
        # conservative lower bound vs the true entry of the SAME cluster
        true = tnn[ti][si1[ti][fin]]
        got = st1[ti][fin]
        assert np.all(got <= true + 1e-6)
        # within one quantum of the truth (20-bit over the batch max)
        quant = 2.0 * float(np.max(true, initial=0.0) + 1.0) / ((1 << 20) - 2)
        assert np.all(true - got <= max(quant, 1e-4) + 1e-3 * true)
        # non-decreasing in quantized order
        assert np.all(np.diff(got) >= -1e-6)


def test_packed_end_to_end_hits_match():
    accel = build_clusters(*_soup(3000, seed=3), max_clusters=64)
    o, d = _rays(512, seed=4)
    t_max = jnp.full((512,), 1e20, jnp.float32)

    os.environ["PT_SCHED_PACK"] = "0"
    h0 = packet.intersect_clusters(accel, o, d, 1e-3, t_max,
                                   backend="xla")
    b0 = packet.occluded_clusters(accel, o, d,
                                  jnp.full((512,), 2.5, jnp.float32),
                                  backend="xla")
    os.environ["PT_SCHED_PACK"] = "1"
    try:
        h1 = packet.intersect_clusters(accel, o, d, 1e-3, t_max,
                                       backend="xla")
        b1 = packet.occluded_clusters(accel, o, d,
                                      jnp.full((512,), 2.5, jnp.float32),
                                      backend="xla")
    finally:
        os.environ.pop("PT_SCHED_PACK", None)
    np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))
    np.testing.assert_array_equal(np.asarray(h0.tri), np.asarray(h1.tri))
    np.testing.assert_array_equal(np.asarray(b0), np.asarray(b1))


def test_packed_pallas_interpret_matches():
    """The packed schedule through the Triton sweep (interpret mode)."""
    accel = build_clusters(*_soup(1500, seed=7), max_clusters=32)
    o, d = _rays(256, seed=8)
    t_max = jnp.full((256,), 1e20, jnp.float32)
    os.environ["PT_SCHED_PACK"] = "0"
    h0 = packet.intersect_clusters(accel, o, d, 1e-3, t_max,
                                   backend="triton", interpret=True)
    os.environ["PT_SCHED_PACK"] = "1"
    try:
        h1 = packet.intersect_clusters(accel, o, d, 1e-3, t_max,
                                       backend="triton", interpret=True)
    finally:
        os.environ.pop("PT_SCHED_PACK", None)
    np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))
    np.testing.assert_array_equal(np.asarray(h0.tri), np.asarray(h1.tri))
