"""Triton sweep kernel exactness vs the brute-force oracle.

Runs the Pallas Triton kernels the GPU compiles (kernels/triton_sweep.py)
in the Pallas interpreter on CPU, which the explicit interpret=True asks
for. Small sizes: the interpreter walks every program of the grid.
"""

import jax.numpy as jnp
import numpy as np

from pathtracer.accel.cluster import build_clusters
from pathtracer.kernels.intersect import intersect_brute, occluded_brute
from pathtracer.kernels.packet import intersect_clusters, occluded_clusters


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_pallas_closest_matches_bruteforce():
    v0, v1, v2 = _soup(300)
    o, d = _rays(700)
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    hp = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, backend="triton", interpret=True)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hr.tri))
    both = np.asarray(hp.tri) >= 0
    assert both.sum() > 0
    np.testing.assert_allclose(np.asarray(hp.t)[both], np.asarray(hr.t)[both],
                               rtol=1e-4, atol=1e-5)


def test_pallas_occlusion_matches_bruteforce():
    v0, v1, v2 = _soup(300)
    o, d = _rays(700)
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    op = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max, backend="triton",
                                      interpret=True))
    obr = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                    jnp.asarray(v0), jnp.asarray(v1),
                                    jnp.asarray(v2)))
    np.testing.assert_array_equal(op, obr)


def test_pallas_ragged_and_tiny():
    v0, v1, v2 = _soup(33, seed=7)
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=4)
    for n in (1, 130, 257):
        o, d = _rays(n, seed=n)
        hp = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                1e20, backend="triton", interpret=True)
        hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                             jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
        np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hr.tri))


def test_pallas_cpi_not_dividing_128_keeps_tail():
    """A long schedule must be walked to its last entry.

    The scene threads rays through 128 ring-shaped clusters (no hit, so no
    early exit) to a wall that only the farthest schedule entry holds: a
    sweep that drops or clamps tail schedule entries misses the wall.
    """
    rng = np.random.default_rng(11)
    slabs, per = 128, 128          # -> K=128, C=128 clusters
    v0l, v1l, v2l = [], [], []
    for i in range(slabs):
        n = per
        if i == slabs - 1:
            # far wall covering the corridor axis
            v0l.append([[float(i), -2.0, -2.0]])
            v1l.append([[float(i), 4.0, -2.0]])
            v2l.append([[float(i), -2.0, 4.0]])
            n -= 1
        # ring triangles that never cover the (y,z)=(0,0) corridor
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.25, 0.5, n)  # small rings: x stays the
        # longest axis at every median level -> slab-aligned clusters
        cy, cz = rad * np.cos(ang), rad * np.sin(ang)
        x = np.full(n, float(i)) + rng.uniform(-0.1, 0.1, n)
        a = np.stack([x, cy, cz], 1)
        v0l.append(a)
        v1l.append(a + rng.uniform(0.01, 0.1, (n, 3)) * [0, 1, 0])
        v2l.append(a + rng.uniform(0.01, 0.1, (n, 3)) * [0, 0, 1])
    v0 = np.concatenate(v0l).astype(np.float32)
    v1 = np.concatenate(v1l).astype(np.float32)
    v2 = np.concatenate(v2l).astype(np.float32)
    # one tile of near-axis rays marching down the corridor
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = -2.0
    o[:, 1:] = rng.uniform(-0.05, 0.05, (64, 2))
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (64, 1))
    # median splits along the (dominant) x axis keep slabs contiguous, so
    # every cluster is a full ring containing the corridor axis and the
    # tile's schedule holds all ~125 entries
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=128, method="median")
    assert accel.n_clusters >= 121
    hp = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, backend="triton", interpret=True)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    assert (np.asarray(hr.tri) >= 0).all()   # every ray hits the far wall
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hr.tri))


def test_pallas_occlusion_blocker_hints():
    """want_blocker through the Pallas kernel (interpret mode on CPU):
    blocked bits unchanged, hints re-verify as real in-segment blockers."""
    from pathtracer.kernels.intersect import ray_triangle
    from pathtracer.utils import vmath

    v0, v1, v2 = (jnp.asarray(a) for a in _soup(300))
    o, d = (jnp.asarray(a) for a in _rays(700))
    accel = build_clusters(v0, v1, v2, max_clusters=16)
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    obr = np.asarray(occluded_brute(o, d, t_max, v0, v1, v2))
    bl, btri = occluded_clusters(accel, o, d, t_max, backend="triton",
                                 interpret=True,
                                 want_blocker=True)
    bl_np, bt_np = np.asarray(bl), np.asarray(btri)
    np.testing.assert_array_equal(bl_np, obr)
    assert (bt_np[bl_np] >= 0).all()
    assert (bt_np[~bl_np] == -1).all()
    idx = jnp.asarray(np.maximum(bt_np, 0))
    t, _, _, ok = ray_triangle(o, d, v0[idx], v1[idx], v2[idx], 0.0, t_max)
    gn = vmath.cross(v1[idx] - v0[idx], v2[idx] - v0[idx])
    front = vmath.dot(d, gn) < 0.0
    assert np.asarray(ok & front)[bl_np].all()
