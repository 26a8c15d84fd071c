"""Knob-COMBINATION exactness matrix.

Every PT_* knob is exactness-pinned individually; this sweeps a sampled
set of knob COMBINATIONS (build method x key scheme x chunking x cull x
backend x sort scope) against the brute-force oracle so interactions
between independently-tested features can't silently break traversal
exactness (the knobs all compose in kernels/packet.py closures).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer.accel.cluster import build_clusters
from pathtracer.kernels.intersect import intersect_brute
from pathtracer.kernels.packet import intersect_clusters, occluded_clusters


def _scene(seed=4, n=260):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    v0 = base
    v1 = base + rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    return map(jnp.asarray, (v0, v1, v2))


def _rays(seed=9, n=192):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


COMBOS = [
    # (method, env overrides, intersect kwargs)
    ("sahsplit", {"PT_KEY_SCHEME": "firstcluster",
                  "PT_KEY_SCHEME_OCCL": "firstcluster"},
     dict(backend="triton", interpret=True)),
    ("sahleaf", {"PT_KEY_SCHEME": "mixed", "PT_DIR_BITS": "3"},
     dict(backend="triton", interpret=True, chunk_rays=128)),
    ("median", {"PT_SORT_SCOPE": "chunk", "PT_KEY_SCHEME_OCCL": "dirmajor"},
     dict(backend="xla", chunk_rays=64)),
    ("morton", {"PT_KEY_SCHEME": "firstcluster"},
     dict(backend="triton", interpret=True, cull="frustum")),
    ("sahsplit", {"PT_NATIVE_BUILD": "0", "PT_SAH_DUP": "3.0"},
     dict(backend="triton", interpret=True, tile_rays=32)),
]


@pytest.mark.parametrize("method,env,kw", COMBOS)
def test_knob_combo_exactness(method, env, kw, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    v0, v1, v2 = _scene()
    o, d = _rays()
    accel = build_clusters(v0, v1, v2, 8, min_k=8, method=method)
    ref = intersect_brute(o, d, v0, v1, v2, 1e-3, 1e20)

    hit = intersect_clusters(accel, o, d, 1e-3, 1e20, **kw)
    np.testing.assert_array_equal(np.asarray(hit.tri) >= 0,
                                  np.asarray(ref.tri) >= 0)
    m = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)

    # occlusion against brute any-front-hit below the same t_max
    t_max = jnp.full((o.shape[0],), 6.0)
    occ_kw = {k: v for k, v in kw.items() if k != "cull"}
    blocked = occluded_clusters(accel, o, d, t_max, **occ_kw)
    gn = np.cross(np.asarray(v1 - v0), np.asarray(v2 - v0))
    front = (np.asarray(d) @ gn.T) < 0.0
    tb, ub, vb, okb = _brute_all(o, d, v0, v1, v2)
    ref_blocked = ((okb & front & (tb > 0.0) & (tb < 6.0)).any(axis=1))
    np.testing.assert_array_equal(np.asarray(blocked), ref_blocked)


def _brute_all(o, d, v0, v1, v2):
    """All-pairs MT: t/u/v/ok [N, T] (no reduction - occlusion oracle)."""
    from pathtracer.kernels.intersect import DET_EPS

    o = np.asarray(o)[:, None, :]
    dd = np.asarray(d)[:, None, :]
    e1 = np.asarray(v1 - v0)[None]
    e2 = np.asarray(v2 - v0)[None]
    b0 = np.asarray(v0)[None]
    p = np.cross(dd, e2)
    det = np.sum(e1 * p, axis=-1)
    inv = np.where(np.abs(det) > DET_EPS, 1.0 / np.where(det == 0, 1, det),
                   0.0)
    tv = o - b0
    u = np.sum(tv * p, axis=-1) * inv
    q = np.cross(tv, e1)
    v = np.sum(dd * q, axis=-1) * inv
    t = np.sum(e2 * q, axis=-1) * inv
    ok = ((np.abs(det) > DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1))
    return t, u, v, ok
