"""Packet (tile) traversal exactness vs the brute-force oracle.

Same contract as tests/test_lbvh.py (SURVEY.md par.4.1: "the brute-force
intersector IS the mock"): identical hit triangle ids, near-equal distances,
identical occlusion bits - across random soups, duplicate centroids, tiny
scenes, and ray counts that don't divide the tile size.
"""

import jax.numpy as jnp
import numpy as np

from pathtracer.accel.cluster import build_clusters
from pathtracer.kernels.intersect import intersect_brute, occluded_brute
from pathtracer.kernels.packet import (intersect_clusters,
                                       occluded_clusters)


def _check_match(v0, v1, v2, o, d, max_clusters=64):
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=max_clusters)
    hp = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e20)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hr.tri))
    both = np.asarray(hp.tri) >= 0
    np.testing.assert_allclose(np.asarray(hp.t)[both], np.asarray(hr.t)[both],
                               rtol=1e-4, atol=1e-5)


def test_packet_matches_bruteforce(random_tri_soup, random_rays):
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    _check_match(v0, v1, v2, o, d)


def test_packet_single_cluster(random_tri_soup, random_rays):
    """Everything in one cluster degenerates to dense brute force."""
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    _check_match(v0, v1, v2, o, d, max_clusters=1)


def test_packet_occlusion_matches(random_tri_soup, random_rays):
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=64)
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    op = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max))
    obr = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                    jnp.asarray(v0), jnp.asarray(v1),
                                    jnp.asarray(v2)))
    np.testing.assert_array_equal(op, obr)


def test_packet_ragged_ray_count(random_tri_soup):
    """Ray counts that don't divide TILE_RAYS are padded correctly."""
    v0, v1, v2 = random_tri_soup
    rng = np.random.default_rng(3)
    for n in (1, 7, 255, 257, 1000):
        o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        _check_match(v0, v1, v2, o, d)


def test_packet_tiny_scenes(random_rays):
    o, d = random_rays
    rng = np.random.default_rng(9)
    for t in (1, 2, 3, 17):
        v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
        v1 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
        v2 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
        _check_match(v0, v1, v2, o, d)


def test_packet_duplicate_centroids(random_rays):
    o, d = random_rays
    rng = np.random.default_rng(5)
    base = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    v0 = np.repeat(base, 8, axis=0)
    off = rng.uniform(-0.2, 0.2, (80, 3)).astype(np.float32)
    v1 = v0 + off
    v2 = v0 - off + rng.uniform(-0.1, 0.1, (80, 3)).astype(np.float32)
    _check_match(v0, v1, v2, o, d)


def test_cluster_methods_partition_and_agree():
    """All cluster builds (morton/median/sah/sahleaf/sahdeep) are exact partitions
    and produce identical closest hits - clustering is a scheduling
    choice, never a correctness one."""
    import numpy as np

    from pathtracer.accel.cluster import build_clusters
    from pathtracer.kernels.intersect import intersect_brute
    from pathtracer.kernels.packet import intersect_clusters

    rng = np.random.default_rng(17)
    t = 700                      # forces padding in every method
    v0 = jnp.asarray(rng.uniform(-2, 2, (t, 3)).astype(np.float32))
    v1 = v0 + jnp.asarray(rng.uniform(-.3, .3, (t, 3)).astype(np.float32))
    v2 = v0 + jnp.asarray(rng.uniform(-.3, .3, (t, 3)).astype(np.float32))
    n = 256
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

    ref = intersect_brute(o, d, v0, v1, v2, 1e-3, 1e20)
    for method in ("morton", "median", "sah", "sahleaf", "sahdeep",
                   "sahsplit"):
        accel = build_clusters(v0, v1, v2, 8, method=method)
        ids = np.asarray(accel.blocks[..., 9].reshape(-1))
        ids = np.round(ids).astype(np.int64) - 1
        if method == "sahsplit":
            # spatial splits DUPLICATE straddling tris into clipped-box
            # clusters (SBVH); coverage, not partition, is the invariant
            assert np.array_equal(np.unique(ids[ids >= 0]),
                                  np.arange(t)), method
        else:
            assert np.array_equal(np.sort(ids[ids >= 0]),
                                   np.arange(t)), method
        hit = intersect_clusters(accel, o, d, 1e-3, 1e20)
        # tri ids may differ on exact-tie hits (visit order is a
        # scheduling choice); the hit/miss SETS (tri >= 0 - the brute
        # oracle encodes misses as t=1e20, packet as inf) and the hit
        # DISTANCES must agree exactly
        np.testing.assert_array_equal(
            np.asarray(hit.tri) >= 0, np.asarray(ref.tri) >= 0,
            err_msg=method)
        m = np.asarray(ref.tri) >= 0
        np.testing.assert_allclose(np.asarray(hit.t)[m],
                                   np.asarray(ref.t)[m],
                                   rtol=1e-5, err_msg=method)


def test_sahsplit_architectural_exactness():
    """Spatial splits on BIG straddling triangles stay exact.

    A room made of a few huge floor/wall triangles plus small clutter is
    the case spatial splits exist for (a random soup barely triggers
    them): the floor tris straddle every split plane, get duplicated
    into clipped-box clusters, and cluster AABBs become clipped unions.
    Closest hits AND occlusion bits must still match brute force - the
    clipped cull is conservative and the full-tri MT only adds true
    hits (accel/cluster.py:_sah_split_leaves)."""
    rng = np.random.default_rng(23)
    quads = [  # floor, ceiling, two walls: 2 tris each, 20x20 units
        ((-10, 0, -10), (10, 0, -10), (10, 0, 10), (-10, 0, 10)),
        ((-10, 8, -10), (10, 8, -10), (10, 8, 10), (-10, 8, 10)),
        ((-10, 0, -10), (10, 0, -10), (10, 8, -10), (-10, 8, -10)),
        ((-10, 0, 10), (10, 0, 10), (10, 8, 10), (-10, 8, 10)),
    ]
    tv0, tv1, tv2 = [], [], []
    for a, b, c, dq in quads:
        tv0 += [a, a]
        tv1 += [b, c]
        tv2 += [c, dq]
    # small clutter so the builder has something to split around
    base = rng.uniform(-9, 9, (600, 3)).astype(np.float32)
    base[:, 1] = rng.uniform(0.2, 7.5, 600)
    tv0 = np.concatenate([np.array(tv0, np.float32), base])
    tv1 = np.concatenate([np.array(tv1, np.float32),
                          base + rng.uniform(-.4, .4, (600, 3))
                          .astype(np.float32)])
    tv2 = np.concatenate([np.array(tv2, np.float32),
                          base + rng.uniform(-.4, .4, (600, 3))
                          .astype(np.float32)])
    v0, v1, v2 = map(jnp.asarray, (tv0, tv1, tv2))

    n = 512
    o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 7.5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    accel = build_clusters(v0, v1, v2, 8, method="sahsplit")
    refs = int((np.round(np.asarray(accel.blocks[..., 9])) >= 1.0).sum())
    assert refs > tv0.shape[0], \
        "spatial splits never triggered - test scene too tame"
    hit = intersect_clusters(accel, o, d, 1e-3, 1e20)
    ref = intersect_brute(o, d, v0, v1, v2, 1e-3, 1e20)
    np.testing.assert_array_equal(np.asarray(hit.tri) >= 0,
                                  np.asarray(ref.tri) >= 0)
    m = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)

    t_max = jnp.full(n, 6.0, jnp.float32)
    oc = np.asarray(occluded_clusters(accel, o, d, t_max))
    obr = np.asarray(occluded_brute(o, d, t_max, v0, v1, v2))
    np.testing.assert_array_equal(oc, obr)


# (the windowed two-phase traversal and reversed-shadow-ray variants were
# measured-rejected options and were removed)


def test_per_ray_tmax():
    """intersect_clusters honors a per-ray t_max cap."""
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1),
                           jnp.asarray(v2), max_clusters=4)
    full = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                              1e-3, 1e20)
    tmax = np.where(np.arange(128) % 2 == 0, 1e20, 1e-2).astype(np.float32)
    capped = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                1e-3, jnp.asarray(tmax))
    ft = np.asarray(full.t)
    ct = np.asarray(capped.tri)
    # even lanes unchanged; odd lanes only report hits below their cap
    np.testing.assert_array_equal(ct[::2], np.asarray(full.tri)[::2])
    odd_hits = ct[1::2] >= 0
    assert np.all(ft[1::2][odd_hits] <= 1e-2 * 1.0002)


def test_global_sort_chunked_launches(random_tri_soup, random_rays):
    """Wavefronts bigger than one chunk: global sort + chunked launches.

    Forces the n > chunk_rays path (global coherence sort, lax.map over
    chunks, inverse permute at the end) with a tiny chunk size and checks
    exactness for both closest-hit and occlusion against the unchunked
    result and the brute oracle.
    """
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    hc = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, chunk_rays=128, sort_rays=True)
    np.testing.assert_array_equal(np.asarray(hc.tri), np.asarray(hr.tri))
    both = np.asarray(hc.tri) >= 0
    np.testing.assert_allclose(np.asarray(hc.t)[both], np.asarray(hr.t)[both],
                               rtol=1e-4, atol=1e-5)
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    ob = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                   jnp.asarray(v0), jnp.asarray(v1),
                                   jnp.asarray(v2)))
    oc = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max, chunk_rays=128, sort_rays=True))
    np.testing.assert_array_equal(oc, ob)


def test_sort_scope_chunk_matches(random_tri_soup, random_rays, monkeypatch):
    """PT_SORT_SCOPE=chunk (per-chunk sort pool) stays exact.

    The production default sorts the whole wavefront once (global
    pool); the chunk scope re-sorts inside each launch. Both
    must agree with the brute oracle.
    """
    monkeypatch.setenv("PT_SORT_SCOPE", "chunk")
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    hc = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, chunk_rays=128, sort_rays=True)
    np.testing.assert_array_equal(np.asarray(hc.tri), np.asarray(hr.tri))
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    ob = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                   jnp.asarray(v0), jnp.asarray(v1),
                                   jnp.asarray(v2)))
    oc = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max, chunk_rays=128, sort_rays=True))
    np.testing.assert_array_equal(oc, ob)


def test_mixed_key_scheme_matches(random_tri_soup, random_rays, monkeypatch):
    """PT_KEY_SCHEME=mixed (6D-interleaved coherence key) stays exact.

    The key only changes the sort order - a pure scheduling choice - so
    closest hits and occlusion must still match the brute oracle.
    """
    monkeypatch.setenv("PT_KEY_SCHEME", "mixed")
    monkeypatch.setenv("PT_DIR_BITS", "3")
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    hc = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, chunk_rays=128, sort_rays=True)
    np.testing.assert_array_equal(np.asarray(hc.tri), np.asarray(hr.tri))
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    ob = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                   jnp.asarray(v0), jnp.asarray(v1),
                                   jnp.asarray(v2)))
    oc = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max, chunk_rays=128, sort_rays=True))
    np.testing.assert_array_equal(oc, ob)


def test_occluded_blocker_hints(random_tri_soup, random_rays):
    """want_blocker: blocked bits unchanged; hints are REAL blockers.

    Any-hit semantics leave WHICH blocker unspecified, so the contract is:
    (a) the blocked mask equals the plain call and the brute oracle, and
    (b) every returned id re-verifies as a front-facing hit inside the
    segment (the property shadow priming relies on).
    """
    from pathtracer.kernels.intersect import ray_triangle
    from pathtracer.utils import vmath

    v0, v1, v2 = (jnp.asarray(a) for a in random_tri_soup)
    o, d = (jnp.asarray(a) for a in random_rays)
    accel = build_clusters(v0, v1, v2, max_clusters=16)
    t_max = jnp.full(o.shape[0], 2.0, jnp.float32)
    ob = occluded_brute(o, d, t_max, v0, v1, v2)
    bl, btri = occluded_clusters(accel, o, d, t_max, chunk_rays=128,
                                 sort_rays=True, want_blocker=True)
    np.testing.assert_array_equal(np.asarray(bl), np.asarray(ob))
    bl_np, bt_np = np.asarray(bl), np.asarray(btri)
    assert (bt_np[bl_np] >= 0).all()
    assert (bt_np[~bl_np] == -1).all()
    # re-verify each hint: front-facing hit strictly inside the segment
    idx = jnp.asarray(np.maximum(bt_np, 0))
    t, _, _, ok = ray_triangle(o, d, v0[idx], v1[idx], v2[idx], 0.0, t_max)
    gn = vmath.cross(v1[idx] - v0[idx], v2[idx] - v0[idx])
    front = vmath.dot(d, gn) < 0.0
    verified = np.asarray(ok & front)
    assert verified[bl_np].all()

    # brute's want_blocker honors the same contract
    ob2, obt = occluded_brute(o, d, t_max, v0, v1, v2, want_blocker=True)
    np.testing.assert_array_equal(np.asarray(ob2), np.asarray(ob))
    obt_np = np.asarray(obt)
    assert (obt_np[np.asarray(ob)] >= 0).all()


def test_firstcluster_key_scheme_matches(random_tri_soup, random_rays,
                                         monkeypatch):
    """PT_KEY_SCHEME=firstcluster (schedule-prefix key) stays exact."""
    monkeypatch.setenv("PT_KEY_SCHEME", "firstcluster")
    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                           max_clusters=16)
    hr = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                         jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    hc = intersect_clusters(accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            1e20, chunk_rays=128, sort_rays=True)
    np.testing.assert_array_equal(np.asarray(hc.tri), np.asarray(hr.tri))
    t_max = jnp.full(len(o), 2.0, jnp.float32)
    ob = np.asarray(occluded_brute(jnp.asarray(o), jnp.asarray(d), t_max,
                                   jnp.asarray(v0), jnp.asarray(v1),
                                   jnp.asarray(v2)))
    oc = np.asarray(occluded_clusters(accel, jnp.asarray(o), jnp.asarray(d),
                                      t_max, chunk_rays=128, sort_rays=True))
    np.testing.assert_array_equal(oc, ob)


def test_first_cluster_ray_blocking_matches(random_tri_soup, random_rays,
                                            monkeypatch):
    """_first_cluster's ray-axis blocking (spp-batched global sort scope
    can reach ~8M lanes) is a pure memory bound: tiny block size must
    reproduce the single-block result exactly."""
    from pathtracer.kernels import packet

    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1),
                           jnp.asarray(v2), max_clusters=16)
    ref = packet._first_cluster(accel, jnp.asarray(o), jnp.asarray(d))
    monkeypatch.setattr(packet, "FIRSTCLUSTER_RAY_BLOCK", 7)
    blk = packet._first_cluster(accel, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(blk[0]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(blk[1]))


def test_sortnet_permute_matches_gather(random_tri_soup, random_rays,
                                        monkeypatch):
    """PT_PERMUTE=sortnet (payload rides the sort network, no gathers)
    returns identical hits/occlusion to the gather permute. The blocker
    hint is excluded: it is defined as SOME blocker, and tie-order
    between equal coherence keys may legitimately pick different tiles
    (both modes' hints are validated as real blockers instead)."""
    from pathtracer.kernels import packet

    v0, v1, v2 = random_tri_soup
    o, d = random_rays
    accel = build_clusters(jnp.asarray(v0), jnp.asarray(v1),
                           jnp.asarray(v2), max_clusters=16)
    o = jnp.asarray(o)
    d = jnp.asarray(d)
    t_max = jnp.full(len(np.asarray(o)), 2.0, jnp.float32)

    outs = {}
    for mode in ("gather", "sortnet"):
        monkeypatch.setenv("PT_PERMUTE", mode)
        hit = intersect_clusters(accel, o, d, 1e-3, 1e20,
                                 chunk_rays=128, sort_rays=True)
        bl, btri = occluded_clusters(accel, o, d, t_max, chunk_rays=128,
                                     sort_rays=True, want_blocker=True)
        outs[mode] = (hit, np.asarray(bl), np.asarray(btri))

    hg, blg, btg = outs["gather"]
    hs, bls, bts = outs["sortnet"]
    np.testing.assert_array_equal(np.asarray(hs.tri), np.asarray(hg.tri))
    np.testing.assert_array_equal(np.asarray(hs.t), np.asarray(hg.t))
    np.testing.assert_array_equal(np.asarray(hs.u), np.asarray(hg.u))
    np.testing.assert_array_equal(bls, blg)
    assert bls.dtype == blg.dtype
    # every sortnet hint must be a real blocker where blocked
    assert ((bts >= 0) == bls).all()
