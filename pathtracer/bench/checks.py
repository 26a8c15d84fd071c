"""Comparisons that gate a device run against a reference, with tolerances.

Shared by chip_smoke.py (on the card, at real widths), the gpu-marked
tests and benchmarks/run_configs.py. Each returns a JSON-ready dict with
an "ok" verdict beside the numbers it was decided on.

Tolerances and why they are not zero: nearest-hit winners at silhouettes
flip when two routes round a hit distance one ulp apart (a different
fused multiply-add order, or the Baldwin-Weber kernel against the brute
Moller-Trumbore), so traversal routes are compared by the share of rays
that agree and by distances where they agree; images by a robust gate
that tolerates a few flipped winners but not a shift of every pixel.
Distances get an absolute floor beside the relative bound: near the
origin of a bounce (t ~ t_min) two correct formulas differ by the float
spacing of the scene's coordinates, not by a share of t.
"""

from __future__ import annotations

import numpy as np

ID_AGREE = 0.999        # share of rays whose hit triangle (or bit) agrees
T_RTOL = 1e-4           # relative hit-distance tolerance where ids agree
T_ATOL = 1e-5           # absolute floor (world units; t_min is 1e-3)
EDGE_EPS = 1e-5         # barycentric slack when re-verifying a blocker
RMSE_TOL = 5e-3         # image inlier RMSE (|diff| <= 98th percentile)
OUTLIER_TOL = 0.02      # share of pixels allowed to flip a winner
MEAN_TOL = 1e-3         # relative mean-radiance agreement


def compare_closest(ref_tri, ref_t, tri, t, min_agree=ID_AGREE,
                    rtol=T_RTOL, atol=T_ATOL):
    """Closest hits vs a reference: id agreement, then t where ids agree
    (|t - ref_t| <= rtol * |ref_t| + atol on every such ray).

    Misses (tri < 0) agree with misses whatever their t.
    """
    ref_tri, tri = np.asarray(ref_tri), np.asarray(tri)
    ref_t, t = np.asarray(ref_t, np.float64), np.asarray(t, np.float64)
    same = ref_tri == tri
    agree = float(same.mean()) if same.size else 0.0
    hit = same & (ref_tri >= 0)
    err = np.abs(t[hit] - ref_t[hit])
    rel = err / np.maximum(np.abs(ref_t[hit]), 1e-30)
    n_out = int((err > rtol * np.abs(ref_t[hit]) + atol).sum())
    return {"ok": bool(agree >= min_agree and n_out == 0
                       and same.size > 0),
            "rays": int(same.size), "id_agree": agree,
            "hits": int(hit.sum()), "t_outside_tol": n_out,
            "t_max_rel": float(rel.max()) if rel.size else 0.0,
            "t_max_abs": float(err.max()) if err.size else 0.0,
            "min_agree": min_agree, "rtol": rtol, "atol": atol}


def compare_blocked(ref, got, min_agree=ID_AGREE):
    """Any-hit bits vs a reference: share of rays that agree."""
    ref, got = np.asarray(ref, bool), np.asarray(got, bool)
    agree = float((ref == got).mean()) if ref.size else 0.0
    return {"ok": bool(agree >= min_agree and ref.size > 0),
            "rays": int(ref.size), "agree": agree,
            "blocked": int(got.sum()), "min_agree": min_agree}


def verify_blockers(o, d, t_max, v0, v1, v2, blocked, btri,
                    edge_eps=EDGE_EPS, rtol=T_RTOL):
    """Every reported blocker is a real front-facing hit in (0, t_max).

    Re-verified with the brute Moller-Trumbore test, widened by edge_eps
    in barycentric units and rtol at the segment's end, where the two
    tests round differently; `strict_misses` counts hints that only the
    widened test accepts. Open rays must report -1. o/d/t_max are the
    rays, v0/v1/v2 the triangle table the ids index.
    """
    from pathtracer.utils import vmath

    import jax.numpy as jnp

    blocked = np.asarray(blocked, bool)
    btri = np.asarray(btri)
    idx = jnp.asarray(np.maximum(btri, 0))
    a, b, c = v0[idx], v1[idx], v2[idx]
    e1, e2 = b - a, c - a
    p = vmath.cross(d, e2)
    det = vmath.dot(e1, p)
    inv = jnp.where(det != 0.0, 1.0 / det, 0.0)
    s = o - a
    u = vmath.dot(s, p) * inv
    q = vmath.cross(s, e1)
    v = vmath.dot(d, q) * inv
    t = vmath.dot(e2, q) * inv
    front = vmath.dot(d, vmath.cross(e1, e2)) < 0.0

    def inside(eps, t_hi):
        return np.asarray((u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
                          & (t > 0.0) & (t < t_hi) & front & (det != 0.0))

    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), t.shape)
    strict = inside(0.0, t_max)
    real = inside(edge_eps, t_max * (1.0 + rtol))
    n_bad = int((blocked & ~real).sum() + (blocked & (btri < 0)).sum()
                + (~blocked & (btri != -1)).sum())
    return {"ok": n_bad == 0, "blocked": int(blocked.sum()),
            "bad_hints": n_bad,
            "strict_misses": int((blocked & real & ~strict).sum()),
            "edge_eps": edge_eps, "rtol": rtol}


def compare_exact(ref, got):
    """Bit-for-bit agreement of two arrays (inf == inf)."""
    ref, got = np.asarray(ref), np.asarray(got)
    same = ref.shape == got.shape
    bad = int((ref != got).sum()) if same else -1
    return {"ok": bool(same and bad == 0 and ref.size > 0),
            "shape": list(got.shape), "mismatches": bad,
            "finite": int(np.isfinite(got).sum())}


def cull_check(accel, o, d, n_rays, interpret=False):
    """The Triton cull against the XLA cull on the first n_rays rays
    (a whole number of tiles), coherence-sorted as a traversal call
    sorts them: the two must agree bit for bit."""
    import jax
    import jax.numpy as jnp

    from pathtracer.kernels import packet

    tr = packet.TILE_RAYS
    n = n_rays // tr * tr
    key = packet._coherence_key(accel, o[:n], d[:n], 3)
    o, d, t_max, _ = packet._sort_rays_by_key(
        key, o[:n], d[:n], jnp.full((n,), 1e20, jnp.float32))

    def cull(backend):
        fn = packet._cull_fn("ray", backend, interpret)
        return jax.jit(lambda o, d, tm: fn(accel, o, d, 1e-3, tm, n // tr,
                                           tr))(o, d, t_max)

    return compare_exact(cull("xla"), cull("triton"))


def kernel_checks(scene, cfg, camera, n_rays, n_brute, backend="auto",
                  interpret=False):
    """The traversal route against its references on a real bounce-1
    batch.

    Traces n_rays cosine-scattered bounce-1 rays (bench/pair_metrics
    .bounce1_rays) through `backend` and compares, closest and any-hit,
    with the XLA sweep on every ray and with the brute-force oracles on
    n_brute evenly spaced rays; blocker hints must re-verify. Closest
    hits traverse the fine accel, any-hit the coarse one, as in
    render.make_intersectors. Any-hit
    segments end at a random fraction (0.3-1.5) of the closest hit, so
    both blocked and open rays occur. On the "triton" route the cull of
    one production chunk must also match the XLA cull bit for bit.
    Returns [(name, result)], every result carrying "ok".
    """
    import jax
    import jax.numpy as jnp

    from pathtracer.bench.pair_metrics import bounce1_rays
    from pathtracer.kernels import packet
    from pathtracer.kernels.intersect import intersect_brute, occluded_brute

    fine = scene.clusters_fine if scene.clusters_fine is not None \
        else scene.clusters
    o, d = bounce1_rays(scene, cfg, camera, n_rays)
    v0, v1, v2 = scene.tri_vertices(jnp.arange(scene.n_tris))
    sub = slice(0, n_rays, max(1, n_rays // n_brute))

    def closest(backend):
        return jax.jit(lambda o, d: packet.intersect_clusters(
            fine, o, d, 1e-3, 1e20, backend=backend,
            interpret=interpret))(o, d)

    def occluded(backend, tm, want_blocker=False):
        return jax.jit(lambda o, d, tm: packet.occluded_clusters(
            scene.clusters, o, d, tm, backend=backend, interpret=interpret,
            want_blocker=want_blocker))(o, d, tm)

    hk, hx = closest(backend), closest("xla")
    hb = jax.jit(lambda o, d: intersect_brute(o, d, v0, v1, v2, 1e-3, 1e20))(
        o[sub], d[sub])
    u = jax.random.uniform(jax.random.PRNGKey(0), (n_rays,), minval=0.3,
                           maxval=1.5)
    tmax = jnp.where(jnp.isfinite(hx.t), hx.t * u, 5.0 * u)
    bk, bx = occluded(backend, tmax), occluded("xla", tmax)
    bw, btri = occluded(backend, tmax, want_blocker=True)
    ob = jax.jit(lambda o, d, tm: occluded_brute(o, d, tm, v0, v1, v2))(
        o[sub], d[sub], tmax[sub])
    results = [
        ("closest_vs_xla", compare_closest(hx.tri, hx.t, hk.tri, hk.t)),
        ("closest_vs_brute", compare_closest(hb.tri, hb.t, hk.tri[sub],
                                             hk.t[sub])),
        ("anyhit_vs_xla", compare_blocked(bx, bk)),
        ("anyhit_vs_brute", compare_blocked(ob, np.asarray(bk)[sub])),
        ("anyhit_blocker_bits", compare_blocked(bk, bw)),
        ("anyhit_blockers_verify", verify_blockers(o, d, tmax, v0, v1, v2,
                                                   bw, btri)),
    ]
    if packet.resolve_backend(backend, interpret=interpret) == "triton":
        results.append(("cull_vs_xla", cull_check(
            fine, o, d, min(n_rays, packet.CHUNK_TILES * packet.TILE_RAYS),
            interpret)))
    return results


def image_gate(img, ref):
    """Robust same-seed image comparison (see module docstring).

    inlier RMSE over pixels whose |diff| is within the 98th percentile,
    the share of pixels off by more than 0.01, and the relative shift of
    the mean. Real behavioural drift moves every pixel (fails the inlier
    and mean terms) or many (fails the outlier term).
    """
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = img - ref
    ad = np.abs(diff).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    inlier_rmse = float(np.sqrt(np.mean(diff[inl] ** 2)))
    outlier_frac = float((ad > 0.01).mean())
    mean_rel = abs(float(img.mean()) - float(ref.mean())) / max(
        abs(float(ref.mean())), 1e-6)
    return {"ok": bool(inlier_rmse <= RMSE_TOL and outlier_frac <= OUTLIER_TOL
                       and mean_rel <= MEAN_TOL),
            "inlier_rmse": inlier_rmse, "outlier_frac": outlier_frac,
            "mean_rel": mean_rel}
