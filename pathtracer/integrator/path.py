"""Wavefront path integrator.

The re-design of the reference's device-side renderer for JAX: the
iterative unidirectional path tracer in raygen.rgen:95-307 with surface
interaction fetch from closesthit.rchit and environment light from
miss.rmiss. Where the reference runs one SIMT lane per pixel, this runs a
flat SoA ray batch [N] through a statically-unrolled bounce loop with active
masking - per-lane control flow becomes jnp.where selects (SURVEY.md par.7
"Key idiomatic choices").

Estimator (default, `reference_quirks=False`) - the reference's estimator
with its three documented inconsistencies fixed (SURVEY.md par.3.6.1-3):

- emission gain (x10, raygen.rgen:132) applied to BOTH the BSDF-path hit
  and the NEE estimator, and both use Le = mat.emission * mat.albedo
  (the light list's definition, main.cpp:282-284);
- BSDF-sampled emitter hits are MIS-weighted against the light-sampling
  pdf (power heuristic), closing the double-count;
- BSDF throughput uses the full lobe-mixture pdf (one-sample MIS over
  lobes) rather than the conditional lobe pdf.

With `reference_quirks=True` the reference's exact behavior is reproduced.

Bounce structure per iteration (raygen.rgen:128-292):
  trace -> emission add -> alpha test -> dielectric branch -> NEE+MIS ->
  BSDF sample -> Russian roulette.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from pathtracer.bsdf import microfacet as mf
from pathtracer.config import RenderConfig
from pathtracer.integrator import sky as sky_mod
from pathtracer.kernels.intersect import Hit
from pathtracer.sampling import rng
from pathtracer.scene.types import MAT_DIELECTRIC, Scene
from pathtracer.utils import vmath


class Surface(NamedTuple):
    """Interpolated + textured shading point (HitPayload, common.glsl:9-21)."""

    position: jnp.ndarray   # [N,3]
    normal: jnp.ndarray     # [N,3] shading normal (normal-mapped)
    geom_normal: jnp.ndarray  # [N,3] geometric (for light pdf / facing)
    albedo: jnp.ndarray     # [N,3] linear
    emission: jnp.ndarray   # [N,3]
    roughness: jnp.ndarray  # [N]
    metallic: jnp.ndarray   # [N]
    ior: jnp.ndarray        # [N]
    alpha: jnp.ndarray      # [N]
    mat_type: jnp.ndarray   # [N] i32
    light_pdf_area: jnp.ndarray  # [N] p_select/area if emissive else 0


def _sample_texture(textures, tex_wh, tex_id, u, v, tex_u=None):
    """Bilinear, repeat-wrap texture fetch from the u8 stack.

    textures: u8[K, TH, TW, 4] stored at TRUE per-texture dims (top-left,
    zero-padded to the stack max); tex_wh: i32[K, 2] true (w, h); tex_id:
    i32[N] (-1 = none, clamped to 0 and masked by the caller); u, v:
    f32[N]. Matches the reference's linear-filter repeat sampler
    (texture.cpp:57-66); u8 -> f32 decode happens AFTER the gather so the
    gather moves 4 bytes/texel instead of 16.

    tex_u = (ux, uy) uniforms enables STOCHASTIC bilinear: jitter the
    texel coordinate by the uniform and take ONE nearest tap -
    P(pick x0+1) = frac(x), so the TAP expectation equals the bilinear
    blend of the stored (sRGB) texels. NOTE the pixel estimator is not
    identical to the 4-tap path's: the sRGB decode (**2.2) and the BRDF
    are applied per-tap, and E[f(tap)] != f(E[tap]) through those
    nonlinearities - a small convex bias toward brighter values exists
    exactly at hard texel edges (elsewhere neighboring texels are close
    and the curvature term is negligible). Texture gathers are
    latency-bound, so 1 tap instead of 4 cuts the texture path's gathers
    4x; cfg.stochastic_texture_filtering = False selects the reference's
    exact deterministic sampler.
    """
    tid = jnp.maximum(tex_id, 0)
    wh = tex_wh[tid]                                  # [N, 2]
    twi = wh[:, 0]
    thi = wh[:, 1]
    x = u * twi.astype(jnp.float32) - 0.5
    y = v * thi.astype(jnp.float32) - 0.5

    def texel(yy, xx):
        return textures[tid, yy, xx].astype(jnp.float32) * (1.0 / 255.0)

    if tex_u is not None:
        ux, uy = tex_u
        xi = jnp.mod(jnp.floor(x + ux).astype(jnp.int32), twi)
        yi = jnp.mod(jnp.floor(y + uy).astype(jnp.int32), thi)
        return texel(yi, xi)

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), twi)
    y0i = jnp.mod(y0.astype(jnp.int32), thi)
    x1i = jnp.mod(x0i + 1, twi)
    y1i = jnp.mod(y0i + 1, thi)

    a = texel(y0i, x0i) * (1 - fx) + texel(y0i, x1i) * fx
    b = texel(y1i, x0i) * (1 - fx) + texel(y1i, x1i) * fx
    return a * (1 - fy) + b * fy


def pack_material_rows(scene: Scene) -> jnp.ndarray:
    """Pre-pack per-material properties into ONE wide row (same trick as
    pack_surface_rows): albedo(3) emission(3) roughness metallic ior
    alpha type_val atex_val mrtex_val ntex_val -> f32 [M, 16]. fetch_
    surface then does a single [N,16] row-gather instead of ~10 narrow
    per-property gathers per bounce. Integer fields ride as VALUES + 1
    (exact below 2^24; a bitcast small int would be an f32 denormal).
    """
    f = lambda a: a.astype(jnp.float32)  # noqa: E731
    cols = [scene.mat_albedo, scene.mat_emission,
            scene.mat_roughness[:, None], scene.mat_metallic[:, None],
            scene.mat_ior[:, None], scene.mat_alpha[:, None],
            f(scene.mat_type + 1)[:, None],
            f(scene.mat_albedo_tex + 1)[:, None],
            f(scene.mat_mr_tex + 1)[:, None],
            f(scene.mat_normal_tex + 1)[:, None]]
    rows = jnp.concatenate(cols, axis=1)
    pad = (-rows.shape[1]) % 8
    if pad:
        rows = jnp.concatenate(
            [rows, jnp.zeros((rows.shape[0], pad), jnp.float32)], axis=1)
    return rows


def pack_surface_rows(scene: Scene) -> jnp.ndarray:
    """Pre-gather per-triangle shading attributes into ONE wide row.

    The naive closest-hit fetch is ~14 narrow gathers from large tables
    (indices -> positions/normals/uvs/tangents x3 corners + face material),
    each paying its own latency. One [T, 24|32]-f32 row per triangle turns that into a single wide-row
    gather. Position is NOT stored: it is reconstructed as o + t*d.

    Row layout: n0 n1 n2 (9) | uv0 uv1 uv2 (6) | geom_normal (3) |
    mid_bits (1) | light_pdf_area (1) | [tangents t0 t1 t2 (9)] | pad.
    """
    idx = scene.indices
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    p0 = scene.positions[i0]
    p1 = scene.positions[i1]
    p2 = scene.positions[i2]
    gn = vmath.normalize(vmath.cross(p1 - p0, p2 - p0))
    # material id rides as a float VALUE (mid + 1, exact below 2^24), never
    # a bitcast: small int bit patterns are f32 denormals, which a
    # flush-to-zero vector unit would corrupt
    mid_val = (scene.face_material.astype(jnp.int32) + 1).astype(jnp.float32)
    cols = [scene.normals[i0], scene.normals[i1], scene.normals[i2],
            scene.uvs[i0], scene.uvs[i1], scene.uvs[i2],
            gn, mid_val[:, None], scene.tri_light_pdf_area[:, None]]
    if scene.has_textures:
        cols += [scene.tangents[i0], scene.tangents[i1], scene.tangents[i2]]
    rows = jnp.concatenate(cols, axis=1)
    pad = (-rows.shape[1]) % 8
    if pad:
        rows = jnp.concatenate(
            [rows, jnp.zeros((rows.shape[0], pad), jnp.float32)], axis=1)
    return rows


def fetch_surface(scene: Scene, surf_rows, hit: Hit, o, d,
                  quirks: bool, tex_u=None, mat_rows=None) -> Surface:
    """Closest-hit stage: attribute fetch + interpolation.

    Re-derivation of closesthit.rchit:68-125 as ONE wide row-gather (see
    pack_surface_rows). Invalid (miss) lanes gather triangle 0; callers
    mask them out.
    """
    tri = jnp.maximum(hit.tri, 0)
    row = surf_rows[tri]                          # [N, F] single gather
    w1 = hit.u[..., None]
    w2 = hit.v[..., None]
    w0 = 1.0 - w1 - w2                            # closesthit.rchit:75

    t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 1.0)[..., None]
    position = o + d * t_safe

    n0 = row[:, 0:3]
    n1 = row[:, 3:6]
    n2 = row[:, 6:9]
    normal = vmath.normalize(n0 * w0 + n1 * w1 + n2 * w2)

    uv0 = row[:, 9:11]
    uv1 = row[:, 11:13]
    uv2 = row[:, 13:15]
    uv = uv0 * w0 + uv1 * w1 + uv2 * w2

    geom_normal = row[:, 15:18]

    mid = jnp.round(row[:, 18]).astype(jnp.int32) - 1
    if mat_rows is None:   # callers inside loops pass the hoisted pack
        mat_rows = pack_material_rows(scene)
    mrow = mat_rows[mid]                          # [N, 16] single gather
    albedo = mrow[:, 0:3]
    emission = mrow[:, 3:6]
    roughness = mrow[:, 6]
    metallic = mrow[:, 7]
    ior = mrow[:, 8]
    alpha = mrow[:, 9]
    mat_type = jnp.round(mrow[:, 10]).astype(jnp.int32) - 1
    atex = jnp.round(mrow[:, 11]).astype(jnp.int32) - 1
    mrtex = jnp.round(mrow[:, 12]).astype(jnp.int32) - 1
    ntex = jnp.round(mrow[:, 13]).astype(jnp.int32) - 1
    # the BASE color factor, before any texture replaces `albedo` below:
    # NEE's Le = emission * baseColorFactor (main.cpp:282-284)
    albedo_factor = albedo

    if scene.has_textures and tex_u is not None \
            and scene.tex_comp is not None:
        # Composite path: ONE stochastic 12-byte-row gather fetches the
        # albedo+metal-rough+normal texels for the lane's material (wide
        # gather rows amortize latency). Per-material maps were resampled to
        # shared dims at build; -1 slots decode to neutral but the same
        # has_* masks gate their use.
        u, v = uv[..., 0], uv[..., 1]
        wh = scene.tex_comp_wh[mid]
        twi = wh[:, 0]
        thi = wh[:, 1]
        ux, uy = tex_u
        x = u * twi.astype(jnp.float32) - 0.5
        y = v * thi.astype(jnp.float32) - 0.5
        xi = jnp.mod(jnp.floor(x + ux).astype(jnp.int32), twi)
        yi = jnp.mod(jnp.floor(y + uy).astype(jnp.int32), thi)
        rows = scene.tex_comp[mid, yi, xi]            # [N, 3] u32

        def unpack(p):
            return [((p >> jnp.uint32(8 * i)) & jnp.uint32(0xFF))
                    .astype(jnp.float32) * (1.0 / 255.0) for i in range(4)]

        ar, ag, ab_, aa = unpack(rows[:, 0])
        has_at = atex >= 0
        tex_rgb = jnp.stack([ar, ag, ab_], axis=1)
        albedo = jnp.where(has_at[..., None], tex_rgb ** 2.2, albedo)
        alpha = jnp.where(has_at, alpha * aa, alpha)

        _, mg, mb, _ = unpack(rows[:, 1])
        has_mr = mrtex >= 0
        roughness = jnp.where(has_mr, roughness * mg, roughness)
        metallic = jnp.where(has_mr, metallic * mb, metallic)

        nr, ng, nb2, _ = unpack(rows[:, 2])
        nt = ntex
        t0 = row[:, 20:23]
        t1 = row[:, 23:26]
        t2 = row[:, 26:29]
        tangent = vmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
        nm = jnp.stack([nr, ng, nb2], axis=1) * 2.0 - 1.0
        t_ortho = vmath.normalize(
            tangent - normal * vmath.dotk(normal, tangent))
        b = vmath.cross(normal, t_ortho)
        mapped = vmath.normalize(
            t_ortho * nm[..., 0:1] + b * nm[..., 1:2] + normal * nm[..., 2:3])
        normal = jnp.where((nt >= 0)[..., None], mapped, normal)
    elif scene.has_textures:
        u, v = uv[..., 0], uv[..., 1]
        # Albedo: sRGB-encoded texture REPLACES the factor and linearizes
        # with pow 2.2; alpha multiplies (closesthit.rchit:88-92).
        at = atex
        tex = _sample_texture(scene.textures, scene.tex_wh, at, u, v,
                              tex_u)
        has_at = (at >= 0)
        albedo = jnp.where(has_at[..., None],
                           jnp.maximum(tex[..., :3], 0.0) ** 2.2, albedo)
        alpha = jnp.where(has_at, alpha * tex[..., 3], alpha)
        # Metal-rough from G/B channels, multiplied (closesthit.rchit:97-101).
        mrt = mrtex
        mr = _sample_texture(scene.textures, scene.tex_wh, mrt, u, v,
                             tex_u)
        has_mr = (mrt >= 0)
        roughness = jnp.where(has_mr, roughness * mr[..., 1], roughness)
        metallic = jnp.where(has_mr, metallic * mr[..., 2], metallic)
        # Tangent-space normal map via Gram-Schmidt TBN
        # (closesthit.rchit:104-112).
        nt = ntex
        t0 = row[:, 20:23]
        t1 = row[:, 23:26]
        t2 = row[:, 26:29]
        tangent = vmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
        nm = _sample_texture(scene.textures, scene.tex_wh, nt, u, v,
                             tex_u)[..., :3] * 2.0 - 1.0
        t_ortho = vmath.normalize(tangent - normal * vmath.dotk(normal, tangent))
        b = vmath.cross(normal, t_ortho)
        mapped = vmath.normalize(
            t_ortho * nm[..., 0:1] + b * nm[..., 1:2] + normal * nm[..., 2:3])
        normal = jnp.where((nt >= 0)[..., None], mapped, normal)

    if quirks:
        emission_eff = emission  # closesthit.rchit:116 payload = mat.emission
    else:
        # consistent with the light list's Le (main.cpp:282-284)
        emission_eff = emission * albedo_factor

    return Surface(
        position=position,
        normal=normal,
        geom_normal=geom_normal,
        albedo=albedo,
        emission=emission_eff,
        roughness=jnp.clip(roughness, 0.01, 1.0),   # closesthit.rchit:119
        metallic=jnp.clip(metallic, 0.0, 1.0),      # closesthit.rchit:121
        ior=ior,
        alpha=jnp.clip(alpha, 0.0, 1.0),            # closesthit.rchit:122
        mat_type=mat_type,
        light_pdf_area=row[:, 19],
    )


def _power_heuristic(pdf_a, pdf_b):
    """Power heuristic beta=2 (raygen.rgen:247)."""
    a2 = pdf_a * pdf_a
    return a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-20)


def _nee_env(scene: Scene, cfg: RenderConfig, surf: Surface, view,
             pixel, sample, depth, occluded_fn, shade=None,
             primary=False, prime_blk=None, verify_rows=None,
             throughput=None, sample_window: int = 1):
    """Environment-map NEE with MIS (net-new; BASELINE config 4).

    One shadow ray toward a luminance-importance-sampled env direction.
    Returns (contrib/T [N,3], traced bool[N]); with prime_blk,
    (contrib, new_blk, traced) - the same verified-blocker cache as
    _nee (sky shadow rays in enclosed regions re-verify the same
    occluder across samples even though the sampled direction varies).

    throughput: path throughput T at this vertex, used by the shadow-ray
    Russian roulette (cfg.env_shadow_rr): the query is traced with
    probability q = clip(m * lum(T), 1/8, 1) and surviving contributions
    are weighted 1/q - unbiased, and `traced` reports which lanes
    actually resolved a visibility query (the exact ray counter adds
    only those).
    """
    from pathtracer.scene import envlight

    # Cell-interleaved draw (cfg.env_nee_cell): key
    # the env-direction stream on the pixel's NxN screen cell instead of
    # the pixel, so a cell's lanes share one direction per (sample,
    # depth). Two wins: (a) the occlusion sort packs env shadow rays
    # into direction-coherent tiles; (b) the env SAMPLING machinery -
    # CDF binary search + pdf + radiance lookups - runs ONCE PER
    # (cell, sample) on a table of n_cells x S entries and expands to
    # lanes with one wide-row gather. Bit-exact: identical inputs,
    # identical IEEE results, just deduplicated. Keyed on TRUE pixel
    # coordinates: layout-invariant under sharding.
    cell = cfg.env_nee_cell
    if cell > 1:
        pix_i = jnp.asarray(pixel, jnp.int32)
        cells_x = -(-cfg.width // cell)
        cells_y = -(-cfg.height // cell)
        n_cells = cells_x * cells_y
        cell_id = ((pix_i // cfg.width) // cell * cells_x
                   + (pix_i % cfg.width) // cell)
        # distinct sample ids in any wavefront fall in a window of
        # sample_window values starting at the pool base (spp-batch
        # pools carry frame*spp + s over spp*frames ids; shards a
        # sub-window; per-sample calls exactly one). The caller passes
        # the TRUE static window (adaptive frame batching can exceed
        # cfg.frame_batch); s0 rides as a traced scalar.
        S = max(1, sample_window)
        s0 = jnp.min(jnp.asarray(sample, jnp.uint32))
        ck = jnp.repeat(jnp.arange(n_cells, dtype=jnp.uint32), S)
        sk = jnp.tile(jnp.arange(S, dtype=jnp.uint32), n_cells) + s0
        u_c = rng.uniform4(ck, sk, depth, rng.SALT_ENV_SELECT,
                           cfg.seed, cfg.sampler)
        l_dir_c, _, _ = envlight.sample_env(
            scene.env_marginal_cdf, scene.env_cond_cdf,
            u_c[..., 0], u_c[..., 1], u_c[..., 2], u_c[..., 3])
        p_c = envlight.env_pdf(scene.env_pdf, l_dir_c)
        le_c = sky_mod.envmap_radiance(scene.envmap, l_dir_c)
        table = jnp.concatenate(
            [l_dir_c, p_c[:, None], le_c,
             jnp.zeros_like(p_c)[:, None]], axis=1)    # [n_cells*S, 8]
        slot = jnp.minimum(
            jnp.asarray(sample, jnp.uint32) - s0, jnp.uint32(S - 1))
        rows = table[cell_id.astype(jnp.uint32) * jnp.uint32(S) + slot]
        l_dir = rows[:, 0:3]
        p_env = rows[:, 3]
        le = rows[:, 4:7]
    else:
        u = rng.uniform4(pixel, sample, depth, rng.SALT_ENV_SELECT,
                         cfg.seed, cfg.sampler)
        l_dir, _, _ = envlight.sample_env(
            scene.env_marginal_cdf, scene.env_cond_cdf,
            u[..., 0], u[..., 1], u[..., 2], u[..., 3])
        p_env = envlight.env_pdf(scene.env_pdf, l_dir)
        le = sky_mod.envmap_radiance(scene.envmap, l_dir)
    n_dot_l = jnp.maximum(vmath.dot(surf.normal, l_dir), 0.0)
    ok = (n_dot_l > 0.0) & (p_env > 0.0)

    s_orig = surf.position + surf.normal * cfg.shadow_eps
    valid = ok if shade is None else (ok & shade)
    inv_q = jnp.ones(l_dir.shape[:-1], jnp.float32)
    if cfg.env_shadow_rr > 0.0 and throughput is not None:
        # Shadow-ray RR (cfg.env_shadow_rr): skip dim-path queries with
        # probability 1-q, weight survivors 1/q. Rec.709 luminance, the
        # same measure the env CDF importance uses (scene/envlight.py).
        lum_t = (0.2126 * throughput[..., 0] + 0.7152 * throughput[..., 1]
                 + 0.0722 * throughput[..., 2])
        q = jnp.clip(cfg.env_shadow_rr * lum_t, 0.125, 1.0)
        u_rr = rng.uniform1(pixel, sample, depth, rng.SALT_ENV_RR,
                            cfg.seed, cfg.sampler)
        valid = valid & (u_rr < q)
        inv_q = 1.0 / q
    traced = valid
    s_tmax = jnp.full(l_dir.shape[:-1], 1e18, jnp.float32)
    new_blk = None
    if prime_blk is not None:
        from pathtracer.kernels import intersect as isect

        bi = jnp.maximum(prime_blk, 0)
        brow = verify_rows[bi]
        bv0, bv1, bv2 = brow[:, 0:3], brow[:, 3:6], brow[:, 6:9]
        tb, _, _, okb = isect.ray_triangle(s_orig, l_dir, bv0, bv1, bv2,
                                           0.0, s_tmax)
        frontb = vmath.dot(
            l_dir, vmath.cross(bv1 - bv0, bv2 - bv0)) < 0.0
        ver = okb & frontb & (prime_blk >= 0) & valid
        need = valid & ~ver
        o_t = jnp.where(need[..., None], s_orig, 1e30)
        d_t = jnp.where(need[..., None], l_dir, 1.0)
        blocked_tr, btri = occluded_fn(o_t, d_t, s_tmax, primary=primary,
                                       want_blocker=True)
        new_blk = jnp.where(need & blocked_tr, btri, prime_blk)
        blocked = ver | blocked_tr
    else:
        s_orig = jnp.where(valid[..., None], s_orig, 1e30)  # park dead
        l_dir_eff = jnp.where(valid[..., None], l_dir, 1.0)
        blocked = occluded_fn(s_orig, l_dir_eff, s_tmax)

    f = mf.eval_brdf(surf.normal, view, l_dir, surf.albedo, surf.metallic,
                     surf.roughness)
    pdf_b = mf.pdf_bsdf(surf.normal, view, l_dir, surf.metallic,
                        surf.roughness)
    w = _power_heuristic(p_env, pdf_b)
    contrib = (f * le
               * (n_dot_l * w * inv_q / jnp.maximum(p_env, 1e-12))[..., None])
    # gate on `traced`: an RR-skipped lane resolved no query and must
    # contribute 0 (its expectation rides in the survivors' 1/q weight)
    out = jnp.where((traced & ~blocked)[..., None], contrib, 0.0)
    return ((out, new_blk, traced) if prime_blk is not None
            else (out, traced))


def _nee(scene: Scene, cfg: RenderConfig, surf: Surface, view: jnp.ndarray,
         pixel, sample, depth, occluded_fn, shade=None, primary=False,
         prime_blk=None, verify_rows=None):
    """Next-event estimation (raygen.rgen:168-261). Returns contrib/T [N,3].

    view = unit vector from surface toward the previous vertex (-ray dir).

    prime_blk: optional i32[N] per-lane blocker-triangle hint (-1 = none),
    the previous sample's verified blockers for this pixel's bounce-0
    shadow query. The hint is re-tested exactly against THIS sample's
    segment; a verified blocker makes the query conclusively occluded
    (any-hit semantics) and the lane parks out of the traversal. When
    given, returns (contrib, new_blk) with this sample's blocker hints
    (failed hints are KEPT - area-light resampling can re-verify them
    next sample); otherwise returns contrib alone.
    """
    u_sel = rng.uniform1(pixel, sample, depth, rng.SALT_LIGHT_SELECT,
                         cfg.seed, cfg.sampler)
    li = jnp.clip(jnp.searchsorted(scene.light_cdf, u_sel, side="left"),
                  0, scene.light_cdf.shape[0] - 1).astype(jnp.int32)

    v0 = scene.light_v0[li]
    v1 = scene.light_v1[li]
    v2 = scene.light_v2[li]
    light_n = scene.light_normal[li]
    le = scene.light_emission[li]
    area = scene.light_area[li]
    p_tri = scene.light_pdf[li]

    # Uniform point on the triangle (raygen.rgen:74-84).
    r1, r2 = rng.uniform2(pixel, sample, depth, rng.SALT_LIGHT_UV, cfg.seed,
                          cfg.sampler)
    sr1 = jnp.sqrt(r1)
    b0 = (1.0 - sr1)[..., None]
    b1 = (r2 * sr1)[..., None]
    p_on_light = v0 * b0 + v1 * b1 + v2 * (1.0 - b0 - b1)

    p_a = p_tri / jnp.maximum(area, vmath.EPS)      # raygen.rgen:185

    to_light = p_on_light - surf.position
    dist2 = jnp.maximum(vmath.dot(to_light, to_light), vmath.EPS)
    l_dir = to_light * jax.lax.rsqrt(dist2)[..., None]
    n_dot_l = jnp.maximum(vmath.dot(surf.normal, l_dir), 0.0)
    nl_dot = jnp.maximum(vmath.dot(light_n, -l_dir), 0.0)
    geo_ok = (n_dot_l > 0.0) & (nl_dot > 0.0)       # raygen.rgen:195

    # Shadow ray. The reference (raygen.rgen:199-204) offsets the target
    # BEHIND the emitter (pOnLight - lightNormal*eps) with tmax = dist - eps;
    # in exact arithmetic that ray crosses the emissive triangle itself at
    # t < tmax whenever the receiver is off the light's axis, so NEE
    # self-occludes on the emitter (documented quirk, kept under
    # reference_quirks). Fixed scheme: offset the origin along the shading
    # normal, aim straight at the sampled point, and pull tmax back by a
    # RELATIVE margin - the emitter at t ~= dist is excluded cleanly.
    eps = cfg.shadow_eps
    s_orig = surf.position + surf.normal * eps
    if cfg.reference_quirks:
        target = p_on_light - light_n * eps
        s_dir = vmath.normalize(target - s_orig)
        s_tmax = jnp.maximum(0.0, jnp.sqrt(dist2) - eps)
    else:
        seg = p_on_light - s_orig
        seg_len = jnp.sqrt(jnp.maximum(vmath.dot(seg, seg), 1e-20))
        s_dir = seg / seg_len[..., None]
        s_tmax = seg_len * (1.0 - 1e-3)
    valid = geo_ok if shade is None else (geo_ok & shade)
    new_blk = None
    if prime_blk is not None:
        # Verified blocker prediction (exact): re-test the hinted
        # triangle against THIS segment under the traversal's own policy
        # (front-facing, 0 < t < tmax, kernels/packet._mt_any_front). A
        # verified block is conclusive - any-hit needs no traversal.
        from pathtracer.kernels import intersect as isect

        bi = jnp.maximum(prime_blk, 0)
        if verify_rows is not None:   # one wide gather (see trace_paths)
            brow = verify_rows[bi]
            bv0, bv1, bv2 = brow[:, 0:3], brow[:, 3:6], brow[:, 6:9]
        else:
            bv0, bv1, bv2 = scene.tri_vertices(bi)
        tb, _, _, okb = isect.ray_triangle(s_orig, s_dir, bv0, bv1, bv2,
                                           0.0, s_tmax)
        gnb = vmath.cross(bv1 - bv0, bv2 - bv0)
        frontb = vmath.dot(s_dir, gnb) < 0.0
        ver = okb & frontb & (prime_blk >= 0) & valid
        need = valid & ~ver
        o_t = jnp.where(need[..., None], s_orig, 1e30)   # park resolved
        d_t = jnp.where(need[..., None], s_dir, 1.0)
        blocked_tr, btri = occluded_fn(o_t, d_t, s_tmax, primary=primary,
                                       want_blocker=True)
        # keep failed hints (may re-verify under a new light sample);
        # adopt traversal's blocker where it found one
        new_blk = jnp.where(need & blocked_tr, btri, prime_blk)
        blocked = ver | blocked_tr
    else:
        s_orig = jnp.where(valid[..., None], s_orig, 1e30)  # park dead
        s_dir = jnp.where(valid[..., None], s_dir, 1.0)
        blocked = occluded_fn(s_orig, s_dir, s_tmax, primary=primary)

    f = mf.eval_brdf(surf.normal, view, l_dir, surf.albedo, surf.metallic,
                     surf.roughness)
    p_omega_light = p_a * dist2 / jnp.maximum(nl_dot, vmath.EPS)
    pdf_b = mf.pdf_bsdf(surf.normal, view, l_dir, surf.metallic,
                        surf.roughness)
    w = _power_heuristic(p_omega_light, pdf_b)

    g = n_dot_l * nl_dot / dist2                    # raygen.rgen:250
    gain = 1.0 if cfg.reference_quirks else cfg.emission_gain
    contrib = f * (le * gain) * (g / jnp.maximum(p_a, 1e-12))[..., None] \
        * w[..., None]
    ok = geo_ok & ~blocked
    out = jnp.where(ok[..., None], contrib, 0.0)
    return (out, new_blk) if prime_blk is not None else out


def _wavefront_order(scene: Scene, o, d, active):
    """Compaction + coherence permutation for one bounce.

    Key = (dead?, direction octant, origin Morton): dead lanes sort to the
    wavefront tail (whole traversal chunks of them skip via lax.cond -
    static-shape stream compaction), live lanes group by direction octant
    then origin locality so traversal tiles want the same clusters. Stable,
    so primary rays (identical origins) keep their swizzled pixel-block
    order within an octant.
    """
    from pathtracer.accel import morton as morton_mod

    lo = jnp.min(scene.positions, axis=0)
    hi = jnp.max(scene.positions, axis=0)
    octant = ((d[:, 0] > 0).astype(jnp.uint32)
              + 2 * (d[:, 1] > 0).astype(jnp.uint32)
              + 4 * (d[:, 2] > 0).astype(jnp.uint32))
    m = morton_mod.morton_codes(o, lo=lo, hi=hi)      # 30-bit
    key = (octant << jnp.uint32(27)) | (m >> jnp.uint32(3))
    key = jnp.where(active, key, jnp.uint32(0xFFFFFFFF))
    return jnp.argsort(key, stable=True).astype(jnp.int32)


def trace_paths(scene: Scene, cfg: RenderConfig, origins, directions,
                pixel_ids, sample_ids,
                intersect_fn: Callable, occluded_fn: Callable,
                prime=None, want_gbuffer: bool = False,
                n_pixels: int = None, local_pix=None,
                sample_window: int = 0):
    """Trace a batch of paths to completion.

    Returns (radiance f32[N,3], pixel_ids_out i32[N], rays_traced f32
    scalar, prime_out). With cfg.wavefront_sort the wavefront is
    re-permuted once per bounce (see _wavefront_order), so radiance comes
    back in the LAST bounce's order - callers scatter by pixel_ids_out
    (which ride along in the carry). The ray counter is exact - path rays
    actually traced plus NEE visibility QUERIES RESOLVED - a free
    by-product of the active masks (SURVEY.md par.5 "Tracing": Mrays/s
    from real counts, not upper bounds). Counter semantics under
    priming: a hint-verified shadow query counts exactly like a traced
    one (it resolves the same query the reference answers with a
    rayQueryEXT walk), so the count is invariant to priming on/off -
    pinned by tests - and speedups appear in time, never in the
    numerator.

    prime: optional i32[n_pixels, 3] per-PIXEL hint columns from the
    previous sample (-1 = none), all verified-never-trusted (exact):
      [:, 0] primary hit triangle - re-tested, its hit distance becomes
             the per-ray t_max so primary schedules shrink to clusters
             strictly in front of the verified hit;
      [:, 1] bounce-0 NEE shadow blocker (see _nee) - a re-verified
             blocker resolves the any-hit query with no traversal;
      [:, 2] bounce-0 env-NEE shadow blocker (see _nee_env).
    When given, prime_out returns THIS sample's hints, same layout.

    want_gbuffer: also return the primary-hit G-buffer (normal f32[P,3],
    depth f32[P] (inf = sky), albedo f32[P,3]) in pixel order - the
    auxiliary features the edge-aware denoiser keys on (film/denoise).

    local_pix: optional i32[N] per-LANE index into the per-pixel arrays
    (prime rows, G-buffer rows) replacing the global `pixel_ids` at the
    primary gather/scatter sites. Sharded rendering passes the shard-
    local lane->row mapping here while RNG keeps keying on true global
    pixel ids (parallel/sharding.py); single-chip callers omit it.

    intersect_fn(o, d, t_min, t_max) -> Hit
    occluded_fn(o, d, t_max) -> bool[N]
    """
    n = origins.shape[0]
    # spp-batched wavefronts carry several lanes per pixel (render.py
    # render_frame_batched): per-PIXEL outputs (G-buffer) size to
    # n_pixels and scatter WITHOUT the unique-indices contract
    # (last-writer-wins among a pixel's samples).
    n_pixels = n_pixels or n
    # static sample-id window of this wavefront (docstring of _nee_env);
    # callers that batch pools pass the true spp_eff
    sample_window = sample_window or max(1, cfg.spp * cfg.frame_batch)
    uniq = n_pixels == n
    gain = cfg.emission_gain
    env_nee = (cfg.env_importance_sampling and cfg.sky == "envmap"
               and scene.has_envmap)
    do_sort = cfg.wavefront_sort
    # One wide attribute row per triangle, packed once per frame (XLA CSEs
    # the O(T) pack across bounces); see pack_surface_rows.
    surf_rows = pack_surface_rows(scene)
    mat_rows = pack_material_rows(scene)   # hoisted out of the bounce loop
    # Captures the primary segment's hits + bounce-0 blockers (pixel
    # order) when priming is on; filled inside the primary bounce.
    prime_tri = prime[:, 0] if prime is not None else None
    prime_blk = prime[:, 1] if prime is not None else None
    prime_env = prime[:, 2] if prime is not None else None
    prime_state = {"out": None, "blk": None, "envb": None}
    gbuf_state = {}

    def _lp(pix):
        # lane -> per-pixel row index; only ever evaluated at the primary
        # bounce, where lane order is still the input order (bounce 0 is
        # peeled and skips the coherence sort), so the caller-supplied
        # mapping stays aligned with `pix`
        return local_pix if local_pix is not None else pix

    verify_rows = None
    if prime is not None:
        # One wide [T, 9] row (v0|v1|v2) per triangle, packed once per
        # trace: hint verification then costs ONE wide-row gather per
        # hint instead of 4 narrow ones (indices + 3 corners) - wide
        # rows amortize gather latency.
        tv0, tv1, tv2 = scene.tri_vertices(jnp.arange(scene.n_tris))
        verify_rows = jnp.concatenate([tv0, tv1, tv2], axis=1)

    def segment(carry, depth, primary=False):
        """Trace + emission collection shared by every bounce (incl. last)."""
        o, d, throughput, radiance, active, prev_pdf, pix, samp, \
            rays_traced = carry
        if do_sort and not primary:
            # bounce 0 keeps its swizzled pixel-block order (tighter than
            # any key - the same reason the packet layer skips sorting
            # primaries, render.py intersect_fn)
            # ONE argsort + two row-gathers per bounce replaces the packet
            # layer's per-chunk/per-call coherence sorts and compacts dead
            # lanes to the tail for the chunk-skip.
            order = _wavefront_order(scene, o, d, active)
            row = jnp.concatenate(
                [o, d, throughput, radiance, prev_pdf[:, None],
                 active.astype(jnp.float32)[:, None]], axis=1)[order]
            ids = jnp.stack([pix.astype(jnp.int32),
                             samp.astype(jnp.int32)], axis=1)[order]
            o, d = row[:, 0:3], row[:, 3:6]
            throughput, radiance = row[:, 6:9], row[:, 9:12]
            prev_pdf = row[:, 12]
            active = row[:, 13] > 0.5
            pix = ids[:, 0].astype(pixel_ids.dtype)
            samp = ids[:, 1].astype(sample_ids.dtype)
        rays_traced = rays_traced + jnp.sum(active.astype(jnp.float32))
        # Park dead lanes at +inf so the packet kernel's coherence sort
        # groups them into all-dead tiles that terminate immediately
        # (wavefront compaction without dynamic shapes).
        o_eff = jnp.where(active[..., None], o, 1e30)
        d_eff = jnp.where(active[..., None], d, 1.0)   # one shared octant
        if primary and prime_tri is not None:
            # Verified hit prediction (exact): re-test the hinted
            # triangle, then traverse with its hit distance as the
            # per-ray t_max - the near-to-far sweep terminates at the
            # first cluster beyond it. Misses keep cfg.t_max.
            from pathtracer.kernels import intersect as isect

            pt = prime_tri[_lp(pix)]
            prow = verify_rows[jnp.maximum(pt, 0)]
            pv0, pv1, pv2 = prow[:, 0:3], prow[:, 3:6], prow[:, 6:9]
            tp, up, vp, okp = isect.ray_triangle(
                o_eff, d_eff, pv0, pv1, pv2, cfg.t_min, cfg.t_max)
            okp = okp & (pt >= 0)
            tp = jnp.where(okp, tp, jnp.inf)
            t_max_eff = jnp.minimum(cfg.t_max, tp)
            hit = intersect_fn(o_eff, d_eff, cfg.t_min, t_max_eff,
                               primary=primary)
            # traversal only reports hits strictly closer than the
            # verified prediction; fall back to the prediction itself
            use_p = okp & ~hit.valid
            hit = isect.Hit(
                t=jnp.where(use_p, tp, hit.t),
                tri=jnp.where(use_p, pt, hit.tri),
                u=jnp.where(use_p, up, hit.u),
                v=jnp.where(use_p, vp, hit.v))
        else:
            hit = intersect_fn(o_eff, d_eff, cfg.t_min, cfg.t_max,
                               primary=primary)
        hit_ok = hit.valid & active
        if primary and prime_tri is not None:
            prime_state["out"] = jnp.full(
                prime_tri.shape, -1, jnp.int32).at[_lp(pix)].set(
                    jnp.where(hit_ok, hit.tri, -1), unique_indices=uniq)

        # --- miss: environment (miss.rmiss; payload.done) ---
        missed = active & ~hit.valid
        sky_rad = sky_mod.sky_radiance(cfg, scene.envmap, d,
                                       envmap_blocks=scene.envmap_blocks)
        if env_nee:
            # MIS against the env NEE strategy (delta segments weight 1)
            from pathtracer.scene import envlight

            p_env = envlight.env_pdf(scene.env_pdf, d)
            w_sky = jnp.where(jnp.isinf(prev_pdf), 1.0,
                              _power_heuristic(prev_pdf, p_env))
            sky_rad = sky_rad * w_sky[..., None]
        radiance = radiance + jnp.where(
            missed[..., None], throughput * sky_rad, 0.0)
        active = hit_ok

        if scene.has_textures and cfg.stochastic_texture_filtering:
            # one shared jitter pair per (lane, bounce): each of the
            # three texture taps is a 1-tap estimate of the sRGB-space
            # bilinear value (see _sample_texture for the bias caveat)
            tex_u = rng.uniform2(pix, samp, depth, rng.SALT_TEX_FILTER,
                                 cfg.seed, cfg.sampler)
        else:
            tex_u = None
        surf = fetch_surface(scene, surf_rows, hit, o, d,
                             cfg.reference_quirks, tex_u, mat_rows)

        # --- emitter hit (raygen.rgen:132) ---
        if cfg.reference_quirks:
            w_emit = jnp.ones((n,), jnp.float32)   # quirk 3: no MIS weight
        else:
            cos_l = jnp.maximum(vmath.dot(surf.geom_normal, -d), 0.0)
            pdf_light = surf.light_pdf_area * hit.t * hit.t \
                / jnp.maximum(cos_l, vmath.EPS)
            is_delta = jnp.isinf(prev_pdf)
            w_emit = jnp.where(
                is_delta | (surf.light_pdf_area <= 0.0),
                1.0, _power_heuristic(prev_pdf, pdf_light))
        radiance = radiance + jnp.where(
            hit_ok[..., None],
            throughput * surf.emission * gain * w_emit[..., None], 0.0)
        carry = (o, d, throughput, radiance, active, prev_pdf, pix, samp,
                 rays_traced)
        return carry, surf

    def bounce(depth, carry, primary=False):
        """One full bounce: segment + NEE + BSDF continuation.

        Compiled ONCE as a lax.fori_loop body (not unrolled per depth - the
        depth index is traced; per-bounce RNG keys take it as a counter).
        Bounce 0 is peeled out of the fori_loop (render_paths below) so
        the primary trace can skip the coherence sort.
        """
        carry, surf = segment(carry, depth, primary)
        o, d, throughput, radiance, active, prev_pdf, pix, samp, \
            rays_traced = carry
        view = -d

        if primary and want_gbuffer:
            # Primary-hit G-buffer for the denoiser: geometric features
            # at the first hit, scattered to pixel order. Sky pixels:
            # depth = inf, normal = 0, albedo = 1 (neutral demodulation).
            # ONE row scatter: with spp-batched lanes (uniq False) each
            # pixel has spp duplicate writers and XLA leaves the winner
            # unspecified PER SCATTER - three separate scatters could mix
            # normal/depth/albedo from different samples (a finite-depth
            # pixel with a zeroed normal blacks out under the a-trous
            # weights). A whole-row update keeps one sample's features.
            pdepth = jnp.where(active,
                               vmath.dot(surf.position - o, d), jnp.inf)
            grow = jnp.concatenate(
                [jnp.where(active[..., None], surf.normal, 0.0),
                 pdepth[..., None],
                 jnp.where(active[..., None], surf.albedo, 1.0)], axis=1)
            ginit = jnp.concatenate(
                [jnp.zeros((n_pixels, 3), jnp.float32),
                 jnp.full((n_pixels, 1), jnp.inf, jnp.float32),
                 jnp.ones((n_pixels, 3), jnp.float32)], axis=1)
            g = ginit.at[_lp(pix)].set(grow, unique_indices=uniq)
            gbuf_state["normal"] = g[:, 0:3]
            gbuf_state["depth"] = g[:, 3]
            gbuf_state["albedo"] = g[:, 4:7]

        # --- alpha stochastic transparency (raygen.rgen:143-146) ---
        u_alpha = rng.uniform1(pix, samp, depth, rng.SALT_ALPHA,
                               cfg.seed, cfg.sampler)
        passthrough = active & (surf.alpha < 0.99) & (u_alpha > surf.alpha)

        # --- dielectric (raygen.rgen:149-166) ---
        is_dielectric = active & ~passthrough \
            & (surf.mat_type == MAT_DIELECTRIC)
        cosi = vmath.dot(d, surf.normal)
        entering = cosi <= 0.0
        eta_ratio = jnp.where(entering, 1.0 / surf.ior, surf.ior)
        n_eff = jnp.where(entering[..., None], surf.normal, -surf.normal)
        refr, tir = vmath.refract(d, n_eff, eta_ratio)
        refl_prob = vmath.saturate(
            mf.schlick_scalar(jnp.abs(cosi), 0.04))  # raygen.rgen:158
        u_d = rng.uniform1(pix, samp, depth, rng.SALT_DIELECTRIC,
                           cfg.seed, cfg.sampler)
        take_refl = tir | (u_d < refl_prob)
        d_dielectric = jnp.where(take_refl[..., None],
                                 vmath.reflect(d, surf.normal), refr)

        # --- NEE (raygen.rgen:168-261) ---
        shade = active & ~passthrough & ~is_dielectric
        # cfg.skip_nee (bench-only shadow-cost attribution): drop the
        # NEE stage to attribute its cost in real frames.
        skip_nee = cfg.skip_nee
        if scene.has_lights and not skip_nee:
            if primary and prime_blk is not None:
                # bounce-0 shadow blocker priming: hints ride per PIXEL
                # (lane pix mapping is the identity at bounce 0 up to
                # swizzle); verified blocks park out of traversal.
                nee, new_blk = _nee(scene, cfg, surf, view, pix, samp,
                                    depth, occluded_fn, shade, primary,
                                    prime_blk=prime_blk[_lp(pix)],
                                    verify_rows=verify_rows)
                if new_blk is not None:
                    prime_state["blk"] = jnp.full(
                        prime_blk.shape, -1, jnp.int32).at[_lp(pix)].set(
                            new_blk, unique_indices=uniq)
            else:
                nee = _nee(scene, cfg, surf, view, pix, samp, depth,
                           occluded_fn, shade, primary)
            radiance = radiance + jnp.where(
                shade[..., None], throughput * nee, 0.0)
            rays_traced = rays_traced + jnp.sum(shade.astype(jnp.float32))
        if env_nee and not skip_nee:
            if primary and prime_env is not None:
                env_c, new_envb, env_traced = _nee_env(
                    scene, cfg, surf, view, pix, samp, depth,
                    occluded_fn, shade, primary,
                    prime_blk=prime_env[_lp(pix)],
                    verify_rows=verify_rows, throughput=throughput,
                    sample_window=sample_window)
                prime_state["envb"] = jnp.full(
                    prime_env.shape, -1, jnp.int32).at[_lp(pix)].set(
                        new_envb, unique_indices=uniq)
            else:
                env_c, env_traced = _nee_env(
                    scene, cfg, surf, view, pix, samp, depth,
                    occluded_fn, shade, primary, throughput=throughput,
                    sample_window=sample_window)
            radiance = radiance + jnp.where(
                shade[..., None], throughput * env_c, 0.0)
            # exact counter: only lanes that RESOLVED a visibility query
            # (shadow-RR skips resolve nothing; docstring contract)
            rays_traced = rays_traced + jnp.sum(
                env_traced.astype(jnp.float32))

        # --- BSDF sampling (raygen.rgen:263-283) ---
        u_lobe = rng.uniform1(pix, samp, depth,
                              rng.SALT_BSDF_LOBE, cfg.seed, cfg.sampler)
        u1, u2 = rng.uniform2(pix, samp, depth, rng.SALT_BSDF_UV,
                              cfg.seed, cfg.sampler)
        p_spec = mf.lobe_select_prob(surf.metallic, surf.roughness)
        choose_spec = u_lobe < p_spec
        l_spec = mf.sample_ggx(surf.normal, view, surf.roughness, u1, u2)
        l_diff = mf.sample_cosine(surf.normal, u1, u2)
        l_new = jnp.where(choose_spec[..., None], l_spec, l_diff)

        n_dot_l = jnp.maximum(vmath.dot(surf.normal, l_new), 0.0)
        if cfg.reference_quirks:
            # conditional-lobe pdf only (raygen.rgen:267-274)
            pdf = jnp.where(
                choose_spec,
                jnp.maximum(mf.pdf_ggx(surf.normal, view, l_new,
                                       surf.roughness), 1e-6),
                jnp.maximum(mf.pdf_cosine(n_dot_l), 1e-6))
        else:
            pdf = mf.pdf_bsdf(surf.normal, view, l_new, surf.metallic,
                              surf.roughness)
        f = mf.eval_brdf(surf.normal, view, l_new, surf.albedo, surf.metallic,
                         surf.roughness)
        bsdf_ok = n_dot_l > 0.0                     # raygen.rgen:277

        new_throughput = throughput * f * (n_dot_l / pdf)[..., None]

        # For MIS at the next emitter hit: the mixture pdf of this sample.
        mix_pdf = mf.pdf_bsdf(surf.normal, view, l_new, surf.metallic,
                              surf.roughness)

        # --- merge the three continuation classes ---
        # passthrough: same direction, origin stepped past the surface
        # (raygen.rgen:144); dielectric: new delta direction; shade: BSDF.
        new_d = jnp.where(passthrough[..., None], d,
                          jnp.where(is_dielectric[..., None], d_dielectric,
                                    l_new))
        new_o = surf.position + new_d * cfg.t_min   # raygen.rgen:144,164,282
        o = jnp.where(active[..., None], new_o, o)
        d = jnp.where(active[..., None], new_d, d)
        throughput = jnp.where(shade[..., None], new_throughput, throughput)
        prev_pdf = jnp.where(shade, mix_pdf, jnp.inf)
        active = active & (passthrough | is_dielectric | (shade & bsdf_ok))

        # --- Russian roulette (raygen.rgen:286-291) ---
        # masked by (depth > rr_start_depth) instead of a python-level
        # branch, so the bounce body stays depth-independent
        p = jnp.clip(vmath.maxc(throughput), cfg.rr_clamp_lo,
                     cfg.rr_clamp_hi)
        u_rr = rng.uniform1(pix, samp, depth, rng.SALT_RR,
                            cfg.seed, cfg.sampler)
        survive = u_rr <= p
        rr_applies = (active & ~passthrough & ~is_dielectric
                      & (depth > cfg.rr_start_depth))
        active = active & (~rr_applies | survive)
        throughput = jnp.where((rr_applies & survive)[..., None],
                               throughput / p[..., None], throughput)
        active = active & (vmath.maxc(throughput) >= cfg.throughput_cutoff)
        return (o, d, throughput, radiance, active, prev_pdf, pix, samp,
                rays_traced)

    # Carry inits derive data-dependence from the ray arrays so their
    # varying-axes match the loop outputs under shard_map (same trick as
    # kernels/traverse._like).
    ref = (origins[..., 0] + directions[..., 0]
           + pixel_ids.astype(jnp.float32) * 0.0
           + sample_ids.astype(jnp.float32) * 0.0)
    ref3 = ref[..., None] * jnp.zeros((3,), jnp.float32)
    refi = (ref * 0.0).astype(jnp.int32)
    carry = (
        origins + ref3, directions + ref3,
        ref3 + 1.0,                                 # throughput
        ref3,                                       # radiance
        (ref * 0.0) < 1.0,                          # active (all True)
        # Last BSDF solid-angle pdf, for MIS on emitter hits; inf marks delta
        # segments (camera, dielectric, alpha passthrough) => weight 1.
        ref * 0.0 + jnp.inf,                        # prev_pdf
        pixel_ids + refi.astype(pixel_ids.dtype),   # pixel ids ride along
        sample_ids + refi.astype(sample_ids.dtype),
        jnp.sum(ref) * 0.0,                         # rays_traced
    )
    if cfg.max_depth > 1:
        # Bounce 0 peeled: primary rays keep their swizzled screen order
        # (no coherence sort). Then fori (not while-any(active)): an
        # early-exit while measured 2x SLOWER end-to-end on the previous
        # accelerator (untested on the GPU) - the all-lanes cond reduction
        # serializes the bounce pipeline, while compacted dead lanes
        # already make late bounces cheap (chunk-skip + empty-tile
        # termination).
        carry = bounce(0, carry, primary=True)
        if cfg.max_depth > 2:
            carry = jax.lax.fori_loop(1, cfg.max_depth - 1, bounce, carry)
    # last segment only collects emission (raygen.rgen:128 loop tail)
    carry, _ = segment(carry, cfg.max_depth - 1,
                       primary=(cfg.max_depth == 1))
    _, _, _, radiance, _, _, pix_out, _, rays_traced = carry
    if cfg.clamp_radiance > 0.0:
        # Firefly clamp (net-new, OFF by default): bound each path
        # sample's total radiance. Biased (darkens rare bright paths) -
        # a standard production noise/robustness trade the reference
        # does not offer; goldens/parity all run with it off.
        radiance = jnp.minimum(radiance, cfg.clamp_radiance)
    gbuf = gbuf_state if gbuf_state else None   # empty at max_depth == 1
    if prime is None:
        return radiance, pix_out, rays_traced, None, gbuf
    none = jnp.full_like(prime_tri, -1)
    cols = [prime_state["out"] if prime_state["out"] is not None else none,
            prime_state["blk"] if prime_state["blk"] is not None else none,
            prime_state["envb"] if prime_state["envb"] is not None
            else none]
    return radiance, pix_out, rays_traced, jnp.stack(cols, axis=1), gbuf
