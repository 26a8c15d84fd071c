"""Environment-map importance sampling tests (BASELINE config 4)."""

import jax.numpy as jnp
import numpy as np

from pathtracer.scene import envlight


def _sphere_integral_check(env):
    """MC-estimate int L dw via the sampler; compare to quadrature."""
    mcdf, ccdf, pdf = envlight.build_env_distribution(env)
    n = 1 << 14
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(4, n)).astype(np.float32)
    d, r, c = envlight.sample_env(jnp.asarray(mcdf), jnp.asarray(ccdf),
                                  *[jnp.asarray(x) for x in u])
    p = np.asarray(envlight.env_pdf(jnp.asarray(pdf), d))
    # estimate integral of luminance: E[lum(dir)/pdf]
    h, w = env.shape[:2]
    lum_map = env @ np.array([0.2126, 0.7152, 0.0722])
    lum = lum_map[np.asarray(r), np.asarray(c)]
    est = float(np.mean(lum / np.maximum(p, 1e-12)))

    theta = (np.arange(h) + 0.5) / h * np.pi
    dw = (np.pi / h) * (2 * np.pi / w) * np.sin(theta)[:, None]
    ref = float((lum_map * dw).sum())
    return est, ref


def test_sampler_integrates_constant():
    env = np.ones((8, 16, 3), np.float32)
    est, ref = _sphere_integral_check(env)
    assert abs(est - ref) / ref < 0.02
    # midpoint quadrature at 8 rows overestimates int sin by ~0.6%
    assert abs(ref - 4 * np.pi) < 0.15  # sanity: int of 1 over sphere


def test_sampler_integrates_hotspot():
    """A 1000x hotspot: importance sampling still integrates correctly."""
    env = np.ones((16, 32, 3), np.float32) * 0.01
    env[4, 7] = 1000.0
    est, ref = _sphere_integral_check(env)
    assert abs(est - ref) / ref < 0.05


def test_sampler_prefers_bright_texels():
    env = np.ones((16, 32, 3), np.float32) * 0.01
    env[4, 7] = 1000.0
    mcdf, ccdf, pdf = envlight.build_env_distribution(env)
    rng = np.random.default_rng(1)
    u = rng.uniform(size=(4, 4096)).astype(np.float32)
    d, r, c = envlight.sample_env(jnp.asarray(mcdf), jnp.asarray(ccdf),
                                  *[jnp.asarray(x) for x in u])
    frac = float(np.mean((np.asarray(r) == 4) & (np.asarray(c) == 7)))
    assert frac > 0.9  # nearly all samples target the hotspot


def test_pdf_normalizes():
    env = np.abs(np.random.default_rng(2).normal(
        size=(8, 16, 3))).astype(np.float32)
    _, _, pdf = envlight.build_env_distribution(env)
    h, w = pdf.shape
    theta = (np.arange(h) + 0.5) / h * np.pi
    dw = (np.pi / h) * (2 * np.pi / w) * np.sin(theta)[:, None]
    total = float((pdf * dw).sum())
    assert abs(total - 1.0) < 1e-3


def test_sample_dir_matches_texel():
    """Sampled directions land in the texel they were drawn from."""
    env = np.ones((8, 16, 3), np.float32)
    mcdf, ccdf, pdf = envlight.build_env_distribution(env)
    rng = np.random.default_rng(3)
    u = rng.uniform(size=(4, 512)).astype(np.float32)
    d, r, c = envlight.sample_env(jnp.asarray(mcdf), jnp.asarray(ccdf),
                                  *[jnp.asarray(x) for x in u])
    d = np.asarray(d)
    theta = np.arccos(np.clip(d[:, 1], -1, 1))
    phi = np.arctan2(d[:, 2], d[:, 0])
    r2 = np.clip((theta / np.pi * 8).astype(int), 0, 7)
    c2 = np.clip(((phi / (2 * np.pi) + 0.5) * 16).astype(int), 0, 15)
    assert (r2 == np.asarray(r)).mean() > 0.99
    assert (c2 == np.asarray(c)).mean() > 0.99


def test_row_searchsorted_matches_jnp():
    """The gather-free per-row binary search must return EXACTLY
    jnp.searchsorted(row, u, side='left') for every lane - including
    u=0, u=1, exact-boundary hits and degenerate (constant) rows -
    so replacing the [N, W] row gather changed no sample."""
    import jax

    rng = np.random.default_rng(7)
    for w in (1, 2, 7, 64, 1000, 1024):
        cdf = np.sort(rng.uniform(size=(17, w)).astype(np.float32), axis=1)
        cdf[:, -1] = 1.0
        cdf[3, :] = 1.0                       # degenerate all-ones row
        n = 512
        r = rng.integers(0, 17, size=n).astype(np.int32)
        u = rng.uniform(size=n).astype(np.float32)
        u[:8] = [0.0, 1.0, 0.5, cdf[0, 0], cdf[0, w - 1],
                 np.nextafter(np.float32(1.0), np.float32(0.0)),
                 cdf[5, w // 2], cdf[5, w // 2] + 1e-7]
        got = np.asarray(envlight._row_searchsorted(
            jnp.asarray(cdf), jnp.asarray(r), jnp.asarray(u)))
        want = np.asarray(jax.vmap(
            lambda row, uu: jnp.searchsorted(row, uu, side="left"))(
                jnp.asarray(cdf)[jnp.asarray(r)], jnp.asarray(u)))
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")


import pytest


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_cell_dedup_table_bit_exact(sampler):
    """The per-(cell, sample) env-sampling table (path._nee_env cell>1
    path) must reproduce the direct per-lane computation bit-exactly -
    it is the same computation deduplicated. Both
    samplers: the Sobol path groups on (pixel-key, sample) differently
    but obeys the same counter-based contract."""
    import jax.numpy as jnp

    from pathtracer.integrator import sky as sky_mod
    from pathtracer.sampling import rng
    from pathtracer.scene import envlight
    from pathtracer.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
               np.array([[0, 1, 2]], np.int32), 0)
    env = np.abs(np.sin(np.arange(8 * 16 * 3))).reshape(8, 16, 3) \
        .astype(np.float32)
    env[3, 5] = 40.0
    b.set_envmap(env)
    scene = b.finalize()

    w = h = 16
    cell, S, depth = 8, 2, 1
    n = w * h * S
    pix = jnp.repeat(jnp.arange(w * h, dtype=jnp.int32), S)
    samp = jnp.tile(jnp.arange(S, dtype=jnp.uint32), w * h) + 7

    # direct per-lane path (keyed on the cell id, like cell>1 draws)
    cells_x = -(-w // cell)
    cid = (pix // w) // cell * cells_x + (pix % w) // cell
    u = rng.uniform4(cid.astype(jnp.uint32), samp, depth,
                     rng.SALT_ENV_SELECT, 0, sampler)
    l_ref, _, _ = envlight.sample_env(
        scene.env_marginal_cdf, scene.env_cond_cdf,
        u[..., 0], u[..., 1], u[..., 2], u[..., 3])
    p_ref = envlight.env_pdf(scene.env_pdf, l_ref)
    le_ref = sky_mod.envmap_radiance(scene.envmap, l_ref)

    # table path (mirrors _nee_env): per-(cell, slot) entries + gather
    n_cells = cells_x * (-(-h // cell))
    s0 = jnp.min(samp)
    ck = jnp.repeat(jnp.arange(n_cells, dtype=jnp.uint32), S)
    sk = jnp.tile(jnp.arange(S, dtype=jnp.uint32), n_cells) + s0
    u_c = rng.uniform4(ck, sk, depth, rng.SALT_ENV_SELECT, 0, sampler)
    l_c, _, _ = envlight.sample_env(
        scene.env_marginal_cdf, scene.env_cond_cdf,
        u_c[..., 0], u_c[..., 1], u_c[..., 2], u_c[..., 3])
    p_c = envlight.env_pdf(scene.env_pdf, l_c)
    le_c = sky_mod.envmap_radiance(scene.envmap, l_c)
    idx = cid.astype(jnp.uint32) * jnp.uint32(S) + (samp - s0)
    np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_c[idx]))
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p_c[idx]))
    np.testing.assert_array_equal(np.asarray(le_ref),
                                  np.asarray(le_c[idx]))
    assert n == l_ref.shape[0]
