"""Edge-aware a-trous wavelet denoiser (SVGF-family, single frame).

The reference carries a vestigial DENOISER_WG_SIZE constant (common.h:6)
but ships no denoiser; real-time path tracing at 4 spp/frame relies on
one. This is the classic Dammertz et al. a-trous wavelet reconstruction
with SVGF-style edge-stopping functions, shaped for a vector machine: every iteration
is 25 static full-image shifted multiply-adds (XLA fuses the whole
filter; no gathers, no data-dependent control flow).

Inputs come from the renderer's primary-hit G-buffer
(integrator/path.trace_paths(want_gbuffer=True)):
  radiance f32[H,W,3] linear, normal f32[H,W,3], depth f32[H,W]
  (inf = sky), albedo f32[H,W,3].

Albedo is demodulated first (filter irradiance, re-modulate after) so
texture detail never blurs; sky pixels (depth = inf) pass through
untouched. Edge-stopping weights:
  w = h(tap) * exp(-|L_p - L_q|^2 / sigma_l)
            * max(0, n_p . n_q)^sigma_n
            * exp(-|z_p - z_q|^2 / (sigma_z * step))
with the usual 5-tap B3-spline kernel h = [1,4,6,4,1]/16 per axis,
dilated 2^i per iteration. The luminance term uses the RELATIVE
difference (normalized by the brighter of the two taps) so it is
exposure-invariant - HDR radiance spans orders of magnitude and an
absolute sigma would collapse every weight to zero near lights.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2(img, dy: int, dx: int):
    """Static 2D shift with edge-clamp padding ([H,W,...])."""
    if dy:
        pad = [(max(dy, 0), max(-dy, 0))] + [(0, 0)] * (img.ndim - 1)
        img = jnp.pad(img, pad, mode="edge")
        img = img[max(-dy, 0):img.shape[0] - max(dy, 0)]
    if dx:
        pad = [(0, 0), (max(dx, 0), max(-dx, 0))] + \
            [(0, 0)] * (img.ndim - 2)
        img = jnp.pad(img, pad, mode="edge")
        img = img[:, max(-dx, 0):img.shape[1] - max(dx, 0)]
    return img


@functools.partial(jax.jit, static_argnames=("iterations",))
def atrous_denoise(radiance, normal, depth, albedo, iterations: int = 3,
                   sigma_l: float = 1.0, sigma_n: float = 32.0,
                   sigma_z: float = 1.0, variance=None):
    """Denoise linear radiance f32[H,W,3]. Returns same shape/dtype.

    iterations: a-trous levels (kernel footprint grows as 2^i); 4 covers
    a 33x33 neighborhood. Sky pixels (depth = inf) are returned as-is.

    variance: optional f32[H,W] per-pixel variance of the MEAN radiance
    luminance (the renderer's spp/frame moments). When given, the
    luminance weight becomes SVGF's variance-guided form
    exp(-|dL| / (4 sqrt(var(p)) + eps)) with the variance 3x3-prefiltered
    and propagated through each level as var' = sum(w^2 var_q)/(sum w)^2
    - strong smoothing exactly where the estimate is noisy, edges kept
    where it is converged. Without it, an exposure-invariant relative
    difference is used.
    """
    sky = ~jnp.isfinite(depth)
    z = jnp.where(sky, 0.0, depth)
    # normalize depth contrast by the scene's depth spread so sigma_z is
    # scale-free
    z_span = jnp.maximum(jnp.max(z) - jnp.min(z), 1e-6)
    z = z / z_span
    # demodulate: filter irradiance estimate, keep texture detail
    alb = jnp.maximum(albedo, 1e-3)
    irr = radiance / alb
    var = None
    if variance is not None:
        # moments were taken on RAW radiance; demodulate to irradiance
        # luminance scale to match lum_c below
        alb_l = jnp.maximum(jnp.sum(
            alb * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1), 1e-3)
        var = jnp.maximum(variance, 0.0) / (alb_l * alb_l)

    out = irr
    for i in range(iterations):
        step = 1 << i
        lum_c = jnp.sum(out * jnp.asarray([0.2126, 0.7152, 0.0722]),
                        axis=-1)
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[:2], out.dtype)
        vacc = None
        if var is not None:
            # 3x3 gaussian-prefiltered std dev steadies the guide (SVGF)
            gv = jnp.zeros_like(var)
            for gy in (-1, 0, 1):
                for gx in (-1, 0, 1):
                    gw = (2.0 - abs(gy)) * (2.0 - abs(gx)) / 16.0
                    gv = gv + gw * _shift2(var, gy, gx)
            sdev = jnp.sqrt(jnp.maximum(gv, 0.0))
            vacc = jnp.zeros_like(var)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                h = _B3[ky + 2] * _B3[kx + 2]
                dy, dx = ky * step, kx * step
                n_q = _shift2(normal, dy, dx)
                z_q = _shift2(z, dy, dx)
                l_q = _shift2(lum_c, dy, dx)
                sky_q = _shift2(sky, dy, dx)
                w_n = jnp.maximum(jnp.sum(normal * n_q, axis=-1),
                                  0.0) ** sigma_n
                w_z = jnp.exp(-(z - z_q) ** 2 / (sigma_z * step * 0.01))
                if var is not None:
                    w_l = jnp.exp(-jnp.abs(lum_c - l_q)
                                  / (4.0 * sdev + 1e-4))
                else:
                    rel = (lum_c - l_q) / (jnp.maximum(
                        jnp.maximum(lum_c, l_q), 1e-3))
                    w_l = jnp.exp(-rel * rel / sigma_l)
                w = h * w_n * w_z * w_l * (~sky_q)
                acc = acc + _shift2(out, dy, dx) * w[..., None]
                wsum = wsum + w
                if var is not None:
                    vacc = vacc + w * w * _shift2(var, dy, dx)
        wn = jnp.maximum(wsum, 1e-8)
        out = acc / wn[..., None]
        if var is not None:
            var = vacc / (wn * wn)
    result = out * alb
    return jnp.where(sky[..., None], radiance, result)
