"""Environment lighting ("miss shader").

Re-derivation of miss.rmiss:

- `gradient_sky`: the active simple vertical gradient (miss.rmiss:153-156),
  scaled by sky_gain (x0.2 at miss.rmiss:163).
- `hosek_wilkie_sky`: the full Hosek-Wilkie sky model present-but-disabled in
  the reference (miss.rmiss:8-151, SURVEY.md par.3.6.6), vectorized; the
  coefficient tables are the model's published numeric data (turbidity 3,
  albedo 1) as embedded in the reference.
- `envmap_radiance`: equirect HDR environment lookup (net-new capability,
  BASELINE config 4).

All functions map unit directions [..., 3] -> linear radiance [..., 3].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

M_PI = 3.14159265358979323846

# Hosek-Wilkie published coefficients, turbidity=3 albedo=1 slice
# (miss.rmiss:8-13): 9 coeffs x 6 quintic-Bezier control points per channel.
_COEFFS_X = np.array([-1.171419, -0.242975, -8.991334, 9.571216, -0.027729, 0.668826, 0.076835, 3.785611, 0.634764, -1.228554, -0.291756, 2.753986, -2.491780, -0.046634, 0.311830, 0.075465, 4.463096, 0.595507, -1.093124, -0.244777, 0.909741, 0.544830, -0.295782, 2.024167, -0.000515, -1.069081, 0.936956, -1.056994, 0.015695, -0.821749, 1.870818, 0.706193, -1.483928, 0.597821, 6.864902, 0.367333, -1.054871, -0.275813, 2.712807, -5.950110, -6.554039, 2.447523, -0.189517, -1.454292, 0.913174, -1.100218, -0.174624, 1.438505, 11.154810, -3.266076, -0.883736, 0.197010, 1.991595, 0.590782], np.float32)
_COEFFS_Y = np.array([-1.185983, -0.258118, -7.761056, 8.317053, -0.033518, 0.667667, 0.059417, 3.820727, 0.632403, -1.268591, -0.339807, 2.348503, -2.023779, -0.053685, 0.108328, 0.084029, 3.910254, 0.557748, -1.071353, -0.199246, 0.787839, 0.197470, -0.303306, 2.335298, -0.082053, 0.795445, 0.997231, -1.089513, -0.031044, -0.599575, 2.330281, 0.658194, -1.821467, 0.667997, 5.090195, 0.312516, -1.040214, -0.257093, 2.660489, -6.506045, -7.053586, 2.763153, -0.243363, -0.764818, 0.945294, -1.116052, -0.183199, 1.457694, 11.636080, -3.216426, -1.045594, 0.228500, 1.817407, 0.581040], np.float32)
_COEFFS_Z = np.array([-1.354183, -0.513062, -42.192680, 42.717720, -0.005365, 0.413674, 0.012352, 2.520122, 0.518727, -1.741434, -0.958976, -8.230339, 9.296799, -0.009600, 0.499497, 0.029555, 0.366710, 0.352700, -0.691735, 0.215489, -0.876026, 0.233412, -0.019096, 0.474803, -0.113851, 6.515360, 1.225097, -1.293189, -0.421870, 1.620952, -0.785860, -0.037694, 0.663679, 0.336494, -0.534102, 0.212835, -0.973552, -0.132549, 1.007517, 0.259826, 0.067622, 0.001421, -0.069160, 3.185897, 0.864196, -1.094800, -0.196206, 0.575559, 0.290626, 0.262575, 0.764405, 0.134749, 2.677126, 0.646546], np.float32)
_RAD_X = np.array([1.468395, 2.211970, -2.845869, 20.750270, 15.248220, 19.376220], np.float32)
_RAD_Y = np.array([1.516536, 2.438729, -3.624121, 22.986210, 15.997820, 20.700270], np.float32)
_RAD_Z = np.array([1.234428, 2.289628, -3.404699, 14.994360, 34.683900, 30.848420], np.float32)

# sRGB D65 XYZ->linear-RGB matrix (miss.rmiss:133-140).
_XYZ_TO_RGB = np.array([
    [3.24096994, -1.53738318, -0.49861076],
    [-0.96924364, 1.8759675, 0.04155506],
    [0.55630080, -0.20397696, 1.05697151],
], np.float32)


def gradient_sky(d, gain: float = 0.2):
    """Simple vertical gradient (miss.rmiss:153-156) x gain."""
    t = jnp.clip(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)
    top = jnp.array([0.6, 0.7, 0.9], jnp.float32)
    bot = jnp.array([0.02, 0.02, 0.05], jnp.float32)
    m = ((1.0 - t) ** 2)[..., None]
    return (top * (1.0 - m) + bot * m) * gain


def _quintic_bezier(cp, t):
    """cp: [..., 6] control points, t: [...] -> [...]."""
    t = t[..., None]
    ti = 1.0 - t
    w = jnp.concatenate([
        ti ** 5, 5 * t * ti ** 4, 10 * t ** 2 * ti ** 3,
        10 * t ** 3 * ti ** 2, 5 * t ** 4 * ti, t ** 5], axis=-1)
    return jnp.sum(cp * w, axis=-1)


def _hw_F(theta, gamma, c):
    """Perez-style F (miss.rmiss:94-108). c: [..., 9] coefficients."""
    A, B, C, D, E, Fv, G, I, H = (c[..., i] for i in range(9))
    cg = jnp.cos(gamma)
    chi = (1.0 + cg * cg) / (1.0 + H * H - 2.0 * H * cg) ** 1.5
    ct = jnp.cos(theta)
    return ((1.0 + A * jnp.exp(B / (ct + 0.01)))
            * (C + D * jnp.exp(E * gamma) + Fv * cg * cg + G * chi
               + I * jnp.sqrt(jnp.maximum(ct, 0.0))))


def hosek_wilkie_sky(d, sun_dir, intensity: float = 20.0):
    """Hosek-Wilkie sky radiance (miss.rmiss:8-151, turbidity 3, albedo 1)."""
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    s = jnp.asarray(sun_dir, jnp.float32)
    s = s / jnp.linalg.norm(s)

    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    sun_zenith = jnp.arccos(jnp.clip(s[1], -1.0, 1.0))
    gamma = jnp.arccos(jnp.clip(jnp.sum(d * s, axis=-1), -1.0, 1.0))

    # t-parameter from sun elevation (miss.rmiss:61-64).
    elev = M_PI / 2.0 - sun_zenith
    t = jnp.clip(elev / (M_PI / 2.0), 0.0, 1.0) ** (1.0 / 3.0)
    tb = jnp.broadcast_to(t, theta.shape)

    xyz = []
    for coeffs, rad in ((_COEFFS_X, _RAD_X), (_COEFFS_Y, _RAD_Y),
                        (_COEFFS_Z, _RAD_Z)):
        cp = jnp.asarray(coeffs).reshape(6, 9)  # [quintic, coeff]
        c = _quintic_bezier(
            jnp.moveaxis(jnp.broadcast_to(
                cp, theta.shape + (6, 9)), -1, -2), tb[..., None])  # [...,9]
        mean_rad = _quintic_bezier(jnp.asarray(rad), t)
        xyz.append(_hw_F(theta, gamma, c) * mean_rad)
    xyz = jnp.stack(xyz, axis=-1)
    # HIGHEST keeps the GPU's float32 product out of TF32
    rgb = jnp.matmul(xyz, jnp.asarray(_XYZ_TO_RGB).T,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(rgb, 0.0) * intensity


def envmap_radiance(envmap, d, blocks=None):
    """Bilinear equirect lookup: envmap f32[H,W,3], d unit [..., 3].

    blocks: optional pre-packed 2x2 footprint rows f32[H,W,12]
    (Scene.envmap_blocks) - one wide-row gather instead of four narrow
    taps, bit-identical filtering.
    """
    h, w = envmap.shape[0], envmap.shape[1]
    u = (jnp.arctan2(d[..., 2], d[..., 0]) / (2.0 * M_PI) + 0.5) * w - 0.5
    v = (jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / M_PI) * h - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = (x0 + 1) % w
    x0 = x0 % w
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    y0 = jnp.clip(y0, 0, h - 1)
    if blocks is not None:
        row = blocks[y0, x0]                       # [..., 12], one gather
        a = row[..., 0:3] * (1 - fx) + row[..., 3:6] * fx
        b = row[..., 6:9] * (1 - fx) + row[..., 9:12] * fx
        return a * (1 - fy) + b * fy
    a = envmap[y0, x0] * (1 - fx) + envmap[y0, x1] * fx
    b = envmap[y1, x0] * (1 - fx) + envmap[y1, x1] * fx
    return a * (1 - fy) + b * fy


def sky_radiance(cfg, envmap, d, envmap_blocks=None):
    """Dispatch on cfg.sky (static) - the miss-shader entry point."""
    if cfg.sky == "black":
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    if cfg.sky == "gradient":
        return gradient_sky(d, cfg.sky_gain)
    if cfg.sky == "hosek":
        return hosek_wilkie_sky(d, cfg.sun_direction, cfg.sun_intensity)
    if cfg.sky == "envmap":
        return envmap_radiance(envmap, d, blocks=envmap_blocks)
    raise ValueError(cfg.sky)
