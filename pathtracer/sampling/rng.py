"""Counter-based random number generation.

The reference threads a mutable PCG stream through the shader
(common.glsl:27-49) seeded per (pixel, sample, frame) via pcg2d
(raygen.rgen:105-106) - a design with documented seed collisions
(SURVEY.md par.3.6.12) that is also hostile to SPMD: stateful streams force a
serialisation order.

The design is stateless/counter-based: every random number is a
pure hash of a structured key (pixel, sample, depth, use, seed). This gives

- exact reproducibility across runs, chips, jit/non-jit and sharding layouts;
- free parallelism - no stream to thread through lax loops;
- exact checkpoint/resume - frame k's samples are a pure function of k.

The core hash is PCG4D (Jarzynski & Olano, JCGT 2020, "Hash Functions for
GPU Rendering") - the 4-component generalisation of the reference's pcg2d.
The reference's exact `pcg`/`pcg2d`/`rand` (common.glsl:27-49) are also
re-derived here as oracles for parity tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Salt slots: dimension allocation per (pixel, sample, depth). Each bounce
# consumes a disjoint set of uses, mirroring the reference's draw order
# (raygen.rgen:109,143,159,172,181,265,269,288) without its stream coupling.
SALT_JITTER = 0        # 2D pixel jitter                  raygen.rgen:109
SALT_ALPHA = 1         # alpha stochastic transparency    raygen.rgen:143
SALT_DIELECTRIC = 2    # reflect/refract lobe choice      raygen.rgen:159
SALT_LIGHT_SELECT = 3  # NEE CDF triangle pick            raygen.rgen:172
SALT_LIGHT_UV = 4      # NEE point-on-triangle            raygen.rgen:181
SALT_BSDF_LOBE = 5     # diffuse/specular lobe choice     raygen.rgen:265
SALT_BSDF_UV = 6       # BSDF direction sample            raygen.rgen:269
SALT_RR = 7            # Russian roulette                 raygen.rgen:288
SALT_ENV_SELECT = 8    # envmap NEE texel pick (net-new)
SALT_ENV_UV = 9        # envmap NEE in-texel jitter (net-new)
SALT_TEX_FILTER = 10   # stochastic bilinear texel jitter (net-new)
SALT_ENV_RR = 11       # env-NEE shadow-ray Russian roulette (net-new)
_SALTS_PER_DEPTH = 12

_U32 = jnp.uint32


def pcg4d(v):
    """PCG4D hash: uint32[..., 4] -> uint32[..., 4] (pure function)."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x, y, z, w = (a ^ (a >> _U32(16)) for a in (x, y, z, w))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def _key(pixel, sample, depth_salt, seed):
    pixel = jnp.asarray(pixel, _U32)
    sample = jnp.asarray(sample, _U32)
    shape = jnp.broadcast_shapes(pixel.shape, sample.shape)
    pixel = jnp.broadcast_to(pixel, shape)
    sample = jnp.broadcast_to(sample, shape)
    ds = jnp.broadcast_to(jnp.asarray(depth_salt, _U32), shape)
    sd = jnp.broadcast_to(jnp.asarray(seed, _U32), shape)
    return jnp.stack([pixel, sample, ds, sd], axis=-1)


def _to_unit(bits):
    """uint32 -> f32 in [0, 1): top 24 bits scaled by 2^-24 (exact in f32)."""
    return (bits >> _U32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def uniform4(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    """Four U[0,1) floats keyed on (pixel, sample, depth, salt).

    pixel/sample broadcast together; depth & salt are per-bounce ints.
    sampler (static): "pcg" = independent PCG4D uniforms (reference
    estimator class, common.glsl:27-49); "sobol" = padded 4D
    Owen-scrambled Sobol (sampling/sobol.py) - same counter-based
    contract, lower variance at equal spp.
    """
    depth_salt = jnp.asarray(depth, _U32) * _U32(_SALTS_PER_DEPTH) + _U32(salt)
    if sampler == "sobol":
        from pathtracer.sampling import sobol as sobol_mod

        sample = jnp.asarray(sample, _U32)
        shape = jnp.broadcast_shapes(jnp.asarray(pixel).shape, sample.shape)
        sample = jnp.broadcast_to(sample, shape)
        # Group key: everything BUT the sample index (the Sobol counter).
        gk = pcg4d(_key(pixel, _U32(0x536F626C), depth_salt, seed))
        bits = sobol_mod.scrambled_sobol4(sample, gk)
    elif sampler == "pcg":
        bits = pcg4d(_key(pixel, sample, depth_salt, seed))
    else:
        raise ValueError(f"unknown sampler {sampler!r} (pcg|sobol)")
    return _to_unit(bits)


def uniform2(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    u = uniform4(pixel, sample, depth, salt, seed, sampler)
    return u[..., 0], u[..., 1]


def uniform1(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    return uniform4(pixel, sample, depth, salt, seed, sampler)[..., 0]


# ---------------------------------------------------------------------------
# Reference-parity oracles (numpy, scalar semantics of common.glsl:27-49).
# Used only in tests to prove our re-derivations of the reference RNG match
# its observable behavior; the renderer itself uses the counter-based PCG4D.
# ---------------------------------------------------------------------------

def ref_pcg(state: np.uint32):
    """One step of the reference's pcg stream (common.glsl:27-33).

    Returns (output_word, new_state).
    """
    with np.errstate(over="ignore"):
        state = np.uint32(state)
        prev = np.uint32(state * np.uint32(747796405) + np.uint32(2891336453))
        shift = np.uint32((prev >> np.uint32(28)) + np.uint32(4))
        word = np.uint32(((prev >> shift) ^ prev) * np.uint32(277803737))
        out = np.uint32((word >> np.uint32(22)) ^ word)
    return out, prev


def ref_pcg2d(v):
    """The reference's pcg2d seed hash (common.glsl:34-44). v: uint32[2]."""
    with np.errstate(over="ignore"):
        v = np.asarray(v, np.uint32).copy()
        v = v * np.uint32(1664525) + np.uint32(1013904223)
        v[0] += v[1] * np.uint32(1664525)
        v[1] += v[0] * np.uint32(1664525)
        v = v ^ (v >> np.uint32(16))
        v[0] += v[1] * np.uint32(1664525)
        v[1] += v[0] * np.uint32(1664525)
        v = v ^ (v >> np.uint32(16))
    return v


def ref_rand(state: np.uint32):
    """The reference's rand() (common.glsl:45-49). Returns (float, new_state)."""
    out, state = ref_pcg(state)
    return np.float32(out) * np.float32(1.0 / 0xFFFFFFFF), state
