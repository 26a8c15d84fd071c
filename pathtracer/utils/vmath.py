"""Vector math over [..., 3] jnp arrays.

Replaces the reference's hand-rolled header math library (math/vec3.h,
math/mat4.h - SURVEY.md par.2.1 "Math library") with batched jnp ops: every
function maps over a leading batch of rays/points, the vector-friendly SoA
equivalent of the reference's per-lane vec3 arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-5  # common.glsl:24


def dot(a, b):
    """Batched 3-vector dot product -> [...]."""
    return jnp.sum(a * b, axis=-1)


def dotk(a, b):
    """Batched dot with kept dim -> [..., 1]."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps: float = 1e-20):
    return a * jax.lax.rsqrt(jnp.maximum(dotk(a, a), eps))


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (incident points toward surface)."""
    return i - 2.0 * dotk(n, i) * n


def refract(i, n, eta):
    """GLSL refract. Returns (refracted_dir, tir_mask).

    i: unit incident (toward surface), n: unit normal (against incident),
    eta: ni/nt ratio [...]. On total internal reflection the direction is
    zeros and tir_mask is True (matches GLSL returning vec3(0) -
    raygen.rgen:157-159 tests `refr == vec3(0.0)`).
    """
    eta = jnp.asarray(eta)[..., None]
    cosi = -dotk(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = (k < 0.0)[..., 0]
    refr = eta * i + (eta * cosi - jnp.sqrt(jnp.maximum(k, 0.0))) * n
    refr = jnp.where(tir[..., None], 0.0, refr)
    return refr, tir


def luminance(rgb):
    """Rec.709 luminance (main.cpp:287 weights)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def maxc(rgb):
    """Max colour component (raygen.rgen:287 RR probability)."""
    return jnp.max(rgb, axis=-1)


def onb(n):
    """Branch-based orthonormal basis (T, B) for normal n.

    Re-derivation of common.glsl:52-58 createCoordinateSystem: the branch is
    realised as a jnp.where select (no per-lane control flow).
    """
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    cond = (jnp.abs(x) > jnp.abs(y))[..., None]
    t_a = jnp.stack([z, jnp.zeros_like(x), -x], axis=-1)
    t_b = jnp.stack([jnp.zeros_like(x), -z, y], axis=-1)
    t = normalize(jnp.where(cond, t_a, t_b))
    b = cross(n, t)
    return t, b


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)
