"""Morton (Z-order) codes for LBVH construction.

30-bit 3D Morton codes (10 bits/axis) over triangle centroids, computed with
pure uint32 bit arithmetic on-device. This is the first stage of the on-device
LBVH builder that replaces the reference's driver-built acceleration
structure (core/accel.h:21-45; SURVEY.md par.2.2 "GPU driver AS build").
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def expand_bits_10(v):
    """Spread the low 10 bits of uint32[...] so consecutive bits are 3 apart."""
    v = v.astype(_U32)
    v = (v * _U32(0x00010001)) & _U32(0xFF0000FF)
    v = (v * _U32(0x00000101)) & _U32(0x0F00F00F)
    v = (v * _U32(0x00000011)) & _U32(0xC30C30C3)
    v = (v * _U32(0x00000005)) & _U32(0x49249249)
    return v


def morton3d(x, y, z):
    """Interleave three 10-bit integer coordinates -> 30-bit Morton code."""
    return (expand_bits_10(x) << _U32(2)) | (expand_bits_10(y) << _U32(1)) \
        | expand_bits_10(z)


def morton_codes(points, lo=None, hi=None):
    """Morton codes of f32 points [..., 3] normalized into their AABB.

    lo/hi default to the batch min/max (the scene AABB). Returns uint32[...].
    """
    if lo is None:
        lo = jnp.min(points, axis=tuple(range(points.ndim - 1)))
    if hi is None:
        hi = jnp.max(points, axis=tuple(range(points.ndim - 1)))
    extent = jnp.maximum(hi - lo, 1e-12)
    unit = jnp.clip((points - lo) / extent, 0.0, 1.0)
    q = jnp.minimum((unit * 1024.0).astype(jnp.uint32), _U32(1023))
    return morton3d(q[..., 0], q[..., 1], q[..., 2])
