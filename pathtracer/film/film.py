"""Film: progressive accumulation, tone mapping, image I/O, checkpointing.

Replaces the reference's accumulation/output images + swapchain blit
(main.cpp:120-147, 707-713). Two deliberate upgrades over the reference:

- True f32 accumulation. The reference declares the accumulation image
  rgba32f in the shader (raygen.rgen:11) but creates it as 8-bit UNORM
  (main.cpp:128-133), so its progressive average quantizes every frame
  (SURVEY.md par.3.6.1). Our accumulator is an explicit f32 array.
- Explicit checkpoint/resume. The reference's only persistent state is that
  GPU image + the frame counter (SURVEY.md par.5 "Checkpoint"); here it is a
  (accum, frame) pytree, and the counter-based RNG makes resume *exact*:
  rendering frames [k, n) after restore bit-matches a straight run.

The temporal accumulation recurrence matches raygen.rgen:300-302:
    accum' = (accum * frame + frame_radiance) / (frame + 1)
and display applies gamma 1/2.2 once (raygen.rgen:305-306).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Film:
    """Progressive film state. accum: f32[H,W,3] linear; frame: i32 scalar."""

    accum: jnp.ndarray
    frame: jnp.ndarray


def new_film(width: int, height: int) -> Film:
    return Film(
        accum=jnp.zeros((height, width, 3), jnp.float32),
        frame=jnp.zeros((), jnp.int32),
    )


def accumulate(film: Film, frame_radiance: jnp.ndarray) -> Film:
    """One progressive step: raygen.rgen:300-302 recurrence in f32."""
    f = film.frame.astype(jnp.float32)
    accum = (film.accum * f + frame_radiance) / (f + 1.0)
    return Film(accum=accum, frame=film.frame + 1)


def accumulate_many(film: Film, radiance_sum: jnp.ndarray, k) -> Film:
    """Fold k frames' summed radiance in ONE step (cfg.frame_batch).

    Algebraically identical to k accumulate() calls with the k frame
    means: (accum*f + sum_k) / (f+k) - the recurrence telescopes, so
    cross-frame batched rendering accumulates exactly (up to float
    association) what the per-frame loop would.
    """
    f = film.frame.astype(jnp.float32)
    kf = jnp.float32(k)
    accum = (film.accum * f + radiance_sum) / (f + kf)
    return Film(accum=accum, frame=film.frame + jnp.int32(k))


def reset(film: Film) -> Film:
    """Accumulation reset on camera move (main.cpp:678-681 semantics)."""
    return Film(accum=jnp.zeros_like(film.accum), frame=jnp.zeros_like(film.frame))


def to_display(linear: jnp.ndarray, tonemap: str = "gamma") -> jnp.ndarray:
    """Display transform, clipped to [0,1].

    "gamma"    pow(x, 1/2.2) - the reference's transform
               (raygen.rgen:305-306); the default everywhere.
    "reinhard" x/(1+x) then gamma - soft highlight rolloff (net-new).
    "aces"     Narkowicz's ACES filmic fit then gamma (net-new).
    Display-time only: accumulation, checkpoints and goldens are always
    linear radiance.
    """
    x = jnp.maximum(linear, 0.0)
    if tonemap == "reinhard":
        x = x / (1.0 + x)
    elif tonemap == "aces":
        # Krzysztof Narkowicz's luminance-fit of the ACES RRT+ODT
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        x = (x * (a * x + b)) / (x * (c * x + d) + e)
    elif tonemap != "gamma":
        raise ValueError(f"unknown tonemap {tonemap!r} "
                         "(gamma|reinhard|aces)")
    return jnp.clip(x ** (1.0 / 2.2), 0.0, 1.0)


def rmse(a, b) -> float:
    """RMSE between two images (the BASELINE.json accuracy metric)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_png(path: str, image) -> None:
    """Write an image to PNG. Accepts f32 [0,1] or u8, [H,W,3] or [H,W].

    Uses the native C++ encoder (utils/native.py), else utils/png.py.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    from pathtracer.utils import native, png

    data = native.png_encode(arr)
    with open(path, "wb") as f:
        f.write(data if data is not None else png.encode(arr))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as f32 [0,1] [H,W] or [H,W,C] (native decoder, else
    utils/png.py)."""
    with open(path, "rb") as f:
        raw = f.read()

    from pathtracer.utils import native, png

    arr = native.png_decode(raw)
    if arr is None:
        arr = png.decode(raw)
    out = arr.astype(np.float32) / 255.0
    return out[..., 0] if arr.shape[2] == 1 else out


def save_checkpoint(path: str, film: Film) -> None:
    np.savez(path, accum=np.asarray(film.accum), frame=np.asarray(film.frame))


def load_checkpoint(path: str) -> Film:
    data = np.load(path)
    return Film(accum=jnp.asarray(data["accum"]),
                frame=jnp.asarray(data["frame"], jnp.int32))
