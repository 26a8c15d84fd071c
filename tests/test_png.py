"""The numpy + zlib PNG codec behind the native one (utils/png.py)."""

import struct
import zlib

import numpy as np
import pytest

from pathtracer.utils import native, png


def _img(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_roundtrip(c):
    img = _img(13, 29, c, seed=c)
    out = png.decode(png.encode(img))
    np.testing.assert_array_equal(out, img)


def test_encode_2d_is_gray():
    img = _img(5, 7, 1)[..., 0]
    np.testing.assert_array_equal(png.decode(png.encode(img))[..., 0], img)


def _filtered_png(img, ftype):
    """A PNG whose every row uses filter `ftype` (the PNG spec's
    forward filters, written independently of the decoder)."""
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [3, 4])
def test_decode_every_filter(ftype, c):
    img = _img(9, 11, c, seed=ftype)
    data = _filtered_png(img, ftype)
    np.testing.assert_array_equal(png.decode(data), img)
    if native.available():
        np.testing.assert_array_equal(native.png_decode(data), img)


def test_decode_matches_native_encoder():
    if not native.available():
        pytest.skip("native library not built")
    img = _img(17, 23, 3)
    np.testing.assert_array_equal(png.decode(native.png_encode(img)), img)


def test_decode_rejects_other_formats():
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + b"\0" * 20)


def test_film_png_io_without_native(monkeypatch, tmp_path):
    from pathtracer.film import film

    monkeypatch.setattr(native, "png_encode", lambda img: None)
    monkeypatch.setattr(native, "png_decode", lambda raw: None)
    img = np.linspace(0.0, 1.0, 4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    path = str(tmp_path / "f.png")
    film.write_png(path, img)
    back = film.read_png(path)
    np.testing.assert_allclose(back, img, atol=0.5 / 255 + 1e-6)
