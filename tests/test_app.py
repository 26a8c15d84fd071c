"""App-driver surfaces: multi-model composition, envmap gating, textured
sponza preset (main.cpp:30-41,150-235 scene-assembly parity)."""

import os

import numpy as np
import pytest

from pathtracer import app as app_mod
from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.render import render_frame


def _write_tri_obj(path, z):
    with open(path, "w") as f:
        f.write("v -1 0 {z}\nv 1 0 {z}\nv 0 1 {z}\nf 1 2 3\n".format(z=z))


def test_compose_multiple_models(tmp_path):
    a = str(tmp_path / "a.obj")
    b = str(tmp_path / "b.obj")
    _write_tri_obj(a, 0.0)
    _write_tri_obj(b, 0.0)
    # compose with per-model transforms: b translated +2x, scaled 0.5
    builder = app_mod.load_scene([a, b + "@2,0,0,0.5"])
    scene = builder.finalize()
    assert scene.n_tris == 2
    p = np.asarray(scene.positions)
    # model a spans x in [-1, 1]; model b in [1.5, 2.5]
    assert p[:3, 0].min() == -1.0 and p[:3, 0].max() == 1.0
    assert p[3:, 0].min() == pytest.approx(1.5)
    assert p[3:, 0].max() == pytest.approx(2.5)


def test_compose_rotation(tmp_path):
    a = str(tmp_path / "a.obj")
    _write_tri_obj(a, 1.0)   # triangle in the z=1 plane
    builder = app_mod.load_scene([a + "@0,0,0,1,90"])
    p = np.asarray(builder.finalize().positions)
    # 90 deg yaw: x' = z, z' = -x; the z=1 plane maps onto x=1
    np.testing.assert_allclose(p[:, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(p[:, 2], [1.0, -1.0, 0.0], atol=1e-5)


def test_preset_cannot_compose(tmp_path):
    a = str(tmp_path / "a.obj")
    _write_tri_obj(a, 0.0)
    with pytest.raises(SystemExit):
        app_mod.load_scene(["cornell", a])


def test_sky_envmap_requires_envmap_flag(tmp_path):
    with pytest.raises(SystemExit):
        app_mod.main(["--scene", "cornell", "--sky", "envmap",
                      "--width", "8", "--height", "8", "--frames", "1",
                      "--out", str(tmp_path / "x.png"), "--quiet"])


def test_envmap_cli_render(tmp_path):
    """--sky envmap + --envmap renders with the file's radiance."""
    from pathtracer.scene.hdr import write_hdr

    env = np.zeros((4, 8, 3), np.float32)
    env[:2] = [0.0, 0.0, 4.0]     # upper hemisphere: blue
    hdr = str(tmp_path / "env.hdr")
    write_hdr(hdr, env)
    out = str(tmp_path / "e.png")
    rc = app_mod.main(["--scene", "bunny", "--sky", "envmap",
                       "--envmap", hdr, "--width", "16", "--height", "16",
                       "--spp", "1", "--max-depth", "2", "--frames", "1",
                       "--intersector", "brute", "--out", out, "--quiet"])
    assert rc == 0 and os.path.exists(out)


def test_textured_sponza_smoke():
    """Tiny render of the textured preset: textures + alpha path execute."""
    from pathtracer.scene.procedural import sponza_like

    scene = sponza_like(target_tris=2000, textured=True).finalize()
    assert scene.has_textures
    assert scene.textures.dtype.name == "uint8"
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3,
                       intersector="cluster")
    from pathtracer.accel.cluster import build_scene_clusters

    scene = build_scene_clusters(scene)
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    img = np.asarray(render_frame(scene, cfg, cam.state(), 0))
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_viewer_ansi_formatter():
    """Terminal frame formatter: shape, truecolor SGRs, no tty needed."""
    import numpy as np

    from pathtracer.viewer import downsample, frame_to_ansi

    img = np.zeros((32, 48, 3), np.float32)
    img[:16] = [255, 0, 0]          # top half red
    img[16:] = [0, 255, 0]          # bottom half green
    small = downsample(img, 24, 8)
    assert small.shape == (8, 24, 3)
    np.testing.assert_allclose(small[0, 0], [255, 0, 0])
    np.testing.assert_allclose(small[-1, -1], [0, 255, 0])

    txt = frame_to_ansi(img, cols=24, rows=4)
    lines = txt.split("\n")
    assert len(lines) == 4
    assert "\x1b[38;2;255;0;0m" in lines[0]       # red fg in the top row
    assert "\x1b[48;2;0;255;0m" in lines[-1]      # green bg in the bottom
    assert lines[0].count("▀") == 24


def test_viewer_escape_parsing(monkeypatch):
    """CSI sequences are consumed whole; tail bytes never leak as keys."""
    import os
    import sys

    from pathtracer import viewer

    def feed(data):
        r, w = os.pipe()
        os.write(w, data)
        os.close(w)
        f = os.fdopen(r)
        monkeypatch.setattr(sys, "stdin", f)
        try:
            return viewer._read_keys(0.05)
        finally:
            f.close()

    assert feed(b"\x1b[A") == ["up"]
    # modified arrow (Shift+Up): the whole "\x1b[1;2A" must be eaten -
    # the regression leaked ';2A' as literal keys ('a' strafed the
    # camera)
    assert feed(b"\x1b[1;2A") == ["up"]
    assert feed(b"\x1b[1;2Aw") == ["up", "w"]
    # F5 = CSI 15~ (final byte '~'): consumed, mapped to no-op
    assert feed(b"\x1b[15~w") == ["", "w"]
    assert feed(b"\x1b") == ["esc"]
    assert feed(b"wasd") == ["w", "a", "s", "d"]


def test_frame_batch_auto_cli(tmp_path):
    """--frame-batch auto picks F from the pool rule (config.
    saturating_frame_batch) and renders the same image as per-frame stepping."""
    out = str(tmp_path / "fb.png")
    ck_a = str(tmp_path / "a.npz")
    ck_b = str(tmp_path / "b.npz")
    # 16x16@1spp pool = 256 lanes -> F capped at 8; 8 frames = 1 step
    rc = app_mod.main(["--scene", "cornell", "--width", "16",
                       "--height", "16", "--spp", "1", "--max-depth", "2",
                       "--frames", "8", "--frame-batch", "auto",
                       "--checkpoint", ck_a, "--out", out, "--quiet"])
    assert rc == 0 and os.path.exists(out)
    rc = app_mod.main(["--scene", "cornell", "--width", "16",
                       "--height", "16", "--spp", "1", "--max-depth", "2",
                       "--frames", "8", "--checkpoint", ck_b,
                       "--out", str(tmp_path / "ref.png"), "--quiet"])
    assert rc == 0
    from pathtracer.film import film as fm

    fa, fb = fm.load_checkpoint(ck_a), fm.load_checkpoint(ck_b)
    assert int(fa.frame) == int(fb.frame) == 8
    # identical sample set; only float summation order differs
    np.testing.assert_allclose(np.asarray(fa.accum), np.asarray(fb.accum),
                               rtol=1e-4, atol=1e-5)


def test_aov_export(tmp_path):
    """--aov writes normal/depth/albedo PNGs from the primary-hit
    G-buffer alongside the beauty (net-new over the reference)."""
    import numpy as np

    from pathtracer.app import main

    out = tmp_path / "a.png"
    main(["--scene", "cornell", "--width", "32", "--height", "32",
          "--spp", "1", "--max-depth", "2", "--frames", "1",
          "--aov", "--quiet", "--out", str(out)])
    for name in ("normal", "depth", "albedo"):
        p = tmp_path / f"a_{name}.png"
        assert p.exists(), name
    # the normal AOV maps the back wall's +z normal to blue-ish
    from pathtracer.utils import native

    raw = (tmp_path / "a_normal.png").read_bytes()
    arr = native.png_decode(raw)
    if arr is None:
        from io import BytesIO

        from PIL import Image

        arr = np.asarray(Image.open(BytesIO(raw)).convert("RGB"))
    center = arr[16, 16].astype(np.float32) / 255.0
    assert center[2] > 0.8, center      # +z normal -> B ~ 1.0
    assert abs(center[0] - 0.5) < 0.1   # x ~ 0 -> 0.5
