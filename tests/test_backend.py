"""Sweep-route resolution, the compile-cache helper, and chip_smoke.py on
a machine without a GPU.

The route is named, never guessed: "auto" resolves per platform and
raises where there is none, and the Triton kernel runs off the GPU only
when the caller asks for the interpreter explicitly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.kernels import packet, triton_sweep
from pathtracer.render import make_intersectors
from pathtracer.scene import procedural
from pathtracer.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,platform,interpret,want", [
    ("auto", "gpu", False, "triton"),
    ("auto", "cpu", False, "xla"),
    ("xla", "gpu", False, "xla"),
    ("xla", "cpu", False, "xla"),
    ("triton", "gpu", False, "triton"),
    ("triton", "cpu", True, "triton"),
])
def test_resolve_backend(backend, platform, interpret, want):
    assert packet.resolve_backend(backend, platform, interpret) == want


@pytest.mark.parametrize("backend,platform,match", [
    ("triton", "cpu", "only for the GPU"),
    ("auto", "metal", "no traversal backend"),
    ("auto", "rocm", "no traversal backend"),
    ("pallas", "gpu", "unknown traversal backend"),
])
def test_resolve_backend_refuses(backend, platform, match):
    with pytest.raises(ValueError, match=match):
        packet.resolve_backend(backend, platform)


def test_default_platform_is_jax_backend():
    assert packet.resolve_backend("auto") == packet.AUTO_BACKEND[
        jax.default_backend()]


def test_triton_without_interpret_raises_on_cpu():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.uniform(-1, 1, (64, 3)), jnp.float32)
    from pathtracer.accel.cluster import build_clusters

    accel = build_clusters(v, v + 0.1, v + jnp.asarray([0.0, 0.1, 0.0]),
                           max_clusters=4)
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (8, 1))
    with pytest.raises(ValueError, match="only for the GPU"):
        packet.intersect_clusters(accel, o, d, 1e-3, 1e20, backend="triton")
    with pytest.raises(ValueError, match="only for the GPU"):
        packet.occluded_clusters(accel, o, d, 1.0, backend="triton")


def test_config_rejects_old_route_name():
    with pytest.raises(ValueError, match="traversal backend"):
        RenderConfig(traversal_backend="pallas")
    assert RenderConfig().traversal_backend == "auto"


def test_make_intersectors_records_route():
    from pathtracer.accel.cluster import build_scene_clusters

    scene = build_scene_clusters(procedural.bunny_like(
        subdivisions=2).finalize())
    cfg = RenderConfig(width=8, height=8, spp=1, intersector="cluster")
    fi, fo = make_intersectors(scene, cfg)
    assert fi.backend == fo.backend == "xla"       # the CPU's route
    fi, fo = make_intersectors(scene, RenderConfig(intersector="brute"))
    assert fi.backend == fo.backend == "brute"
    with pytest.raises(ValueError, match="only for the GPU"):
        make_intersectors(scene, RenderConfig(traversal_backend="triton"))


def test_pack_rays_layout():
    tiles, r = 3, 16
    o = jnp.arange(tiles * r * 3, dtype=jnp.float32).reshape(tiles, r, 3)
    d = -o
    cap = jnp.full((tiles, r), 7.0)
    rays = triton_sweep.pack_rays(o, d, cap)
    assert rays.shape == (tiles, triton_sweep.RAY_ROWS, r)
    np.testing.assert_array_equal(rays[:, 0:3], jnp.swapaxes(o, 1, 2))
    np.testing.assert_array_equal(rays[:, 3:6], jnp.swapaxes(d, 1, 2))
    np.testing.assert_array_equal(rays[:, triton_sweep.CAP_ROW], cap)
    np.testing.assert_array_equal(rays[:, 7], 0.0)


@pytest.mark.parametrize("k,want", [(8, 8), (32, 32), (128, 32), (512, 32)])
def test_sub_cols(k, want):
    assert triton_sweep.sub_cols(k) == want
    assert k % triton_sweep.sub_cols(k) == 0


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []                    # JAX reads the variable itself


def test_compile_cache_default_is_repo(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for flags in ([], ["--multi"]):
        p = subprocess.run([sys.executable, "chip_smoke.py"] + flags,
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode != 0
        assert "'cpu'" in p.stderr
        assert '"ok": true' not in p.stdout


def test_chip_smoke_check_raises_on_failure(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.check("fine", {"ok": True, "x": 1})
    with pytest.raises(AssertionError, match="bad"):
        chip_smoke.check("bad", {"ok": False, "x": 2})
    out = capsys.readouterr().out
    assert 'check fine: {"ok": true, "x": 1}' in out
