"""Test configuration: CPU backend with 8 virtual devices.

The standard JAX trick for testing shard_map logic with no accelerator
(SURVEY.md par.4.5): split the host platform into 8 devices. Must run
before jax is imported anywhere.

Tests run on the CPU unless JAX_PLATFORMS names another platform: on a
machine with an NVIDIA card, `JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/` runs the tests marked `gpu`, which skip everywhere else.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent compilation cache (utils/compile_cache.py): the unrolled
# integrator costs minutes to compile on a few CPU cores.
from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip the test unless JAX runs on a GPU; decided here, at run time."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's platform is {jax.default_backend()}")


@pytest.fixture(autouse=True, scope="module")
def _release_executables_per_module():
    """Free loaded XLA executables after every test module.

    The full single-process suite (~190 jitted tests) reproducibly
    segfaulted inside `backend.deserialize_executable` (JAX persistent
    compile-cache read, jax/_src/compilation_cache.py) at ~96% of the
    run, while every test passed in isolation — classic process-resource
    accumulation from hundreds of LoadedExecutables kept alive by jit
    caches. Dropping them per module keeps the client's footprint
    bounded; subsequent calls re-load from the on-disk cache (fast
    deserialize, no recompile).
    """
    yield
    jax.clear_caches()

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.integrator.camera import Camera  # noqa: E402
from pathtracer.scene import procedural  # noqa: E402


@pytest.fixture(scope="session")
def cornell_scene():
    return procedural.cornell_box().finalize()


@pytest.fixture(scope="session")
def cornell_camera():
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    return cam


@pytest.fixture(scope="session")
def tiny_cfg():
    """Small, fast render config shared by full-pipeline tests."""
    return RenderConfig(width=32, height=32, spp=1, max_depth=3,
                        intersector="brute")


@pytest.fixture(scope="session")
def random_tri_soup():
    rng = np.random.default_rng(42)
    t = 200
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    return v0, v1, v2


@pytest.fixture(scope="session")
def random_rays():
    rng = np.random.default_rng(7)
    n = 500
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d
