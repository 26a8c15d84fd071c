"""Progressive Monte-Carlo path tracer in JAX (XLA + Pallas Triton).

A brand-new framework with the capabilities of the reference Vulkan
real-time path tracer (Hekbas/Real-Time-Pathtracer-Vulkan), re-designed
for wide vector machines:

- Scene layer: glTF/OBJ loaders + procedural scenes -> a frozen pytree of
  device arrays (mirrors the reference's descriptor bindings 3-10,
  main.cpp:441-453).
- Accel layer: on-device LBVH (Morton codes + radix sort + Karras radix tree)
  replacing the driver-built acceleration structure (core/accel.h).
- Kernels: vectorized watertight Moller-Trumbore + stackless threaded-BVH
  traversal; packet traversal whose per-tile cull and cluster sweep run
  as Pallas Triton kernels on the GPU (kernels/triton_cull.py,
  kernels/triton_sweep.py).
- Integrator: wavefront unidirectional path tracer with NEE + power-heuristic
  MIS, GGX metallic-roughness BSDF, dielectrics, alpha stochastic
  transparency, Russian roulette (raygen.rgen semantics).
- Film: f32 progressive accumulation + gamma display (fixes the reference's
  8-bit accumulation quirk, SURVEY.md par.3.6.1).
- Sampling: counter-based PCG4D - exact reproducibility, keyed on
  (pixel, sample, depth, use).
"""

from pathtracer.config import RenderConfig
from pathtracer.render import Renderer, render_frame, render_progressive

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Renderer",
    "render_frame",
    "render_progressive",
]
