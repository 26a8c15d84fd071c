"""Benchmark harness: Mrays/s + ms/frame with exact ray counts.

The reference measures frame time but never prints it (SURVEY.md par.5
"Tracing": glfwGetTime only feeds camera delta-time). This harness times
jitted frames with per-frame host syncs and reports throughput from the
integrator's exact ray counters.

Frames are timed individually, each ending in a host read of its ray
count, and grouped into windows; the headline is the MEDIAN window (a slow
stretch shows up as window spread instead of polluting one long mean), and
`bench_interleaved` alternates windows between legs so two configs see the
card in the same state (clocks, temperature, neighbours on the host).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import jax
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.integrator.camera import Camera
from pathtracer.render import render_frame_with_stats
from pathtracer.scene.types import Scene


@dataclass
class BenchResult:
    mrays_per_sec: float        # from the median window
    ms_per_frame: float         # median window mean
    rays_per_frame: float
    frames: int
    width: int
    height: int
    spp: int
    # window diagnostics (ms/frame per window + spread)
    window_ms: List[float] = field(default_factory=list)
    ms_min: float = 0.0
    ms_max: float = 0.0
    ms_std: float = 0.0

    def as_dict(self):
        return {
            "mrays_per_sec": self.mrays_per_sec,
            "ms_per_frame": self.ms_per_frame,
            "rays_per_frame": self.rays_per_frame,
            "frames": self.frames,
            "resolution": [self.width, self.height],
            "spp": self.spp,
            "window_ms": [round(w, 3) for w in self.window_ms],
            "ms_min": round(self.ms_min, 3),
            "ms_max": round(self.ms_max, 3),
            "ms_std": round(self.ms_std, 3),
        }


def _step(scene, cfg, cam, frame_idx, prime):
    """One timed render step: F=cfg.frame_batch frames' samples at once."""
    F = cfg.frame_batch
    if F > 1:
        from pathtracer.render import render_frame_batched

        priming = cfg.primary_priming and cfg.intersector == "cluster"
        img, rays, prime_o, _ = render_frame_batched(
            scene, cfg, cam, frame_idx, prime=prime, primed=priming,
            frames=F)
        return img, rays, (prime_o if priming else prime)
    return render_frame_with_stats(scene, cfg, cam, frame_idx, prime, True)


def _frame_times(scene, cfg, cam, start, frames, prime):
    """Render `frames` steps, host-syncing each; per-step (dt, rays).

    With cfg.frame_batch=F each step covers F progressive frames (the
    frame index advances by F); _result renormalizes to per-frame stats.
    """
    times, rays_seen = [], []
    for i in range(frames):
        t0 = time.perf_counter()
        img, rays, prime = _step(scene, cfg, cam,
                                 start + i * cfg.frame_batch, prime)
        r = float(rays)            # blocks on the scalar; frame-granular
        times.append(time.perf_counter() - t0)
        rays_seen.append(r)
    jax.block_until_ready(img)
    return times, rays_seen, prime


def _result(times, rays_seen, cfg, windows):
    n = len(times)
    windows = max(1, min(windows, n))
    # split frame times into `windows` near-equal chunks
    bounds = [round(k * n / windows) for k in range(windows + 1)]
    win_ms = []
    for a, b in zip(bounds, bounds[1:]):
        if b > a:
            win_ms.append(sum(times[a:b]) / (b - a) * 1e3)
    med_ms = statistics.median(win_ms)
    # frame_batch steps cover F frames each: renormalize to per-frame
    F = cfg.frame_batch
    if F > 1:
        win_ms = [wm / F for wm in win_ms]
        med_ms = med_ms / F
    rays_pf = sum(rays_seen) / n / F
    return BenchResult(
        mrays_per_sec=rays_pf / med_ms / 1e3,
        ms_per_frame=med_ms,
        rays_per_frame=rays_pf,
        frames=n,
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        window_ms=win_ms,
        ms_min=min(win_ms), ms_max=max(win_ms),
        ms_std=statistics.pstdev(win_ms) if len(win_ms) > 1 else 0.0,
    )


def bench_scene(scene: Scene, cfg: RenderConfig, camera: Camera,
                warmup: int = 4, frames: int = 8,
                windows: int = 4) -> BenchResult:
    """Time progressive frames; returns median-window throughput stats.

    Warmup frames trigger compilation and flush first-run effects (XLA
    autotuning, allocator growth), so they are individually host-synced
    and excluded.
    """
    cam = camera.state()

    prime = None   # priming hints chain across frames (Renderer.step)
    for i in range(warmup):
        img, rays, prime = _step(scene, cfg, cam, i * cfg.frame_batch,
                                 prime)
        float(rays)                    # full sync: flush first-run effects
    jax.block_until_ready(img)

    times, rays_seen, _ = _frame_times(scene, cfg, cam,
                                       warmup * cfg.frame_batch, frames,
                                       prime)
    return _result(times, rays_seen, cfg, windows)


def bench_interleaved(scenes: Dict[str, Scene], cfg: RenderConfig,
                      camera: Camera, warmup: int = 3, frames: int = 4,
                      windows: int = 4) -> Dict[str, BenchResult]:
    """Bench several scenes under ONE config with interleaved windows.

    Each window renders `ceil(frames/windows)`-ish frames of every scene
    in turn, so all legs sample the same card conditions. Use this for
    A/B legs that must be comparable (e.g. textured vs untextured): a
    sequential pair can straddle a change of clocks.
    """
    cam = camera.state()
    labels = list(scenes)
    primes = {}
    for lab in labels:                       # compile + flush each leg
        prime = None
        for i in range(warmup):
            img, rays, prime = _step(scenes[lab], cfg, cam,
                                     i * cfg.frame_batch, prime)
            float(rays)
        jax.block_until_ready(img)
        primes[lab] = prime

    windows = max(1, min(windows, frames))
    bounds = [round(k * frames / windows) for k in range(windows + 1)]
    times = {lab: [] for lab in labels}
    rays_seen = {lab: [] for lab in labels}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        for lab in labels:
            t, r, primes[lab] = _frame_times(
                scenes[lab], cfg, cam, (warmup + a) * cfg.frame_batch,
                b - a, primes[lab])
            times[lab] += t
            rays_seen[lab] += r
    return {lab: _result(times[lab], rays_seen[lab], cfg, windows)
            for lab in labels}
