"""Render configuration.

The reference has no config system: every knob is a compile-time constant
(SURVEY.md par.5 "Config"). This dataclass enumerates that entire observable
option surface:

- resolution            common.h:4-5 (1280x720)
- spp per frame         raygen.rgen:100 (4)
- max path depth        raygen.rgen:128 (6)
- vertical fov          raygen.rgen:113-114 (70 deg)
- RR start depth        raygen.rgen:286 (after depth 3)
- emission gain         raygen.rgen:132 (x10)
- sky model             miss.rmiss:153-163 (gradient x0.2; Hosek-Wilkie
                        implemented but disabled)
- epsilons              raygen.rgen:130,144,164,199-204

The config is a frozen (hashable) dataclass so it can be closed over /
passed as a static argument to jitted functions.
"""

from __future__ import annotations

import dataclasses

# Wavefront pool-saturation point, in lanes (rays): the scale above which
# growing the per-call pool (via spp_batch / frame_batch) is taken to stop
# cutting swept columns (1080p x 4 spp = 8.3M lanes). Also the default
# PT_MAX_WAVEFRONT spatial-part split threshold (render.py), which bounds
# the integrator's per-lane state in device memory. Tuned on the previous
# accelerator, whose device memory was 16 GB; untested on the GPU. All
# auto-frame-batch heuristics derive from this one constant.
POOL_SATURATION_LANES = 1 << 23


def saturating_frame_batch(width: int, height: int, spp: int,
                           cap: int = 8) -> int:
    """Frames/step that grow the pool toward POOL_SATURATION_LANES.

    The '--frame-batch auto' policy (app.py, benchmarks/run_configs.py):
    identical estimator/sample set; a bigger pool cuts swept columns
    until it saturates.
    """
    pool = width * height * spp
    return max(1, min(cap, POOL_SATURATION_LANES // pool))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; safe to use as a jit static arg)."""

    width: int = 1280
    height: int = 720
    spp: int = 4
    max_depth: int = 6
    fov_deg: float = 70.0

    # Russian roulette kicks in for bounce indices strictly greater than this
    # (raygen.rgen:286 `if (depth > 3)`).
    rr_start_depth: int = 3
    rr_clamp_lo: float = 0.05
    rr_clamp_hi: float = 0.95
    throughput_cutoff: float = 1e-4

    # Emission scale applied to emitter radiance (raygen.rgen:132 hard-codes
    # x10 on BSDF-path hits only; we apply it consistently to both estimators
    # unless reference_quirks is set - SURVEY.md par.3.6.2).
    emission_gain: float = 10.0

    # Sky: "gradient" (miss.rmiss:153-156 x sky_gain), "black", "hosek"
    # (miss.rmiss:8-151), or "envmap" (HDR equirect, net-new capability).
    sky: str = "gradient"
    # NEE on the environment map with MIS (sky="envmap" only): a second
    # shadow ray per bounce importance-sampled from the env luminance CDF.
    env_importance_sampling: bool = False
    sky_gain: float = 0.2
    sun_direction: tuple = (0.3, 0.6, 0.2)
    sun_intensity: float = 20.0

    # Base RNG seed, mixed into every counter-based sample key.
    seed: int = 0
    # Sample generator: "pcg" = independent PCG4D uniforms (the
    # reference's estimator class, common.glsl:27-49); "sobol" = padded
    # Owen-scrambled Sobol (sampling/sobol.py) - same counter-based
    # reproducibility, lower variance at equal spp (net-new capability,
    # the reference has no low-discrepancy option).
    sampler: str = "pcg"

    # Thin-lens depth of field (net-new; the reference camera is
    # pinhole-only, camera.cpp): aperture = lens DIAMETER in world
    # units, focus_dist = perpendicular distance of the focal plane
    # along the view axis. aperture 0 = pinhole (identical program).
    aperture: float = 0.0
    focus_dist: float = 0.0

    # Epsilon policy (values from raygen.rgen:130,144,164,199-204).
    t_min: float = 1e-3
    t_max: float = 1e20
    shadow_eps: float = 1e-4

    # Cell-interleaved env-NEE sampling (net-new):
    # pixels in an NxN screen cell share one env-light direction per
    # (sample, depth) draw, so env shadow batches collapse from ~one
    # direction per lane to ~one per cell and the occlusion sort packs
    # them into direction-coherent tiles (incoherent env shadow rays are
    # the costliest ray class of the envmap config). Per-pixel estimator
    # and
    # variance are UNCHANGED (the direction is still drawn from the env
    # pdf; only cross-pixel correlation is introduced - interleaved
    # sampling), so accumulation converges identically; low-spp noise is
    # blocky instead of white. 1 = independent per-pixel draws.
    env_nee_cell: int = 8

    # Russian roulette on env-NEE shadow rays (net-new):
    # trace the env shadow ray with probability q = clip(m * lum(T),
    # 1/8, 1) where T is the path throughput, and weight surviving
    # contributions by 1/q - the reference's own path-RR principle
    # (raygen.rgen:286-290) applied at the shadow-ray site. Unbiased
    # thinning, but it adds variance where paths are dim, so the default
    # is OFF (m = 0): zero-variance-cost estimator.
    # Set m > 0 only for scenes whose deep-bounce occlusion calls
    # actually dominate.
    env_shadow_rr: float = 0.0

    # Reproduce the reference's estimator quirks exactly (SURVEY.md par.3.6):
    # NEE without the x10 gain and emission=mat.emission (not *albedo) on BSDF
    # hits, no MIS weight on BSDF-sampled emitter hits, conditional-lobe-only
    # BSDF pdf. Default False = the fixed, consistent estimator.
    reference_quirks: bool = False

    # Intersection backend: "cluster" (packet/tile traversal - the fast
    # path), "bvh" (threaded LBVH pointer chase), or "brute" (O(n) oracle).
    intersector: str = "cluster"
    # Cluster-sweep route (kernels/packet.resolve_backend): "triton" runs
    # each tile's sweep as one program of a Pallas Triton kernel
    # (kernels/triton_sweep.py, GPU only); "xla" uses the lockstep
    # while_loop formulation; "auto" picks the platform's route and
    # raises on a platform that has none.
    traversal_backend: str = "auto"

    # Ray-batch chunking: rays per jitted wavefront launch. 0 = whole frame.
    rays_per_chunk: int = 0

    # Integrator-owned wavefront compaction: re-sort the whole wavefront
    # ONCE per bounce by (dead, direction octant, origin Morton) inside the
    # bounce loop, so (a) the packet traversal inherits a coherent order
    # and skips its per-chunk/per-call coherence sorts, and (b) dead lanes
    # compact to the back of the wavefront where whole traversal chunks
    # skip via lax.cond (static-shape stream compaction). The [N,16] state
    # permute and scatter cost more than per-chunk sorting saved on the
    # previous accelerator - default False; untested on the GPU.
    wavefront_sort: bool = False

    # Packet-layer per-chunk coherence sort (kernels/packet.py): sort each
    # 32k-ray chunk by (octant, origin Morton) inside every traversal call.
    # Ignored when wavefront_sort already ordered the rays.
    packet_sort: bool = True

    # Trace ALL spp samples of a frame as ONE wavefront (spp * W * H
    # lanes) instead of a host loop of per-sample programs. The coherence
    # sort's pool grows spp-fold: x1.49 fewer bounce sweep columns per
    # ray at 4 spp (an exact count); identical estimator (RNG is keyed on
    # (pixel, sample) either way). Library default stays False
    # because wavefront memory scales linearly with spp (64 spp would be
    # a 132M-lane wavefront at 1080p); bench.py and the headline configs
    # enable it at spp <= 4.
    spp_batch: bool = False

    # Cross-FRAME sample batching: render this many progressive frames'
    # spp pools as ONE wavefront (requires spp_batch). The estimator is
    # the identical sample set (RNG keys on frame*spp + s either way);
    # the film folds all frame_batch frame-means in one accumulate step.
    # Pool growth is the one counted lever on packet stop-tail waste
    # (joint-sort columns: x1.49 at 4 lanes/pixel vs 1).
    frame_batch: int = 1

    # BENCH-ONLY: drop the NEE stage entirely (changes the estimator!).
    # Attributes the shadow-ray cost within real frames. Never set in
    # production.
    skip_nee: bool = False

    # Verified primary-hit prediction across the progressive spp loop:
    # feed each sample's primary hits (one i32 per pixel) back as the
    # next sample's prediction. The hinted triangle is re-tested exactly
    # and its hit distance becomes the per-ray t_max, so the near-to-far
    # traversal schedule shrinks to clusters strictly in front of the
    # verified hit (camera rays are temporally coherent under jittered
    # progressive accumulation). Exact: predictions are verified, never
    # trusted. Only applies to intersector="cluster".
    primary_priming: bool = False

    # Edge-aware a-trous denoiser (film/denoise.py) applied at DISPLAY
    # time only: the accumulated linear radiance is filtered with
    # primary-hit G-buffer edge-stopping (normal/depth/albedo) before
    # tone mapping. The raw accumulation is untouched - progressive
    # convergence and checkpoints stay exact. This is a LOW-SPP PREVIEW
    # feature (measured: halves display-space RMSE at 1 spp, 96^2
    # cornell); once >= 4 samples have accumulated the filter switches
    # to SVGF variance guidance, which backs off toward a no-op as the
    # estimate converges - a converged still is never damaged. The
    # reference reserves a DENOISER_WG_SIZE constant (common.h:6) but
    # ships no denoiser.
    denoise: bool = False
    denoise_iterations: int = 3
    # Firefly clamp (net-new): with clamp_radiance = c > 0, each path
    # sample's total radiance is bounded componentwise at c before
    # accumulation. Biased (energy-losing on rare bright paths) but a
    # standard production variance control; 0 = off (the default - all
    # goldens and parity targets use the unbiased estimator).
    clamp_radiance: float = 0.0

    # Display tone mapping (film.to_display): "gamma" = the reference's
    # pow-1/2.2 (raygen.rgen:305-306, default), "reinhard" / "aces" =
    # filmic highlight rolloff (net-new). Display-time only - the film,
    # checkpoints and goldens stay linear.
    tonemap: str = "gamma"

    # Capture the primary-hit G-buffer even without the denoiser, for
    # AOV export (Renderer.aovs() / --aov): normal, depth, albedo of
    # the first-bounce surface in pixel order. Net-new (the reference
    # renders beauty only).
    capture_gbuffer: bool = False

    # Stochastic bilinear texture filtering: jitter the texel coordinate
    # by a per-(lane, bounce) uniform and take ONE tap whose expectation
    # is the bilinear kernel, instead of 4 deterministic taps. Texture
    # gathers are latency-bound, so one tap cuts the texture path's
    # gathers 4x; the extra noise converges with spp.
    # False = exact 4-tap bilinear (the reference's deterministic linear
    # sampler, core/texture.cpp:57-66).
    stochastic_texture_filtering: bool = True

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("resolution must be positive")
        if self.spp <= 0:
            raise ValueError("spp must be positive")
        if self.env_nee_cell < 1:
            raise ValueError("env_nee_cell must be >= 1")
        if self.aperture < 0.0:
            raise ValueError("aperture must be >= 0")
        if self.tonemap not in ("gamma", "reinhard", "aces"):
            raise ValueError("tonemap must be gamma|reinhard|aces")
        if self.aperture > 0.0 and self.focus_dist <= 0.0:
            raise ValueError("aperture > 0 requires focus_dist > 0 "
                             "(the focal plane distance)")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.sky not in ("gradient", "black", "hosek", "envmap"):
            raise ValueError(f"unknown sky model: {self.sky!r}")
        if self.intersector not in ("cluster", "bvh", "brute"):
            raise ValueError(f"unknown intersector: {self.intersector!r}")
        if self.traversal_backend not in ("auto", "triton", "xla"):
            raise ValueError(
                f"unknown traversal backend: {self.traversal_backend!r}")
        if self.sampler not in ("pcg", "sobol"):
            raise ValueError(f"unknown sampler: {self.sampler!r}")
        if self.frame_batch < 1:
            raise ValueError("frame_batch must be >= 1")
        if self.frame_batch > 1 and not self.spp_batch:
            raise ValueError("frame_batch > 1 requires spp_batch "
                             "(the cross-frame pool IS the batched "
                             "wavefront)")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def aspect(self) -> float:
        return self.width / self.height
