"""Device-resident scene representation.

A frozen pytree of jnp arrays - the device-resident analog of the reference's
descriptor bindings 3-10 (main.cpp:441-453):

  binding 3 vertices   -> positions/normals/uvs/tangents SoA (the reference
                          packs these as 11-float AoS records,
                          closesthit.rchit:38-47; SoA gathers are the
                          vector-friendly layout)
  binding 4 indices    -> indices [T,3]
  binding 5 materials  -> mat_* SoA (16-float AoS in the reference,
                          model_loader.h:26-39)
  binding 6 faceMatIdx -> face_material [T]
  binding 7 textures[] -> a padded texture stack [K, TH, TW, 4]
  binding 8 emissive   -> light_* arrays (EmissiveTriGPU, main.cpp:69-76)
  binding 9 CDF        -> light_cdf
  binding 10 lightCount-> static has_lights + light array length

plus the acceleration structure (binding 0's TLAS), which here is an LBVH in
flat arrays (pathtracer.accel.lbvh) instead of a driver-built blob
(core/accel.h:12-53).

The scene is uploaded once with jax.device_put - the analog of the
reference's one-time staging-buffer uploads (buffer.cpp:94-112).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

MAT_LAMBERTIAN = 0  # model_loader.h:8
MAT_METAL = 1       # model_loader.h:9 (defined but never branched on - quirk 5)
MAT_DIELECTRIC = 2  # model_loader.h:10


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bvh:
    """Threaded (stackless) LBVH in flat arrays. See accel/lbvh.py.

    n_nodes = 2 * n_tris - 1, laid out in DFS order. Traversal follows
    hit_link on AABB hit and miss_link on AABB miss; leaves carry one
    triangle id. -1 terminates.
    """

    aabb_min: jnp.ndarray   # f32 [n_nodes, 3]
    aabb_max: jnp.ndarray   # f32 [n_nodes, 3]
    hit_link: jnp.ndarray   # i32 [n_nodes] next node in DFS order (or -1)
    miss_link: jnp.ndarray  # i32 [n_nodes] skip link (or -1)
    tri_id: jnp.ndarray     # i32 [n_nodes] leaf triangle id, -1 for internal


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Frozen device scene. All arrays jnp; meta fields are static."""

    # Geometry (world-space baked at load, like model_loader.cpp:148-155).
    positions: jnp.ndarray      # f32 [V, 3]
    normals: jnp.ndarray        # f32 [V, 3]
    uvs: jnp.ndarray            # f32 [V, 2]
    tangents: jnp.ndarray       # f32 [V, 3]
    indices: jnp.ndarray        # i32 [T, 3]
    face_material: jnp.ndarray  # i32 [T]

    # Materials SoA (model_loader.h:26-39 layout, unpacked).
    mat_albedo: jnp.ndarray     # f32 [M, 3]
    mat_emission: jnp.ndarray   # f32 [M, 3]
    mat_roughness: jnp.ndarray  # f32 [M]
    mat_metallic: jnp.ndarray   # f32 [M]
    mat_ior: jnp.ndarray        # f32 [M]
    mat_alpha: jnp.ndarray      # f32 [M]
    mat_type: jnp.ndarray       # i32 [M]
    mat_albedo_tex: jnp.ndarray  # i32 [M] index into textures, -1 = none
    mat_mr_tex: jnp.ndarray      # i32 [M]
    mat_normal_tex: jnp.ndarray  # i32 [M]

    # Texture stack: u8 raw (sRGB-encoded) values, stored at TRUE per-
    # texture resolution in the top-left of a common-max-size stack (the
    # reference's textures are 8-bit stb_image decodes, texture.cpp:13;
    # u8 storage quarters the gather bandwidth and HBM footprint vs f32 -
    # decode to f32 happens after the gather in _sample_texture).
    textures: jnp.ndarray       # u8 [K, TH, TW, 4]
    tex_wh: jnp.ndarray         # i32 [K, 2] true (width, height) per texture

    # Emissive triangle lights + CDF (main.cpp:261-324 semantics).
    light_v0: jnp.ndarray       # f32 [L, 3]
    light_v1: jnp.ndarray       # f32 [L, 3]
    light_v2: jnp.ndarray       # f32 [L, 3]
    light_normal: jnp.ndarray   # f32 [L, 3]
    light_emission: jnp.ndarray  # f32 [L, 3]  (= mat.emission * mat.albedo)
    light_area: jnp.ndarray     # f32 [L]
    light_cdf: jnp.ndarray      # f32 [L] normalized cumulative weights
    light_pdf: jnp.ndarray      # f32 [L] per-light selection probability
    # Per-triangle area-domain light pdf (select_prob / area; 0 if the
    # triangle is not a light). Enables MIS weighting of BSDF-sampled
    # emitter hits - the reference omits this (SURVEY.md par.3.6.3).
    tri_light_pdf_area: jnp.ndarray  # f32 [T]

    # Environment map (sky="envmap"): equirect HDR radiance + its
    # importance-sampling distribution (scene/envlight.py).
    envmap: jnp.ndarray          # f32 [EH, EW, 3] (1x1 black if unused)
    env_marginal_cdf: jnp.ndarray  # f32 [EH]
    env_cond_cdf: jnp.ndarray      # f32 [EH, EW]
    env_pdf: jnp.ndarray           # f32 [EH, EW] solid-angle pdf

    # Acceleration structures (None until built). `bvh` is the threaded
    # LBVH (accel/lbvh.py); `clusters` is the flat cluster accel for packet
    # traversal (accel/cluster.py) - the fast path.
    bvh: Optional[Bvh]
    clusters: Optional[object] = None
    # Second cluster accel for closest-hit rays (the fine build), beside
    # the coarse one that serves shadow rays - the renderer keeps both
    # and picks per call (render.py make_intersectors).
    clusters_fine: Optional[object] = None

    # Per-MATERIAL composite texels: one u32x3 row packs the albedo RGBA,
    # metal-rough, and normal-map texels at a shared resolution, so the
    # stochastic sampler fetches all three maps with ONE 12-byte-row
    # gather (wide gather rows amortize latency). Built under a memory
    # budget in SceneBuilder.finalize; None = use the per-texture stack.
    tex_comp: Optional[jnp.ndarray] = None     # u32 [M, CH, CW, 3]
    tex_comp_wh: Optional[jnp.ndarray] = None  # i32 [M, 2] true (w, h)

    # Pre-packed 2x2 envmap texel blocks: row [y, x] holds the four
    # bilinear footprint texels (y,x), (y,x+1 wrap), (y+1 clip,x),
    # (y+1,x+1), so one 48-byte wide-row gather replaces FOUR narrow
    # 12-byte gathers in envmap_radiance - same wide-row lesson as
    # tex_comp above. Bilinear arithmetic is
    # bit-identical. None when no envmap (or memory-gated).
    envmap_blocks: Optional[jnp.ndarray] = None  # f32 [EH, EW, 12]

    # --- static metadata (not traced) ---
    has_lights: bool = dataclasses.field(metadata=dict(static=True), default=False)
    n_lights: int = dataclasses.field(metadata=dict(static=True), default=0)
    has_textures: bool = dataclasses.field(metadata=dict(static=True), default=False)
    has_envmap: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @property
    def n_tris(self) -> int:
        return self.indices.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def n_materials(self) -> int:
        return self.mat_albedo.shape[0]

    def with_bvh(self, bvh: Bvh) -> "Scene":
        return dataclasses.replace(self, bvh=bvh)

    def tri_vertices(self, tri_ids):
        """Gather triangle corner positions: ([...,3],)*3 for tri ids [...]."""
        idx = self.indices[tri_ids]  # [..., 3]
        return (self.positions[idx[..., 0]],
                self.positions[idx[..., 1]],
                self.positions[idx[..., 2]])
