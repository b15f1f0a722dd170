"""Scene container: SoA primitive + material tables.

The reference stores an array-of-structs of tagged-union ``CudaObj``
primitives and ``Material``s owned by a device-side ``RenderManager``
(``simulation/cuda_object.h:16-123``, ``simulation/material.h:17-68``,
``utils/render_manager.h:60-68``). Here the same tagged-union idea becomes
structure-of-arrays: one row per primitive with both sphere and triangle
fields, intersected branch-free and selected by a type mask. Scene upload is
a ``jax.device_put`` (replicated across the mesh) instead of cudaMemcpy +
pointer-patch kernels (``main.cu:176-195``).

Primitive type tags match the reference (cuda_object.h:12-14); material type
tags match material.h:13-15 plus an emissive extension (the reference ships a
Cornell-box light mesh it never wires up — ``models/cornellbox/light.obj``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

# Primitive tags (cuda_object.h:12-14). TYPE_MESH is declared by the
# reference but never constructed; meshes here are expanded to triangle rows.
PRIM_SPHERE = 1
PRIM_TRIANGLE = 3

# Material tags (material.h:13-15) + emissive extension.
MAT_LAMBERTIAN = 1
MAT_METAL = 2
MAT_DIELECTRIC = 4
MAT_EMISSIVE = 8


class Scene(NamedTuple):
    """SoA scene. N primitives, M materials. All arrays are device-ready.

    Sphere rows: ``v0`` = center, ``radius`` = signed radius (negative radius
    gives inward normals — the hollow-glass trick, cuda_object.h:24 +
    main.cu:233). Triangle rows: ``v0`` + edges ``e1 = v1 - v0``,
    ``e2 = v2 - v0`` and the precomputed face normal
    ``normalize(cross(e1, e2))`` (triangle.h:13-20).
    """
    prim_type: jnp.ndarray   # (N,) int32
    v0: jnp.ndarray          # (N, 3)
    e1: jnp.ndarray          # (N, 3)
    e2: jnp.ndarray          # (N, 3)
    radius: jnp.ndarray      # (N,)
    tri_normal: jnp.ndarray  # (N, 3)
    prim_mat: jnp.ndarray    # (N,) int32
    box_min: jnp.ndarray     # (N, 3) primitive AABBs (cuda_object.h:21-42)
    box_max: jnp.ndarray     # (N, 3)

    mat_type: jnp.ndarray    # (M,) int32
    albedo: jnp.ndarray      # (M, 3)
    fuzz: jnp.ndarray        # (M,)
    ir: jnp.ndarray          # (M,) index of refraction
    emit: jnp.ndarray        # (M, 3) emissive radiance
    tex_id: jnp.ndarray      # (M,) int32, -1 = plain albedo (material.h:64)

    world_min: jnp.ndarray   # (3,) union of primitive AABBs (morton domain)
    world_max: jnp.ndarray   # (3,)

    # Emissive primitive ids, (L,) int32 — the light list for next-event
    # estimation (render/lights.py). L == 0 -> NEE unavailable.
    light_idx: jnp.ndarray

    # Texture atlas: K images stacked into one (K, TH, TW, 3) array
    # (resampled to a common size). Empty -> shape (0, 1, 1, 3).
    textures: jnp.ndarray

    @property
    def num_prims(self) -> int:
        return self.prim_type.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_idx.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_type.shape[0]


class SceneBuilder:
    """Host-side scene assembly (numpy), mirroring the reference's host
    ``std::vector<CudaObj>/<Material>`` build + upload pattern
    (main.cu:57-117) but producing SoA device arrays."""

    def __init__(self):
        self._prims = []      # (type, v0, e1, e2, radius, normal, mat)
        self._mats = []       # (type, albedo, fuzz, ir, emit, tex_id)
        self._textures = []

    # --- materials (ctor overloads, material.h:22-26) ---
    def add_lambertian(self, albedo, tex_id: int = -1) -> int:
        return self._add_mat(MAT_LAMBERTIAN, albedo, 0.0, 0.0, (0, 0, 0), tex_id)

    def add_metal(self, albedo, fuzz: float) -> int:
        return self._add_mat(MAT_METAL, albedo, min(fuzz, 1.0), 0.0, (0, 0, 0), -1)

    def add_dielectric(self, ir: float) -> int:
        return self._add_mat(MAT_DIELECTRIC, (0, 0, 0), 0.0, ir, (0, 0, 0), -1)

    def add_emissive(self, emit) -> int:
        return self._add_mat(MAT_EMISSIVE, (0, 0, 0), 0.0, 0.0, emit, -1)

    def _add_mat(self, mtype, albedo, fuzz, ir, emit, tex_id) -> int:
        self._mats.append((mtype, np.asarray(albedo, np.float32),
                           float(fuzz), float(ir),
                           np.asarray(emit, np.float32), int(tex_id)))
        return len(self._mats) - 1

    def add_texture(self, image) -> int:
        """Register an image texture; returns its tex_id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    # --- primitives ---
    def add_sphere(self, center, radius: float, mat: int):
        """Signed radius; AABB from |radius| (cuda_object.h:21-28)."""
        c = np.asarray(center, np.float32)
        self._prims.append((PRIM_SPHERE, c, np.zeros(3, np.float32),
                            np.zeros(3, np.float32), np.float32(radius),
                            np.zeros(3, np.float32), int(mat)))

    def add_triangle(self, v0, v1, v2, mat: int):
        """Precomputes edges + face normal (triangle.h:13-20) and the
        vertex-extent AABB (cuda_object.h:31-42)."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        e1, e2 = v1 - v0, v2 - v0
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n)
        n = n / norm if norm > 0 else n
        self._prims.append((PRIM_TRIANGLE, v0, e1.astype(np.float32),
                            e2.astype(np.float32), np.float32(0.0),
                            n.astype(np.float32), int(mat)))

    def add_mesh(self, vertices, faces, mat: int):
        """Expand an indexed triangle mesh into triangle rows.

        (The reference declares TYPE_MESH but never builds one,
        cuda_object.h:13 + SURVEY §2.1; expansion to independent triangles is
        the SoA-native representation.)"""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        for f in faces:
            self.add_triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]], mat)

    def build(self, pad_to: Optional[int] = None) -> Scene:
        if not self._prims:
            raise ValueError("empty scene")
        n = len(self._prims)
        ptype = np.array([p[0] for p in self._prims], np.int32)
        v0 = np.stack([p[1] for p in self._prims])
        e1 = np.stack([p[2] for p in self._prims])
        e2 = np.stack([p[3] for p in self._prims])
        radius = np.array([p[4] for p in self._prims], np.float32)
        tri_n = np.stack([p[5] for p in self._prims])
        pmat = np.array([p[6] for p in self._prims], np.int32)

        is_sphere = (ptype == PRIM_SPHERE)[:, None]
        r_abs = np.abs(radius)[:, None]
        sph_min, sph_max = v0 - r_abs, v0 + r_abs
        tri_min = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
        tri_max = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
        box_min = np.where(is_sphere, sph_min, tri_min).astype(np.float32)
        box_max = np.where(is_sphere, sph_max, tri_max).astype(np.float32)

        world_min = box_min.min(axis=0)
        world_max = box_max.max(axis=0)

        if pad_to is not None and pad_to > n:
            # Pad with degenerate far-away spheres that can never be hit
            # (radius 0, box inverted) so array shapes are jit-static.
            pad = pad_to - n
            big = np.float32(3e37)
            ptype = np.concatenate([ptype, np.full(pad, PRIM_SPHERE, np.int32)])
            v0 = np.concatenate([v0, np.full((pad, 3), big, np.float32)])
            e1 = np.concatenate([e1, np.zeros((pad, 3), np.float32)])
            e2 = np.concatenate([e2, np.zeros((pad, 3), np.float32)])
            radius = np.concatenate([radius, np.zeros(pad, np.float32)])
            tri_n = np.concatenate([tri_n, np.zeros((pad, 3), np.float32)])
            pmat = np.concatenate([pmat, np.zeros(pad, np.int32)])
            box_min = np.concatenate([box_min, np.full((pad, 3), big, np.float32)])
            box_max = np.concatenate([box_max, np.full((pad, 3), -big, np.float32)])

        if not self._mats:
            raise ValueError("scene has no materials")
        mtype = np.array([m[0] for m in self._mats], np.int32)
        albedo = np.stack([m[1] for m in self._mats])
        fuzz = np.array([m[2] for m in self._mats], np.float32)
        ir = np.array([m[3] for m in self._mats], np.float32)
        emit = np.stack([m[4] for m in self._mats])
        tex_id = np.array([m[5] for m in self._mats], np.int32)

        if self._textures:
            th = max(t.shape[0] for t in self._textures)
            tw = max(t.shape[1] for t in self._textures)
            atlas = np.zeros((len(self._textures), th, tw, 3), np.float32)
            for i, t in enumerate(self._textures):
                if t.shape[:2] != (th, tw):
                    # nearest-neighbor resample to the atlas resolution
                    yi = (np.arange(th) * t.shape[0] // th)
                    xi = (np.arange(tw) * t.shape[1] // tw)
                    t = t[yi][:, xi]
                atlas[i] = t[..., :3]
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)

        # lights = real (non-padding) prims with an emissive material
        light_idx = np.nonzero(
            mtype[pmat[:n]] == MAT_EMISSIVE)[0].astype(np.int32)

        return Scene(
            prim_type=jnp.asarray(ptype), v0=jnp.asarray(v0),
            e1=jnp.asarray(e1), e2=jnp.asarray(e2),
            radius=jnp.asarray(radius), tri_normal=jnp.asarray(tri_n),
            prim_mat=jnp.asarray(pmat),
            box_min=jnp.asarray(box_min), box_max=jnp.asarray(box_max),
            mat_type=jnp.asarray(mtype), albedo=jnp.asarray(albedo),
            fuzz=jnp.asarray(fuzz), ir=jnp.asarray(ir),
            emit=jnp.asarray(emit), tex_id=jnp.asarray(tex_id),
            world_min=jnp.asarray(world_min), world_max=jnp.asarray(world_max),
            light_idx=jnp.asarray(light_idx),
            textures=jnp.asarray(atlas))
