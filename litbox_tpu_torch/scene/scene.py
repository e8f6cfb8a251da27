"""Scene graph as padded struct-of-arrays of tensors (counterpart of the JAX
package's scene/scene.py).

Lights and shapes are padded to a capacity; the host-side `SceneBuilder`
collects them in numpy and `build()` moves them to the requested device.
Coordinates are target texels; shape local spaces are [-1, 1]^2 (rect,
sprite) or the unit disk (ellipse), so `scale` is the half-extent in texels.
Point lights emit from a disk of radius `scale`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (
    LIGHT_POINT,
    SHAPE_ELLIPSE,
    SHAPE_RECT,
    SHAPE_SPRITE,
    affine_2x3,
    affine_inverse,
)


@dataclasses.dataclass(frozen=True)
class Lights:
    """Struct-of-arrays over padded light slots (ref: Lights/RTLightSource.cs:5-40)."""

    kind: torch.Tensor                # (L,) int32
    affine: torch.Tensor              # (L, 2, 3) light -> target texels
    energy: torch.Tensor              # (L, 3) sprite color * intensity^2
    bounces: torch.Tensor             # (L,) int32
    emission_outscatter: torch.Tensor  # (L,)
    tex_index: torch.Tensor           # (L,) int32 into Scene.field_textures
    active: torch.Tensor              # (L,) bool

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Struct-of-arrays over padded shape slots (ref: Shapes/RTObject.cs:5-24)."""

    kind: torch.Tensor        # (S,) int32
    affine: torch.Tensor      # (S, 2, 3) local -> target
    inv_affine: torch.Tensor  # (S, 2, 3) target -> local
    color: torch.Tensor       # (S, 4) rgba tint
    density: torch.Tensor     # (S,) substrate density = 10^substrateLogDensity
    alignment: torch.Tensor   # (S,) particle alignment
    tex_index: torch.Tensor   # (S,) int32 into Scene.textures (0 = white)
    active: torch.Tensor      # (S,) bool

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    lights: Lights
    shapes: Shapes
    textures: torch.Tensor        # (T, TH, TW, 4) substrate textures; [0] all-white
    field_textures: torch.Tensor  # (F, FH, FW, 4) field-light textures; [0] all-white


@dataclasses.dataclass
class SceneBuilder:
    """Host-side scene construction; `build()` produces the Scene."""

    texture_size: int = 256
    field_texture_size: int = 64

    def __post_init__(self):
        self._lights: list[dict] = []
        self._shapes: list[dict] = []
        self._textures: list[np.ndarray] = []

    def add_point_light(self, position, radius, color=(1, 1, 1), intensity=1.0,
                        bounces=2, emission_outscatter=0.1):
        color = np.asarray(color, dtype=np.float32)[:3]
        self._lights.append(dict(
            kind=LIGHT_POINT, affine=affine_2x3((radius, radius), 0.0, position),
            energy=color * intensity * intensity, bounces=bounces,
            emission_outscatter=emission_outscatter, tex_index=0,
        ))
        return self

    def _prep_texture(self, tex, size) -> np.ndarray:
        tex = np.asarray(tex, dtype=np.float32)
        if tex.ndim == 2:
            tex = np.stack([tex, tex, tex, np.ones_like(tex)], axis=-1)
        if tex.shape[-1] == 3:
            tex = np.concatenate([tex, np.ones_like(tex[..., :1])], axis=-1)
        if tex.shape[:2] != (size, size):
            # Nearest resize to the atlas size (host-side, numpy).
            ys = (np.arange(size) + 0.5) * tex.shape[0] / size
            xs = (np.arange(size) + 0.5) * tex.shape[1] / size
            tex = tex[ys.astype(int)[:, None], xs.astype(int)[None, :]]
        return tex

    def _add_shape(self, kind, position, scale, rotation, color, log_density,
                   alignment, texture):
        tex_index = 0
        if texture is not None:
            tex_index = len(self._textures) + 1
            self._textures.append(self._prep_texture(texture, self.texture_size))
        aff = affine_2x3(scale, rotation, position)
        rgba = np.ones(4, np.float32)
        rgba[: len(np.atleast_1d(color))] = np.asarray(color, np.float32)
        self._shapes.append(dict(
            kind=kind, affine=aff, inv_affine=affine_inverse(aff), color=rgba,
            density=float(10.0 ** log_density), alignment=float(alignment),
            tex_index=tex_index,
        ))
        return self

    def add_rect(self, position, size, rotation=0.0, color=(1, 1, 1, 1),
                 log_density=0.0, alignment=0.0, texture=None):
        return self._add_shape(SHAPE_RECT, position, size, rotation, color,
                               log_density, alignment, texture)

    def add_ellipse(self, position, size, rotation=0.0, color=(1, 1, 1, 1),
                    log_density=0.0, alignment=0.0, texture=None):
        return self._add_shape(SHAPE_ELLIPSE, position, size, rotation, color,
                               log_density, alignment, texture)

    def add_sprite(self, position, size, rotation=0.0, color=(1, 1, 1, 1),
                   log_density=0.0, texture=None):
        return self._add_shape(SHAPE_SPRITE, position, size, rotation, color,
                               log_density, 0.0, texture)

    def build(self, max_lights: int = 8, max_shapes: int = 16,
              device: str | torch.device = "cuda") -> Scene:
        nl, ns = len(self._lights), len(self._shapes)
        if nl > max_lights or ns > max_shapes:
            raise ValueError(f"scene exceeds capacity: {nl}/{max_lights} lights, {ns}/{max_shapes} shapes")

        def put(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def pack(entries, field, shape, dtype=np.float32, capacity=0):
            out = np.zeros((capacity,) + shape, dtype=dtype)
            for i, e in enumerate(entries):
                out[i] = e[field]
            return put(out)

        ident = np.zeros((2, 3), np.float32)
        ident[0, 0] = ident[1, 1] = 1.0
        light_affine = np.tile(ident, (max_lights, 1, 1))
        shape_affine = np.tile(ident, (max_shapes, 1, 1))
        for i, e in enumerate(self._lights):
            light_affine[i] = e["affine"]
        shape_inv = shape_affine.copy()
        for i, e in enumerate(self._shapes):
            shape_affine[i] = e["affine"]
            shape_inv[i] = e["inv_affine"]

        lights = Lights(
            kind=pack(self._lights, "kind", (), np.int32, max_lights),
            affine=put(light_affine),
            energy=pack(self._lights, "energy", (3,), np.float32, max_lights),
            bounces=pack(self._lights, "bounces", (), np.int32, max_lights),
            emission_outscatter=pack(self._lights, "emission_outscatter", (), np.float32, max_lights),
            tex_index=pack(self._lights, "tex_index", (), np.int32, max_lights),
            active=put(np.arange(max_lights) < nl),
        )
        shapes = Shapes(
            kind=pack(self._shapes, "kind", (), np.int32, max_shapes),
            affine=put(shape_affine),
            inv_affine=put(shape_inv),
            color=pack(self._shapes, "color", (4,), np.float32, max_shapes),
            density=pack(self._shapes, "density", (), np.float32, max_shapes),
            alignment=pack(self._shapes, "alignment", (), np.float32, max_shapes),
            tex_index=pack(self._shapes, "tex_index", (), np.int32, max_shapes),
            active=put(np.arange(max_shapes) < ns),
        )

        ts = self.texture_size
        textures = np.ones((1 + len(self._textures), ts, ts, 4), np.float32)
        for i, t in enumerate(self._textures):
            textures[i + 1] = t
        fs = self.field_texture_size
        field_textures = np.ones((1, fs, fs, 4), np.float32)

        return Scene(lights=lights, shapes=shapes, textures=put(textures),
                     field_textures=put(field_textures))
