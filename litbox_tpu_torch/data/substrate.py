"""Procedural training-substrate generator (counterpart of the JAX package's
data/substrate.py).

Reference: Assets/Scripts/TrainingSubstrate.cs + TrainingSubstrateGenerators.compute.
Pipeline (ForceCreateTexture, TrainingSubstrate.cs:210-324):
  1. shapes      — union of random rects/ellipses minus inverse cutouts
  2. JFA         — jump-flooding distance field from the shape boundary
  3. edge blur   — alpha *= saturate(dist / (edgeBlur + 1))
  4. noise       — multi-octave simplex cloud with floor/ceiling clip
  5. gradient    — 2-color / 2-density linear gradient
  6. hardness    — alpha ^= 10^sharpness

Random parameterization follows GenerateRandom (TrainingSubstrate.cs:65-139),
including the biased NextRange semantics u^(10^-bias) (RandExtensions.cs:12-14).
Deterministic from a uint seed + version: the parameters are drawn with
numpy exactly as the JAX package draws them, and the texture is made with
torch on the requested device. The 2x3 affines are written out as
multiply-adds, so no matmul precision or accumulation order enters the
shape tests.
"""

from __future__ import annotations

import colorsys
import dataclasses

import numpy as np
import torch

from ..core.types import affine_2x3, affine_inverse
from .noise import snoise01

MAX_SUBSTRATE_SHAPES = 16


@dataclasses.dataclass
class SubstrateParams:
    seed: int = 0
    texture_size: int = 512
    # (kind, inverse) per shape: kind 0=rect, 1=ellipse
    shapes: list = dataclasses.field(default_factory=list)  # dicts: kind, inverse, inv_affine
    edge_blur: float = 10.0
    sharpness: float = 0.0
    has_noise: bool = False
    min_noise_level: int = 0
    max_noise_level: int = 0
    noise_floor: float = 0.0
    noise_ceiling: float = 1.0
    color_a: tuple = (1.0, 1.0, 1.0)
    color_b: tuple = (1.0, 1.0, 1.0)
    density_a: float = 0.1
    density_b: float = 0.01
    gradient_angle: float = 90.0
    gradient_length: float = 0.7


def _next_range(rng, lo, hi, bias=0.0):
    return float(rng.random() ** (10.0 ** -bias) * (hi - lo) + lo)


def generate_random_params(seed: int, version: int = 1, texture_size: int = 512) -> SubstrateParams:
    """Random substrate description (TrainingSubstrate.GenerateRandom :65-139)."""
    rng = np.random.default_rng(seed)
    p = SubstrateParams(seed=seed, texture_size=texture_size)

    n_rects = int(rng.integers(0, 4))
    n_ellipses = int(rng.integers(0, 4))
    n_inv_rects = int(rng.integers(0, 3))
    n_inv_ellipses = int(rng.integers(0, 3))
    if n_rects == 0 and n_ellipses == 0:
        n_rects = 1

    def add(kind, inverse, pos_range, scale_range):
        aff = affine_2x3(
            (_next_range(rng, *scale_range), _next_range(rng, *scale_range)),
            np.deg2rad(_next_range(rng, 0, 360)),
            (_next_range(rng, -pos_range, pos_range), _next_range(rng, -pos_range, pos_range)))
        p.shapes.append(dict(kind=kind, inverse=inverse, inv_affine=affine_inverse(aff)))

    for _ in range(n_rects):
        add(0, False, 0.9, (0.1, 0.7))
    for _ in range(n_ellipses):
        add(1, False, 0.9, (0.1, 1.0))
    for _ in range(n_inv_rects):
        add(0, True, 0.7, (0.1, 0.3))
    for _ in range(n_inv_ellipses):
        add(1, True, 0.7, (0.1, 0.3))

    p.edge_blur = _next_range(rng, 1.0, 128.0, 0.3)
    p.sharpness = _next_range(rng, -1, 1)
    p.has_noise = rng.random() < 0.75
    p.min_noise_level = int(rng.integers(0, 6))
    p.max_noise_level = p.min_noise_level + int(rng.integers(0, 5))
    p.noise_floor = _next_range(rng, 0, 0.6, 0.75)
    p.noise_ceiling = _next_range(rng, 0.6, 1)

    def hsv():
        return colorsys.hsv_to_rgb(rng.random(), _next_range(rng, 0, 1, 0.75),
                                   _next_range(rng, 0.25, 1, 0.75))

    p.color_a = hsv()
    p.color_b = hsv()
    p.density_a = _next_range(rng, 0.01, 0.99)
    p.density_b = _next_range(rng, 0.01, 0.99)
    p.gradient_angle = _next_range(rng, 0, 360)
    p.gradient_length = _next_range(rng, 0.1, 1.4)
    if rng.random() < 0.5:  # no gradient
        p.color_b = p.color_a
        p.density_b = p.density_a

    if version == 2:
        p.min_noise_level = int(rng.integers(0, 3))
        p.max_noise_level = 5 + int(rng.integers(0, 5))
        p.noise_floor = _next_range(rng, 0, 0.3, 0.5)
        p.noise_ceiling = _next_range(rng, 0.85, 1)
    return p


def _grid(size: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xs, ys) integer texel coordinates as float32 and the texel centers
    in [-1, 1]^2, (size, size, 2)."""
    ys, xs = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    xy = torch.stack([(xs + 0.5) / size * 2 - 1, (ys + 0.5) / size * 2 - 1], -1)
    return xs, ys, xy


def _inside(params: SubstrateParams, xy: torch.Tensor) -> torch.Tensor:
    """Step 1 (TrainingSubstrateGenerators.compute:28-72): the union of the
    shapes minus the inverse cutouts, in order, as a (size, size) bool."""
    inside = torch.zeros(xy.shape[:2], dtype=torch.bool, device=xy.device)
    x, y = xy[..., 0], xy[..., 1]
    for sh in params.shapes[:MAX_SUBSTRATE_SHAPES]:
        m = [[float(v) for v in row] for row in np.asarray(sh["inv_affine"], np.float32)]
        lx = m[0][0] * x + m[0][1] * y + m[0][2]
        ly = m[1][0] * x + m[1][1] * y + m[1][2]
        if sh["kind"] == 1:
            s_in = lx * lx + ly * ly <= 1.0
        else:
            s_in = torch.maximum(torch.abs(lx), torch.abs(ly)) <= 1.0
        inside = inside & ~s_in if sh["inverse"] else inside | s_in
    return inside


def _distance(inside: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Step 2 (:75-110): jump flooding in ascending power-of-two stages;
    inside texels find the nearest outside texel. Neighbours are tried dy,
    then dx, and a candidate replaces the best only when strictly nearer, as
    in the JAX version, so ties break the same way. Distances of integer
    coordinates are exact in float32."""
    size = inside.shape[0]
    coord = torch.stack([xs, ys], -1)
    seed_xy = torch.where(inside[..., None], -1.0, coord)

    def dist2(cand):
        diff = cand - coord
        return torch.where(cand[..., 0] < 0, 1e12,
                           diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])

    stage = 1
    while stage < size:
        best, best_d = seed_xy, dist2(seed_xy)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                cand = torch.roll(seed_xy, (-dy * stage, -dx * stage), (0, 1))
                d = dist2(cand)
                take = d < best_d
                best = torch.where(take[..., None], cand, best)
                best_d = torch.where(take, d, best_d)
        # Outside texels keep their own coordinate.
        seed_xy = torch.where(inside[..., None], best, seed_xy)
        stage *= 2

    diff = seed_xy - coord
    dist = torch.sqrt(torch.clamp(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1],
                                  min=0.0))
    return torch.where(seed_xy[..., 0] < 0, float(size), dist)


def _cloud(params: SubstrateParams, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Step 4 (:121-146): the octave sum clipped to [floor, ceiling]. The
    octave offsets replicate the reference's degenerate Random.Init(0)
    LCG-on-w sequence, computed on the host in Python floats."""
    size = xs.shape[0]
    seed = np.uint32(params.seed)
    noise_seed = torch.tensor([float((seed >> np.uint32(16)) & np.uint32(0xFFFF)),
                               float(seed & np.uint32(0xFFFF))], device=xs.device)
    uv = torch.stack([xs + 0.5, ys + 0.5], -1) / size + noise_seed
    cloud = torch.zeros_like(xs)
    max_amp, amp, w_state = 0.0, 1.0, 0
    freq = float(1 << int(params.min_noise_level))
    offset = 0.0
    while freq <= float(1 << int(params.max_noise_level)):
        cloud = cloud + amp * snoise01((uv + offset) * freq)
        max_amp += amp
        amp /= 2.0
        freq *= 2.0
        w_state = (w_state * 1664525 + 1013904223) % (1 << 32)
        offset += 10.0 * float(w_state) * 2.3283064365387e-10
    cloud = cloud / max_amp
    lo = np.float32(params.noise_floor)
    span = np.float32(params.noise_ceiling) - lo  # a float32 difference, as in the JAX version
    return torch.clamp((cloud - float(lo)) / float(span), 0.0, 1.0)


def generate_texture(params: SubstrateParams, device: str | torch.device = "cuda") -> torch.Tensor:
    """(size, size, 4) rgba substrate texture on `device`, deterministic
    from params."""
    size = int(params.texture_size)
    xs, ys, xy = _grid(size, device)
    inside = _inside(params, xy)
    dist = _distance(inside, xs, ys)

    # 3. Edge blur (:113-119).
    blur = float(np.float32(params.edge_blur) + np.float32(1.0))
    alpha = inside.to(torch.float32) * torch.clamp(dist / blur, 0.0, 1.0)

    if params.has_noise:
        alpha = alpha * _cloud(params, xs, ys)

    # 5. Gradient (:148-166).
    ang = np.deg2rad(params.gradient_angle)
    g = np.asarray([np.cos(ang) / params.gradient_length,
                    np.sin(ang) / params.gradient_length,
                    params.gradient_length / 2.0], np.float32)
    grad = torch.clamp(xy[..., 0] * float(g[0]) + xy[..., 1] * float(g[1]) + float(g[2]),
                       0.0, 1.0)
    da, db = float(np.float32(params.density_a)), float(np.float32(params.density_b))
    density = da * (1 - grad) + db * grad
    color_a = torch.tensor(params.color_a, dtype=torch.float32, device=device)
    color_b = torch.tensor(params.color_b, dtype=torch.float32, device=device)
    color = color_a * (1 - grad[..., None]) + color_b * grad[..., None]
    net = torch.where(density > 1.0, alpha * (2.0 - density) + (density - 1.0),
                      alpha * density)

    # 6. Hardness (:168-177).
    net = torch.clamp(net, min=0.0) ** float(np.float32(10.0 ** params.sharpness))
    return torch.cat([color, net[..., None]], -1)


def generate_random(seed: int, version: int = 1, texture_size: int = 512,
                    device: str | torch.device = "cuda"):
    params = generate_random_params(seed, version, texture_size)
    return params, generate_texture(params, device)
