"""Buffer inspector (counterpart of the JAX package's diag/picker.py;
reference: Assets/Scripts/SimulationTexturePicker.cs).

Exposes every internal buffer of a running Simulation as a displayable
float image, normalized/tone-mapped the way the reference's picker quad
renders them. Each view is computed where the simulation runs and copied to
the host once, as (H, W, 3) float32 numpy. `dump_all` writes the full set to
PNG for eyeballing.
"""

from __future__ import annotations

import enum
import os

import numpy as np
import torch

from ..io.images import write_png
from ..post.tonemap import tonemap_ue5
from ..scene.gbuffer import build_pyramid
from .analysis import analysis_a, analysis_b


class TextureType(enum.Enum):
    HDR = "hdr"
    VARIANCE = "variance"
    IMPORTANCE = "importance"
    FORWARD_ACCUMULATION = "forward_accumulation"
    AI_TONEMAPPED = "ai_tonemapped"
    AI_HDR = "ai_hdr"
    ALBEDO = "albedo"
    TRANSMISSIBILITY = "transmissibility"
    NORMAL_ROUGHNESS = "normal_roughness"
    QUADTREE = "quadtree"
    ANALYSIS_A = "analysis_a"
    ANALYSIS_B = "analysis_b"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).cpu().numpy()


def _norm01(x: torch.Tensor) -> np.ndarray:
    x = _host(x)
    hi = x.max()
    return x / hi if hi > 0 else x


def _gray(x: np.ndarray) -> np.ndarray:
    return np.stack([x] * 3, -1) if x.ndim == 2 else x


def pick(sim, which: TextureType, ai=None) -> np.ndarray:
    """Fetch a named buffer from a Simulation as (H, W, 3) float display RGB.

    `ai` is an optional engine.pipeline.AIAccelerator supplying the AI_HDR /
    AI_TONEMAPPED views (the reference wires the accelerator into the picker
    the same way, SimulationTexturePicker.cs:23,72-77); without one those
    views render black, matching the reference's disabled-AI behavior."""
    if which == TextureType.HDR:
        return _host(tonemap_ue5(sim.simulation_output_hdr))
    if which == TextureType.VARIANCE:
        return _gray(_norm01(sim.variance_map))
    if which == TextureType.IMPORTANCE:
        if sim.importance_map is None:
            # Pyramid generation is consumer-driven: attach as a consumer
            # and compute it on demand (engine keeps it fresh afterwards).
            if sim.refresh_importance_map() is None:
                return np.zeros((sim.height // 2, sim.width // 2, 3), np.float32)
        return _gray(_norm01(sim.importance_map[0]))
    if which == TextureType.FORWARD_ACCUMULATION:
        # Raw pre-HDR accumulated deposits of tracer A
        # (SimulationTexturePicker.cs:96-97 via ITracerDebug).
        return _gray(_norm01(sim.tracer_a.forward.raw_accumulation))
    if which == TextureType.AI_HDR:
        if ai is None or ai.hdr_output is None:
            return np.zeros((sim.height, sim.width, 3), np.float32)
        return _host(tonemap_ue5(ai.hdr_output))
    if which == TextureType.AI_TONEMAPPED:
        if ai is None or ai.tonemapped_output is None:
            return np.zeros((sim.height, sim.width, 3), np.float32)
        return _host(ai.tonemapped_output)
    if which == TextureType.ALBEDO:
        return _host(sim.gbuffer.albedo[..., :3])
    if which == TextureType.TRANSMISSIBILITY:
        return _gray(_host(sim.gbuffer.transmissibility))
    if which == TextureType.NORMAL_ROUGHNESS:
        return (_host(sim.gbuffer.normal[..., :3]) + 1.0) * 0.5
    if which == TextureType.QUADTREE:
        return _gray(_norm01(build_pyramid(sim.gbuffer).quadtree))
    if which == TextureType.ANALYSIS_A:
        return _gray(_norm01(analysis_a(sim.tracer_a.tracer_output,
                                        sim.tracer_b.tracer_output)))
    if which == TextureType.ANALYSIS_B:
        a = analysis_a(sim.tracer_a.tracer_output, sim.tracer_b.tracer_output)
        filtered = analysis_b(a, sim.gbuffer.albedo, sim.simulation_output_hdr, a)
        return _gray(_norm01(filtered))
    raise ValueError(which)


def dump_all(sim, folder: str, ai=None) -> list[str]:
    os.makedirs(folder, exist_ok=True)
    paths = []
    for which in TextureType:
        img = pick(sim, which, ai=ai)
        path = os.path.join(folder, f"{which.value}.png")
        write_png(path, np.clip(img, 0, 1), srgb_encode=False)
        paths.append(path)
    return paths
