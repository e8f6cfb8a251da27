"""Headless "Abduction" demo (counterpart of the JAX package's
demo/abduction.py; reference: Assets/Demo_Abduction/).

The reference ships a playable Unity game — a UFO abducting things over
procedural night hills, with clouds relit by the photon simulation. This
module reproduces the *rendering* side end-to-end as a scripted scene:

  * procedural hills (layered silhouette substrates, ProceduralHill.cs)
  * star field + moon backdrop
  * cloud layer (procedural cloud-density sprites, ProceduralCloud.cs)
  * UFO with a spotlight abduction beam + body point light
  * full pipeline: RBT photon simulation -> HDR -> additive composition
    over the backdrop -> foreground cloud relight -> Uchimura tonemap

`render_sequence` produces animation frames (the UFO drifts and the beam
sweeps), exercising realtime-mode scene invalidation each frame.

Scenes, simulations and frames live on `device` ("cuda" unless the caller
asks for the CPU); a rendered frame stays there until its one host copy for
the PNG. The procedural textures are drawn on the device and handed to the
SceneBuilder as host arrays.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..data.noise import snoise01
from ..engine import Mode, Simulation
from ..io.images import write_png
from ..post.cloud_relight import relight_layer, shade_foreground
from ..post.compositor import composite_additive, composite_premultiplied
from ..post.tonemap import tonemap_uchimura
from ..scene import SceneBuilder
from .game import AbductionGame, GameInput


def _noise01(pts: np.ndarray, device) -> np.ndarray:
    """snoise01 at float32 points (..., 2), computed on `device`, on the host."""
    return snoise01(torch.from_numpy(pts).to(device)).cpu().numpy()


def _hills_texture(size: int, seed: int, base: float, rough: float,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Procedural hill silhouette (analog of ProceduralHill.cs)."""
    xs = np.linspace(0, 4, size)
    pts = np.stack([xs.astype(np.float32), np.full(size, seed * 7.13, np.float32)], -1)
    ridge = base + rough * _noise01(pts, device)
    ys = np.linspace(0, 1, size)[:, None]
    alpha = (ys < ridge[None, :]).astype(np.float32)
    rgb = np.full((size, size, 3), 0.35, np.float32)
    return np.concatenate([rgb, alpha[..., None]], -1)


def _cloud_texture(size: int, seed: int, device: str | torch.device = "cuda") -> np.ndarray:
    ys, xs = np.mgrid[0:size, 0:size] / size
    pts = np.stack([(xs * 3 + seed * 11.7).astype(np.float32),
                    (ys * 3).astype(np.float32)], -1)
    n = _noise01(pts, device) * 0.6 + _noise01(pts * np.float32(2.7), device) * 0.4
    r = np.hypot(xs - 0.5, ys - 0.5) * 2
    alpha = np.clip(n - 0.35, 0, 1) * np.clip(1.2 - r, 0, 1)
    rgb = np.ones((size, size, 3), np.float32)
    return np.concatenate([rgb, alpha[..., None].astype(np.float32)], -1)


def _star_backdrop(h: int, w: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 2] = 0.015  # faint night blue
    n_stars = (h * w) // 300
    ys = rng.integers(0, h, n_stars)
    xs = rng.integers(0, w, n_stars)
    img[ys, xs] = rng.uniform(0.2, 1.0, (n_stars, 1)) * np.array([0.9, 0.9, 1.0])
    return img


def build_demo_scene(w: int, t: float = 0.0, device: str | torch.device = "cuda"):
    """Scene at animation time t (seconds): UFO drifts, beam sweeps."""
    ufo_x = w * (0.5 + 0.25 * math.sin(t * 0.4))
    ufo_y = w * 0.72
    beam_angle = 0.25 * math.sin(t * 0.9)

    b = SceneBuilder(texture_size=256)
    # Night haze + moon.
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-2.6)
    b.add_point_light((w * 0.82, w * 0.86), radius=w * 0.035,
                      color=(0.75, 0.8, 1.0), intensity=0.9, bounces=2)
    # Hills: two parallax silhouette layers (dense substrates).
    b.add_sprite((w / 2, w * 0.16), (w / 2, w * 0.16), color=(0.25, 0.3, 0.2, 1),
                 log_density=-0.15, texture=_hills_texture(256, 1, 0.55, 0.35, device))
    b.add_sprite((w / 2, w * 0.10), (w / 2, w * 0.10), color=(0.15, 0.18, 0.12, 1),
                 log_density=0.0, texture=_hills_texture(256, 2, 0.5, 0.45, device))
    # Cloud bank.
    b.add_sprite((w * 0.35, w * 0.55), (w * 0.3, w * 0.12),
                 color=(1, 1, 1, 1), log_density=-1.0, texture=_cloud_texture(256, 1, device))
    b.add_sprite((w * 0.7, w * 0.62), (w * 0.25, w * 0.1),
                 color=(1, 1, 1, 1), log_density=-1.1, texture=_cloud_texture(256, 2, device))
    # UFO: glowing body + abduction beam.
    b.add_point_light((ufo_x, ufo_y), radius=w * 0.02,
                      color=(0.6, 1.0, 0.7), intensity=1.3, bounces=2)
    b.add_spot_light((ufo_x, ufo_y - w * 0.02), (w * 0.04, w * 0.01),
                     rotation=beam_angle, color=(0.7, 1.0, 0.6), intensity=2.2,
                     bounces=2)
    return b.build(max_lights=4, max_shapes=8, device=device)


def render_frame(sim: Simulation, backdrop, exposure: float = -1.0,
                 cloud_depth: float = 1.5) -> np.ndarray:
    """Composite one frame: sim HDR over the backdrop (an array, or a tensor
    on the simulation's device) + relit foreground. The frame is made where
    the simulation runs and copied to the host once, tone mapped."""
    hdr = sim.simulation_output_hdr * (10.0 ** exposure)
    comp = composite_additive(torch.as_tensor(backdrop, device=hdr.device), hdr)

    # Foreground cloud relight (CloudGroupController analog).
    trans = sim.gbuffer.transmissibility
    blurred = relight_layer(hdr, trans, cloud_depth, sigma=3.0)
    fg_alpha = torch.clamp((1.0 - trans) * 2.0 - 0.4, 0.0, 0.35)
    fg = shade_foreground(
        torch.cat([torch.ones_like(hdr), fg_alpha[..., None]], -1),
        blurred, trans)
    comp = composite_premultiplied(comp, fg)

    return tonemap_uchimura(comp).cpu().numpy()


def build_game_scene(w: int, params: dict, device: str | torch.device = "cuda"):
    """Scene from live gameplay state (demo/game.py AbductionGame
    .scene_params()): the UFO pose/beam drive the lights, captured targets
    glow, parallax offsets shift the hill layers."""
    cam_x, _ = params["camera"]
    ux, uy, uang = params["ufo"]
    # world -> screen: camera x maps to frame center; world unit = w/20 px
    scale = w / 20.0
    sx = lambda x: (x - cam_x) * scale + w / 2
    sy = lambda y: y * scale + w * 0.25

    b = SceneBuilder(texture_size=256)
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-2.6)
    # Parallax hill layers.
    for k, (px, _py) in enumerate(params["parallax"][:2]):
        b.add_sprite((sx(px), w * (0.16 - 0.06 * k)), (w / 2, w * (0.16 - 0.06 * k)),
                     color=(0.25 - 0.1 * k, 0.3 - 0.12 * k, 0.2 - 0.08 * k, 1),
                     log_density=-0.15 + 0.15 * k,
                     texture=_hills_texture(256, k + 1, 0.55 - 0.05 * k, 0.35, device))
    # UFO body light (+ tilt-following beam when tractoring); the saucer
    # hull is a dense ellipse just above the lamp, rim-lit from below.
    b.add_point_light((sx(ux), sy(uy)), radius=w * 0.02,
                      color=(0.6, 1.0, 0.7), intensity=1.3, bounces=2)
    b.add_ellipse((sx(ux), sy(uy) + w * 0.028), (w * 0.045, w * 0.012),
                  rotation=math.radians(uang), color=(0.5, 0.55, 0.5, 1.0),
                  log_density=0.0)
    if params["beam_on"]:
        b.add_spot_light((sx(ux), sy(uy) - w * 0.02), (w * 0.04, w * 0.01),
                         rotation=math.radians(uang), color=(0.7, 1.0, 0.6),
                         intensity=2.2, bounces=2)
    # Targets: visible bodies on the ground / rising in the beam; captured
    # ones glow as they rise.
    for tx, ty, captured in params["targets"][:2]:
        b.add_ellipse((sx(tx), sy(ty) + w * 0.008), (w * 0.012, w * 0.01),
                      color=(1.0, 0.75, 0.55, 1.0), log_density=-0.2)
        if captured:
            b.add_point_light((sx(tx), sy(ty)), radius=w * 0.012,
                              color=(1.0, 0.9, 0.5), intensity=1.4, bounces=1)
    return b.build(max_lights=6, max_shapes=8, device=device)


def play_sequence(out_dir: str, inputs=None, width: int = 128,
                  rays: int = 8192, sim_frames: int = 2,
                  dt: float = 0.25, device: str | torch.device = "cuda") -> dict:
    """Run the headless game on a scripted input stream and render each
    step through the full sim pipeline. Returns the final scene_params
    (score/state) plus the frame paths."""
    if inputs is None:  # canonical demo script: fly right, beam, fly left
        inputs = ([GameInput(move_x=1.0)] * 6
                  + [GameInput(tractor=True)] * 8
                  + [GameInput(move_x=-0.6, tractor=True)] * 6)
    os.makedirs(out_dir, exist_ok=True)
    game = AbductionGame()
    backdrop = torch.from_numpy(_star_backdrop(width, width)).to(device)
    sim = Simulation(width=width, height=width, mode=Mode.REFERENCE,
                     rays_per_frame=rays, measurement_interval=0, device=device)
    paths = []
    for i, inp in enumerate(inputs):
        game.step(dt, inp)
        params = game.scene_params()
        sim.set_scene(build_game_scene(width, params, device))
        sim.frame_limit = sim_frames
        sim.run(max_frames=sim_frames)
        path = os.path.join(out_dir, f"play_{i:03d}.png")
        write_png(path, np.flipud(render_frame(sim, backdrop)), srgb_encode=False)
        paths.append(path)
    out = game.scene_params()
    out["frames"] = paths
    return out


def render_sequence(out_dir: str, n_frames: int = 8, width: int = 128,
                    rays: int = 16384, sim_frames: int = 3,
                    device: str | torch.device = "cuda") -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    backdrop = torch.from_numpy(_star_backdrop(width, width)).to(device)
    sim = Simulation(width=width, height=width, mode=Mode.REFERENCE,
                     rays_per_frame=rays, measurement_interval=0, device=device)
    paths = []
    for i in range(n_frames):
        t = i * 0.5
        sim.set_scene(build_demo_scene(width, t, device))
        sim.frame_limit = sim_frames
        sim.run(max_frames=sim_frames)
        img = render_frame(sim, backdrop)
        path = os.path.join(out_dir, f"frame_{i:03d}.png")
        write_png(path, np.flipud(img), srgb_encode=False)
        paths.append(path)
    return paths
