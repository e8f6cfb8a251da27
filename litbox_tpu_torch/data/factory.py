"""Self-hosted dataset factory (counterpart of the JAX package's
data/factory.py; reference: Assets/Scripts/TrainingManager.cs).

Generates N scenes x (noisy input profiles + converged reference):
  * random scene descriptions (1-3 lights with weighted types, ambient
    light, background density, 1-3 substrate seeds) serialized to
    Scene_#####.json with the reference's field names
    (GenerateRandomSceneDescription, TrainingManager.cs:330-399)
  * per-profile simulation runs writing Input{k}_Radiance_A/B_#####.exr
    (both tracers!), Output_Reference/Output_Preview, Albedo_#####.png and
    Transmissibility_#####.exr (WriteResultsAndAdvanceTrainingState :252-300)
  * resume-by-file-existence (:147-150)
  * slow-scene discard when the estimated convergence time exceeds the
    budget (:302-328) — here measured per-frame instead of wall-clock so
    results are hardware-independent.

Default profiles mirror Assets/Scenes/Training.unity:1046-1071.

The descriptions are drawn with numpy exactly as the JAX package draws
them, so one rng gives the same JSON in both packages. The simulation runs
on the factory's `device` ("cuda" unless the caller asks for the CPU); each
file write takes one host copy of its tensor.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from ..core.types import SimulationProfile
from ..engine.simulation import Mode, Simulation
from ..io.exr import write_exr, write_exr_rgb
from ..io.images import write_png
from ..post.tonemap import tonemap_ue5
from ..scene.scene import SceneBuilder
from .substrate import generate_random

DEFAULT_INPUT_PROFILES = (
    SimulationProfile(5, 8192, 0.1, 4),
    SimulationProfile(1, 65536, 0.1, 4),
    SimulationProfile(1, 262144, 0.1, 4),
    SimulationProfile(4, 262144, 0.1, 4),
    SimulationProfile(1, 32768, 0.02, 4),
)
DEFAULT_CONVERGENCE_PROFILE = SimulationProfile(-1, 32768, 0.01, 4)

# The reference weights Directional 0.0 ("Disabled because it has bugs",
# TrainingManager.cs:343) but its demo scenes use directional lights. Our
# exact-direction collimated wave-0 (rbt.collimated_direct_raw) has no such
# bugs, so the type is enabled at a small weight to cover the demo regime.
LIGHT_TYPE_WEIGHTS = {"Directional": 0.05, "Point": 0.25, "Spot": 0.25, "Laser": 0.1}


def _next_range(rng, lo, hi, bias=0.0):
    return float(rng.random() ** (10.0 ** -bias) * (hi - lo) + lo)


def _light_color(rng):
    import colorsys

    return colorsys.hsv_to_rgb(rng.random(), math.sqrt(rng.random()), 1.0)


def _weighted_option(rng, weights: dict) -> str:
    total = sum(weights.values())
    val = rng.random() * total
    for k, w in weights.items():
        if val <= w:
            return k
        val -= w
    return list(weights)[-1]


def generate_random_scene_description(rng: np.random.Generator) -> dict:
    """JsonSceneData-compatible dict (TrainingManager.cs:330-399)."""
    lights = []
    for _ in range(int(rng.integers(0, 3)) + 1):
        ltype = _weighted_option(rng, LIGHT_TYPE_WEIGHTS)
        light = {
            "type": ltype,
            "color": list(_light_color(rng)),
            "intensity": _next_range(rng, 0.01, 3, -0.3),
            "position": [0.0, 0.0],
            "angle": 0.0,
            "scale": [1.0, 1.0],
        }
        if ltype == "Directional":
            light["angle"] = _next_range(rng, 0, 360)
        elif ltype == "Point":
            light["position"] = [_next_range(rng, -5, 5), _next_range(rng, -5, 5)]
            size = _next_range(rng, 0.4, 5, 0.1)
            light["scale"] = [size, size]
        elif ltype == "Spot":
            pos = [_next_range(rng, -7, 7), _next_range(rng, -7, 7)]
            light["position"] = pos
            mag = math.hypot(*pos) or 1.0
            base = math.degrees(math.acos(max(-1.0, min(1.0, pos[0] / mag))))
            if pos[1] < 0:
                base *= -1
            base += 270
            light["angle"] = base + _next_range(rng, -80, 80)
            # The reference leaves scale.y at Vector2 default 0 (a line
            # emitter) — replicated for output parity (TrainingManager.cs:371).
            light["scale"] = [_next_range(rng, 0.03, 0.5, 0.3), 0.0]
        elif ltype == "Laser":
            light["position"] = [_next_range(rng, -3, 3), _next_range(rng, -3, 3)]
            light["angle"] = _next_range(rng, 0, 360)
            light["scale"] = [_next_range(rng, 0.01, 0.2, 0.1), 1.0]
        lights.append(light)

    seeds = [int(rng.integers(0, 2**31))]
    if rng.random() < 0.5:
        seeds.append(int(rng.integers(0, 2**31)))
        if rng.random() < 0.5:
            seeds.append(int(rng.integers(0, 2**31)))

    return {
        "ambientLightColor": list(_light_color(rng)),
        "ambientLightIntensity": _next_range(rng, 0, 0.5, -0.5),
        "backgroundColor": [1.0, 1.0, 1.0],
        "backgroundDensity": _next_range(rng, -5, -2),
        "substrateSeedsV2": seeds,
        "lights": lights,
    }


def build_scene_from_description(desc: dict, width: int, height: int,
                                 frame_extent: float = 16.0,
                                 substrate_texture_size: int = 512,
                                 device: str | torch.device = "cuda"):
    """Instantiate a Scene on `device` from a JsonSceneData dict
    (LoadSceneFromDescription, TrainingManager.cs:405-488). The substrates
    are generated on `device` and handed to the SceneBuilder as host arrays.

    World units map to texels with the frame spanning `frame_extent` world
    units; returns (scene, exposure) where exposure = -log10(sum I^2)
    (auto-exposure, :480-487).
    """
    u2t = width / frame_extent  # world units -> texels

    def to_texels(p):
        return ((p[0] / frame_extent + 0.5) * width,
                (p[1] / frame_extent + 0.5) * height)

    b = SceneBuilder(texture_size=substrate_texture_size)

    # Background substrate + ambient light (:419-422).
    b.add_sprite((width / 2, height / 2), (width / 2, height / 2),
                 color=list(desc.get("backgroundColor", [1, 1, 1]))[:3] + [1.0],
                 log_density=desc["backgroundDensity"])

    version = 2 if desc.get("substrateSeedsV2") else 1
    seeds = desc.get("substrateSeedsV2") or desc.get("substrateSeeds") or []
    # Substrates A/B/C are frame-filling sprites (Training scene layout).
    for seed in seeds[:3]:
        _, tex = generate_random(int(seed), version, substrate_texture_size, device)
        b.add_sprite((width / 2, height / 2), (width / 2, height / 2),
                     color=(1, 1, 1, 1), log_density=0.0, texture=tex.cpu().numpy())

    if desc.get("ambientLightIntensity", 0) > 0:
        b.add_ambient_light(color=desc["ambientLightColor"][:3],
                            intensity=desc["ambientLightIntensity"], bounces=10)

    for light in desc["lights"]:
        pos = to_texels(light["position"])
        rot = math.radians(light["angle"])
        sx, sy = light["scale"][0] * u2t, light["scale"][1] * u2t
        color = light["color"][:3]
        inten = light["intensity"]
        if light["type"] == "Point":
            b.add_point_light(pos, radius=sx / 2, color=color, intensity=inten, bounces=10)
        elif light["type"] == "Spot":
            b.add_spot_light(pos, (sx, max(sy, 1e-3)), rot, color=color,
                             intensity=inten, bounces=10)
        elif light["type"] == "Laser":
            b.add_laser_light(pos, (sx, max(sy, 1e-3)), rot, color=color,
                              intensity=inten, bounces=10)
        elif light["type"] == "Directional":
            b.add_directional_light(rot, color=color, intensity=inten, bounces=10)

    luminosity = sum(l["intensity"] ** 2 for l in desc["lights"])
    exposure = -math.log10(max(luminosity, 1e-6))
    scene = b.build(max_lights=8, max_shapes=8, device=device)
    return scene, exposure


@dataclasses.dataclass
class TrainingFactory:
    """Dataset generation driver (reference: TrainingManager state machine)."""

    output_folder: str
    samples_to_generate: int = 10
    width: int = 256
    height: int = 256
    input_profiles: tuple = DEFAULT_INPUT_PROFILES
    convergence_profile: SimulationProfile = DEFAULT_CONVERGENCE_PROFILE
    convergence_threshold: float = 1e-4
    max_convergence_frames: int = 20000   # frame-budget analog of the 300 s cap
    continue_previous_session: bool = False
    seed: int | None = None
    substrate_texture_size: int = 512
    preview_exposure_offset: float = 0.0
    # Denoiser inputs must actually BE noisy: trace direct light with Monte
    # Carlo for the input profiles (the reference's inputs carry MC direct
    # noise; with analytic direct they measure ~74 dB PSNR vs the converged
    # reference and there is nothing for the denoiser to learn).
    mc_direct_inputs: bool = True
    # Dither the RBT angular bins per frame so converged references carry no
    # D-spoke quantization artifacts (sim/rbt.py phase).
    jitter_bins: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.continue_previous_session:
            sessions = sorted(
                (d for d in os.listdir(self.output_folder)
                 if os.path.isdir(os.path.join(self.output_folder, d))), reverse=True)
            if not sessions:
                raise RuntimeError("No previous session to update!")
            self.dataset_path = os.path.join(self.output_folder, sessions[0])
        else:
            name = time.strftime("%Y-%m-%d-%H-%M-%S")
            self.dataset_path = os.path.join(self.output_folder, name)
            os.makedirs(self.dataset_path, exist_ok=True)
        self._rng = np.random.default_rng(self.seed)

    def _path(self, fmt: str, sample_id: int) -> str:
        return os.path.join(self.dataset_path, fmt.format(sample_id))

    def _scene_description(self, sample_id: int) -> dict:
        path = self._path("Scene_{0:05d}.json", sample_id)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        desc = generate_random_scene_description(self._rng)
        with open(path, "w") as f:
            json.dump(desc, f, indent=2)
        return desc

    def _discard_scene(self, sample_id: int):
        for f in os.listdir(self.dataset_path):
            if f.endswith(f"_{sample_id:05d}.json") or f.endswith(f"_{sample_id:05d}.exr") \
                    or f.endswith(f"_{sample_id:05d}.png"):
                os.remove(os.path.join(self.dataset_path, f))
        # Persist the discard so session resumes skip the id instead of
        # re-simulating a deterministically non-converging scene (the
        # reference's resume-by-existence can't distinguish "never tried"
        # from "tried and discarded" either — TrainingManager.cs:147-150 —
        # but its scenes are cheap; ours cost minutes).
        discarded = self._discarded_ids()
        discarded.add(sample_id)
        with open(os.path.join(self.dataset_path, "discarded.json"), "w") as f:
            json.dump(sorted(discarded), f)

    def _discarded_ids(self) -> set:
        path = os.path.join(self.dataset_path, "discarded.json")
        if os.path.exists(path):
            with open(path) as f:
                return set(json.load(f))
        return set()

    def generate(self, max_samples: int | None = None, log=print):
        """Generate (or resume) the dataset; returns generated sample ids."""
        generated = []
        n = min(self.samples_to_generate,
                max_samples or self.samples_to_generate)
        skip = self._discarded_ids()
        for sample_id in range(n):
            if sample_id in skip:
                continue
            desc = self._scene_description(sample_id)
            scene, exposure = build_scene_from_description(
                desc, self.width, self.height,
                substrate_texture_size=self.substrate_texture_size, device=self.device)

            sim = Simulation(width=self.width, height=self.height,
                             mode=Mode.REFERENCE, seed=sample_id, device=self.device)
            sim.set_scene(scene)
            sim._validate_tracers()

            def _configure(analytic_direct: bool, rays: int):
                for t in sim._tracers:
                    fwd = t.forward
                    if hasattr(fwd, "analytic_direct"):
                        fwd.analytic_direct = analytic_direct
                        fwd.jitter_bins = self.jitter_bins
                        # Russian-roulette 4x bounce cull: bounce light is
                        # low-frequency, and the bounce waves are 3/4 of the
                        # per-frame photon work at 4 bounces (rbt.py).
                        fwd.bounce_rays = rays // 4

            albedo_path = self._path("Albedo_{0:05d}.png", sample_id)
            trans_path = self._path("Transmissibility_{0:05d}.exr", sample_id)

            discarded = False
            for k, profile in enumerate(self.input_profiles):
                a_path = self._path(f"Input{k}_Radiance_A_{{0:05d}}.exr", sample_id)
                b_path = self._path(f"Input{k}_Radiance_B_{{0:05d}}.exr", sample_id)
                if os.path.exists(a_path) and os.path.exists(b_path):
                    continue
                _configure(analytic_direct=not self.mc_direct_inputs,
                           rays=profile.rays_per_frame)
                sim.load_profile(profile)
                sim.invalidate()
                sim.run(max_frames=max(profile.frame_limit, 1))
                write_exr_rgb(a_path, sim.tracer_a.tracer_output.cpu().numpy())
                write_exr_rgb(b_path, sim.tracer_b.tracer_output.cpu().numpy())

            ref_path = self._path("Output_Reference_{0:05d}.exr", sample_id)
            preview_path = self._path("Output_Preview_{0:05d}.png", sample_id)
            if not (os.path.exists(ref_path) and os.path.exists(preview_path)):
                profile = dataclasses.replace(
                    self.convergence_profile, frame_limit=-1)
                _configure(analytic_direct=True, rays=profile.rays_per_frame)
                sim.load_profile(profile)
                sim.invalidate()
                sim.convergence_threshold = self.convergence_threshold
                sim.measurement_interval = 100
                frames = 0
                while sim.is_running and frames < self.max_convergence_frames:
                    sim.step()
                    frames += 1
                if not sim.has_converged:
                    log(f"Discarding scene {sample_id:05d}: no convergence "
                        f"within {self.max_convergence_frames} frames "
                        f"(xi={sim.convergence_progress:.2e})")
                    self._discard_scene(sample_id)
                    discarded = True
                else:
                    hdr = sim.simulation_output_hdr
                    write_exr_rgb(ref_path, hdr.cpu().numpy())
                    preview = tonemap_ue5(
                        hdr * 10.0 ** (exposure + self.preview_exposure_offset)).cpu().numpy()
                    write_png(preview_path, preview, srgb_encode=False)

            if not discarded:
                if not os.path.exists(albedo_path):
                    write_png(albedo_path, sim.gbuffer.albedo[..., :3].cpu().numpy())
                if not os.path.exists(trans_path):
                    t = sim.gbuffer.transmissibility.cpu().numpy()
                    write_exr(trans_path, {"R": t, "G": t, "B": np.zeros_like(t)})
                generated.append(sample_id)
                log(f"Completed Scene {sample_id:05d}")
        return generated
