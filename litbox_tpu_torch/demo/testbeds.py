"""Testbed scenes (counterpart of the JAX package's demo/testbeds.py;
reference: Assets/Scenes/{Basic, Blank_Testbed, ImportanceSampling_Testbed,
Normal_Testbed, Procedural_Testbed}.unity).

The reference's manual integration harnesses, reproduced as scene builders
so each feature has a canned scene to eyeball and regression-test against.
Each builder makes its scene on `device` ("cuda" unless the caller asks for
the CPU).
"""

from __future__ import annotations

import torch

from ..data.substrate import generate_random
from ..scene import SceneBuilder


def blank_testbed(w: int = 256, device: str | torch.device = "cuda"):
    """Empty-frame baseline: single point light in a thin haze."""
    b = SceneBuilder()
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-2.5)
    b.add_point_light((w / 2, w / 2), radius=w * 0.02, intensity=1.5, bounces=2)
    return b.build(device=device)


def basic(w: int = 256, device: str | torch.device = "cuda"):
    """A point light, a colored medium blob, and a solid blocker."""
    b = SceneBuilder()
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-2.2)
    b.add_point_light((w * 0.3, w * 0.6), radius=w * 0.02,
                      color=(1, 0.9, 0.7), intensity=2.0, bounces=2)
    b.add_ellipse((w * 0.65, w * 0.5), (w * 0.18, w * 0.12), rotation=0.4,
                  color=(0.6, 0.7, 1, 1), log_density=-1.0)
    b.add_rect((w * 0.5, w * 0.3), (w * 0.12, w * 0.03), rotation=0.2,
               color=(0.8, 0.3, 0.3, 1), log_density=0.0)
    return b.build(device=device)


def importance_sampling_testbed(w: int = 256, device: str | torch.device = "cuda"):
    """Hybrid-strategy stress: small bright light far from a dense target."""
    b = SceneBuilder()
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-2.0)
    b.add_point_light((w * 0.1, w * 0.9), radius=w * 0.01, intensity=2.5, bounces=3)
    b.add_ellipse((w * 0.75, w * 0.25), (w * 0.15, w * 0.15),
                  color=(1, 1, 1, 1), log_density=-0.7)
    return b.build(device=device)


def normal_testbed(w: int = 256, device: str | torch.device = "cuda"):
    """BRDF/normal-field features: mirror, rough, and diffuse boundaries."""
    b = SceneBuilder()
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-1.8)
    b.add_point_light((w * 0.5, w * 0.75), radius=w * 0.02, intensity=2.0, bounces=3)
    b.add_rect((w * 0.25, w * 0.35), (w * 0.1, w * 0.04), rotation=0.5,
               color=(1, 1, 1, 1), log_density=-0.1, alignment=1.0)    # mirror
    b.add_rect((w * 0.55, w * 0.3), (w * 0.1, w * 0.04), rotation=-0.4,
               color=(1, 1, 1, 1), log_density=-0.1, alignment=0.6)    # rough
    b.add_ellipse((w * 0.82, w * 0.4), (w * 0.07, w * 0.07),
                  color=(1, 1, 1, 1), log_density=-0.1, alignment=0.0)  # diffuse
    return b.build(device=device)


def procedural_testbed(w: int = 256, seed: int = 7,
                       device: str | torch.device = "cuda"):
    """Substrate-generator coverage: three random substrates + two lights."""
    b = SceneBuilder(texture_size=256)
    b.add_rect((w / 2, w / 2), (w, w), color=(1, 1, 1, 1), log_density=-3.0)
    for i in range(3):
        _, tex = generate_random(seed + i, version=2, texture_size=256, device=device)
        b.add_sprite((w / 2, w / 2), (w / 2, w / 2), color=(1, 1, 1, 1),
                     log_density=0.0, texture=tex.cpu().numpy())
    b.add_point_light((w * 0.3, w * 0.7), radius=w * 0.02,
                      color=(1, 0.8, 0.6), intensity=1.8, bounces=3)
    b.add_spot_light((w * 0.8, w * 0.85), (w * 0.05, w * 0.01), rotation=2.4,
                     color=(0.7, 0.8, 1), intensity=1.5, bounces=3)
    return b.build(device=device)


ALL_TESTBEDS = {
    "blank": blank_testbed,
    "basic": basic,
    "importance_sampling": importance_sampling_testbed,
    "normal": normal_testbed,
    "procedural": procedural_testbed,
}
