"""Camera binding: size the simulation from a display camera (a copy of the
JAX package's engine/camera.py, which imports no JAX).

Reference: Assets/Scripts/BindSimulationToCamera.cs — the sim target is the
camera's pixel size times a resolution scale (default 1/4) plus padding, and
a screen->simulation UV transform feeds the compositor/cloud shaders.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraBinding:
    pixel_width: int
    pixel_height: int
    resolution_scale: float = 0.25     # BindSimulationToCamera.cs:6
    padding_percent: float = 0.0

    @property
    def padding(self) -> float:
        return self.padding_percent / 100.0

    @property
    def sim_size(self) -> tuple[int, int]:
        """(width, height) of the simulation target (.cs:33-35)."""
        w = int((self.pixel_width + 2 * self.pixel_height * self.padding)
                * self.resolution_scale)
        h = int((self.pixel_height + 2 * self.pixel_height * self.padding)
                * self.resolution_scale)
        return max(w, 1), max(h, 1)

    @property
    def screen_to_sim_uv(self) -> np.ndarray:
        """3x3 homogeneous transform of screen UV -> simulation UV
        (Translate(0.5,-0.5) @ Scale(0.5/xPad, -0.5/yPad), .cs:42-45)."""
        x_pad = 1.0 + 2 * self.padding * self.pixel_height / self.pixel_width
        y_pad = 1.0 + 2 * self.padding
        m = np.array([
            [0.5 / x_pad, 0.0, 0.5],
            [0.0, -0.5 / y_pad, -0.5],
            [0.0, 0.0, 1.0],
        ], dtype=np.float32)
        return m

    def apply(self, sim) -> None:
        """Push the bound size onto a Simulation (reference Update loop)."""
        w, h = self.sim_size
        if (sim.width, sim.height) != (w, h):
            sim.width, sim.height = w, h
            sim.invalidate()
