"""Headless "Abduction" gameplay layer (a copy of the JAX package's
demo/game.py, which imports no JAX; reference: Assets/Demo_Abduction/Scripts).

The reference ships a playable Unity game on top of the engine; this module
reproduces its *game logic* as a deterministic, headless state machine so the
demo is interactive (scripted or driven by a caller-provided input stream),
not just a rendered flythrough (demo/abduction.py covers the render side).

Components and their reference counterparts:

  GameStateController — title/playing/paused FSM with an explicit transition
      table and state-change events (GameStateController.cs:13-87).
  UfoController — intent-based hover physics: velocity approaches
      intent*max_speed under clamped acceleration, tilt torque proportional
      to -vx with a quadratic upright return spring (UfoController2.cs:55-90).
  CameraController — roam-window follow: the camera moves only when the
      target leaves the inner wiggle-room window, with damping, accel/velocity
      clamps, hard edge containment, and a ground floor
      (CameraController.cs:20-128).
  Parallax — layers track camera motion scaled by (1 - rate) (Parallax.cs).
  PlatformCycler — children wrap around the camera by the platform width
      (PlatformCycler.cs).
  StarField — infinite deterministic star blocks allocated/recycled around
      the camera; per-block seeded placement (StarController.cs:33-118).
  WaterAnimation — scrolling texture offsets on two water layers
      (WaterAnimation.cs).
  PassiveRotator — constant-rate rotation (PassiveRotator.cs).
  TractorBeam / Abductee — the abduction mechanic the reference's input map
      sketches (UfoController2.OnTractor): targets inside the beam cone are
      lifted toward the UFO and scored on contact.

All units are world units (1 unit = 1 texel at scale 1); y is up.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field


class GameStates(enum.Enum):
    TITLE = "title"
    PLAYING = "playing"
    PAUSED = "paused"


class GameStateController:
    """Explicit-transition FSM (GameStateController.cs:83-87 raises on
    invalid transitions; so do we)."""

    _VALID = {
        (GameStates.TITLE, GameStates.PLAYING),
        (GameStates.PLAYING, GameStates.PAUSED),
        (GameStates.PAUSED, GameStates.PLAYING),
        (GameStates.PAUSED, GameStates.TITLE),
    }

    def __init__(self):
        self.state = GameStates.TITLE
        self.state_changed: list = []  # callbacks (old, new)

    def transition(self, new_state: GameStates):
        if (self.state, new_state) not in self._VALID:
            raise ValueError(f"Invalid transition from {self.state} to {new_state}")
        old, self.state = self.state, new_state
        for cb in self.state_changed:
            cb(old, new_state)


@dataclass
class GameInput:
    """One frame of player intent (the reference's input actions:
    Move/Thrust2/Tractor, UfoController2.cs:92-125)."""

    move_x: float = 0.0   # [-1, 1]
    move_y: float = 0.0   # [-1, 1]
    tractor: bool = False
    pause: bool = False


@dataclass
class UfoController:
    """Intent-based hover physics (UfoController2.cs:55-90). No gravity;
    the body drifts to intent*max_speed under per-step clamped accel, and
    tilt follows -vx with a quadratic upright spring."""

    max_speed: float = 5.0
    horizontal_acceleration: float = 10.0
    vertical_acceleration: float = 10.0
    max_altitude: float = 20.0
    max_tilt_angle: float = 15.0
    return_force: float = 1.0
    x: float = 0.0
    y: float = 5.0
    vx: float = 0.0
    vy: float = 0.0
    angle: float = 0.0       # degrees
    angular_velocity: float = 0.0

    def fixed_update(self, intent_x: float, intent_y: float, dt: float):
        # velocity approaches intent * max_speed, accel clamped per step
        dvx = intent_x * self.max_speed - self.vx
        dvy = intent_y * self.max_speed - self.vy
        self.vx += math.copysign(min(self.horizontal_acceleration * dt, abs(dvx)), dvx)
        self.vy += math.copysign(min(self.vertical_acceleration * dt, abs(dvy)), dvy)
        self.x += self.vx * dt
        self.y = min(self.y + self.vy * dt, self.max_altitude)

        # tilt: desired torque from horizontal velocity, quadratic return.
        # (The reference's `angle = 180 - angle` wrap branch is a bug that
        # rarely triggers there — Rigidbody2D.rotation is unwrapped; with a
        # wrapped angle the correct signed form is required.)
        a = (self.angle + 180.0) % 360.0 - 180.0
        return_torque = -math.copysign(abs(a) ** 2 * self.return_force, a)
        desired_torque = self.max_tilt_angle * -self.vx
        self.angular_velocity += (desired_torque + return_torque) * dt
        self.angular_velocity *= 0.9  # rigidbody angular drag analog
        self.angle = (self.angle + self.angular_velocity * dt) % 360.0


@dataclass
class CameraController:
    """Roam-window smooth follow (CameraController.cs:20-128)."""

    ortho_size: float = 10.0
    aspect: float = 16 / 9
    wiggle_room: float = 0.5
    vertical_sweet_spot: float = 0.6
    vertical_wiggle_room: float = 0.1
    ground_y: float = -4.0
    damping: float = 0.8
    max_velocity: float = 5.0
    max_acceleration: float = 50.0
    x: float = 0.0
    y: float = 0.0
    _vel_x: float = 0.0
    _vel_y: float = 0.0

    def _axis(self, vel: float, ideal_v: float, dt: float) -> float:
        if math.isnan(ideal_v):
            return vel
        if ideal_v * vel < 0:
            vel = 0.0
        sign = math.copysign(1.0, ideal_v)
        mag = min(self.max_velocity,
                  max(abs(vel), min(sign * vel + self.max_acceleration * dt,
                                    abs(ideal_v) - sign * vel)))
        return sign * mag

    def update(self, follow_x: float, follow_y: float, dt: float,
               follow_half_extent: float = 0.5):
        half_w = self.ortho_size * self.aspect
        left_roam = self.x - self.wiggle_room * half_w
        right_roam = self.x + self.wiggle_room * half_w
        bottom_edge = self.y - self.ortho_size
        top_edge = self.y + self.ortho_size
        focal = self.vertical_sweet_spot * (top_edge - bottom_edge) + bottom_edge
        bottom_roam = focal - self.vertical_wiggle_room * self.ortho_size
        top_roam = focal + self.vertical_wiggle_room * self.ortho_size

        ideal_x = ideal_y = float("nan")
        required_dx = required_dy = float("nan")
        if follow_x < left_roam:
            if follow_x - follow_half_extent < self.x - half_w:
                required_dx = follow_x - follow_half_extent - (self.x - half_w)
            ideal_x = self.x - (left_roam - follow_x)
        elif follow_x > right_roam:
            if follow_x + follow_half_extent > self.x + half_w:
                required_dx = follow_x + follow_half_extent - (self.x + half_w)
            ideal_x = self.x + (follow_x - right_roam)
        if follow_y < bottom_roam:
            if follow_y - follow_half_extent < bottom_edge:
                required_dy = follow_y - follow_half_extent - bottom_edge
            ideal_y = self.y - (bottom_roam - follow_y)
        elif follow_y > top_roam:
            if follow_y + follow_half_extent > top_edge:
                required_dy = follow_y + follow_half_extent - top_edge
            ideal_y = self.y + (follow_y - top_roam)

        ground_based = self.ground_y + self.ortho_size
        if self.y < ground_based:
            ideal_y = ground_based

        frame_damp = (1.0 - self.damping) ** dt
        self._vel_x *= frame_damp
        self._vel_y *= frame_damp
        if not math.isnan(ideal_x):
            self._vel_x = self._axis(self._vel_x, (ideal_x - self.x) / dt, dt)
        if not math.isnan(ideal_y):
            self._vel_y = self._axis(self._vel_y, (ideal_y - self.y) / dt, dt)

        self.x += self._vel_x * dt
        self.y += self._vel_y * dt
        if not math.isnan(required_dx):
            self.x += required_dx - self._vel_x * dt
        if not math.isnan(required_dy):
            self.y += required_dy - self._vel_y * dt


@dataclass
class Parallax:
    """Layer follows camera deltas scaled by (1 - rate) (Parallax.cs)."""

    rate_x: float = 0.0
    rate_y: float = 0.0
    x: float = 0.0
    y: float = 0.0
    _prev_cam: tuple = (0.0, 0.0)

    def late_update(self, cam_x: float, cam_y: float):
        self.x += (cam_x - self._prev_cam[0]) * (1.0 - self.rate_x)
        self.y += (cam_y - self._prev_cam[1]) * (1.0 - self.rate_y)
        self._prev_cam = (cam_x, cam_y)


class PlatformCycler:
    """Wrap child positions around the camera by the platform width
    (PlatformCycler.cs)."""

    def __init__(self, width: float, child_xs: list):
        self.width = width
        self.child_xs = list(child_xs)

    def update(self, cam_x: float):
        left = cam_x - self.width / 2.0
        right = cam_x + self.width / 2.0
        for i, x in enumerate(self.child_xs):
            while x < left:
                x += self.width
            while x > right:
                x -= self.width
            self.child_xs[i] = x


@dataclass
class PassiveRotator:
    rate: float = 30.0
    angle: float = 0.0

    def update(self, dt: float):
        self.angle = (self.angle + self.rate * dt) % 360.0


@dataclass
class WaterAnimation:
    """Two scrolling texture offsets (WaterAnimation.cs)."""

    rate1: float = 0.05
    rate2: float = -0.03
    offset1: float = 0.0
    offset2: float = 0.0

    def update(self, dt: float):
        self.offset1 += self.rate1 * dt
        self.offset2 += self.rate2 * dt


class StarField:
    """Infinite deterministic star blocks around the camera
    (StarController.cs:33-118): blocks twice the view extent are kept
    allocated; freed blocks recycle their instance slots; placement is
    seeded per block (x + y*107) so revisited blocks are identical."""

    BLOCK_SIZE = 10.0

    def __init__(self, star_density: int = 200, percent_bright: float = 10.0,
                 seed: int = 0):
        self.star_density = star_density
        self.percent_bright = percent_bright
        self._blocks: dict[tuple[int, int], int] = {}
        self._free: list[int] = []
        self._n_slots = 0
        self.stars: dict[int, list] = {}  # slot offset -> [(x, y, bright)]

    def update(self, cam_x: float, cam_y: float, ortho_size: float,
               aspect: float):
        bs = self.BLOCK_SIZE
        min_bx = math.floor((cam_x - 2 * ortho_size * aspect) / bs)
        max_bx = math.floor((cam_x + 2 * ortho_size * aspect) / bs)
        min_by = math.floor((cam_y - 2 * ortho_size) / bs)
        max_by = math.floor((cam_y + 2 * ortho_size) / bs)

        for key in [k for k in self._blocks
                    if not (min_bx <= k[0] <= max_bx and min_by <= k[1] <= max_by)]:
            self._free.append(self._blocks.pop(key))

        for bx in range(min_bx, max_bx + 1):
            for by in range(min_by, max_by + 1):
                if (bx, by) not in self._blocks:
                    self._allocate(bx, by)

    def _allocate(self, bx: int, by: int):
        if self._free:
            offset = self._free.pop()
        else:
            offset = self._n_slots
            self._n_slots += self.star_density
        self._blocks[(bx, by)] = offset
        # Deterministic per-block placement (StarController.SetupBlock).
        import random

        rand = random.Random(bx + by * 107)
        n_bright = int(self.star_density * self.percent_bright / 100.0)
        stars = []
        for i in range(self.star_density):
            sx = (rand.random() + bx) * self.BLOCK_SIZE
            sy = (rand.random() + by) * self.BLOCK_SIZE
            stars.append((sx, sy, i < n_bright))
        self.stars[offset] = stars

    @property
    def visible_stars(self) -> list:
        return [s for off in self._blocks.values() for s in self.stars[off]]


@dataclass
class Abductee:
    """A beam-liftable target (the abduction mechanic; reference input map
    UfoController2.OnTractor)."""

    x: float
    y: float
    mass: float = 1.0
    lift_rate: float = 2.5
    captured: bool = False
    abducted: bool = False
    ground_y: float = 0.0
    fall_rate: float = 6.0


class TractorBeam:
    """Cone-of-influence lift: targets inside the beam cone below the UFO
    rise toward it; released targets fall back to the ground."""

    def __init__(self, half_angle_deg: float = 18.0, beam_range: float = 8.0):
        self.half_angle = math.radians(half_angle_deg)
        self.range = beam_range
        self.active = False

    def in_cone(self, ufo: UfoController, a: Abductee) -> bool:
        dx, dy = a.x - ufo.x, ufo.y - a.y
        if dy <= 0 or dy > self.range:
            return False
        return abs(math.atan2(dx, dy)) <= self.half_angle

    def update(self, ufo: UfoController, targets: list, dt: float) -> int:
        """Returns the number of targets abducted this step."""
        scored = 0
        for a in targets:
            if a.abducted:
                continue
            if self.active and self.in_cone(ufo, a):
                a.captured = True
                # lift toward the UFO, heavier targets rise slower
                rate = a.lift_rate / max(a.mass, 1e-3)
                a.x += (ufo.x - a.x) * min(1.0, rate * dt)
                a.y += rate * dt
                if math.hypot(a.x - ufo.x, a.y - ufo.y) < 0.75:
                    a.abducted = True
                    scored += 1
            else:
                a.captured = False
                a.y = max(a.ground_y, a.y - a.fall_rate * dt)
        return scored


class AbductionGame:
    """The composed headless game: UFO + camera + beam + targets + ambient
    animation, advanced by `step(dt, GameInput)`. Rendering stays in
    demo/abduction.py — `scene_params()` exposes everything a renderer
    needs (UFO pose, beam state, camera, parallax offsets, star field)."""

    def __init__(self, n_targets: int = 5, world_width: float = 60.0, seed: int = 7):
        import random

        rng = random.Random(seed)
        self.fsm = GameStateController()
        self.ufo = UfoController()
        self.camera = CameraController()
        self.beam = TractorBeam()
        self.water = WaterAnimation()
        self.stars = StarField(seed=seed)
        self.hill_parallax = [Parallax(rate_x=r) for r in (0.3, 0.6, 0.85)]
        self.targets = [
            Abductee(x=rng.uniform(-world_width / 2, world_width / 2), y=0.0,
                     mass=rng.uniform(0.8, 2.0))
            for _ in range(n_targets)
        ]
        self.score = 0
        self.elapsed = 0.0
        self.won = False

    def step(self, dt: float, inp: GameInput):
        if inp.pause:
            if self.fsm.state == GameStates.PLAYING:
                self.fsm.transition(GameStates.PAUSED)
            elif self.fsm.state == GameStates.PAUSED:
                self.fsm.transition(GameStates.PLAYING)
        if self.fsm.state == GameStates.TITLE and (
                inp.move_x or inp.move_y or inp.tractor):
            self.fsm.transition(GameStates.PLAYING)
        if self.fsm.state != GameStates.PLAYING:
            return

        self.elapsed += dt
        self.ufo.fixed_update(inp.move_x, inp.move_y, dt)
        self.beam.active = inp.tractor
        self.score += self.beam.update(self.ufo, self.targets, dt)
        self.camera.update(self.ufo.x, self.ufo.y, dt)
        for p in self.hill_parallax:
            p.late_update(self.camera.x, self.camera.y)
        self.water.update(dt)
        self.stars.update(self.camera.x, self.camera.y,
                          self.camera.ortho_size, self.camera.aspect)
        if not self.won and all(t.abducted for t in self.targets):
            self.won = True

    def scene_params(self) -> dict:
        """Everything the renderer needs to lay out one frame."""
        return {
            "ufo": (self.ufo.x, self.ufo.y, self.ufo.angle),
            "beam_on": self.beam.active,
            "camera": (self.camera.x, self.camera.y),
            "targets": [(t.x, t.y, t.captured) for t in self.targets
                        if not t.abducted],
            "parallax": [(p.x, p.y) for p in self.hill_parallax],
            "water": (self.water.offset1, self.water.offset2),
            "stars": self.stars.visible_stars,
            "score": self.score,
            "won": self.won,
            "state": self.fsm.state.value,
        }
