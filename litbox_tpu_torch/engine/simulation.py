"""Simulation frame loop (counterpart of the JAX package's
engine/simulation.py; reference: Assets/Scripts/Simulation/Simulation.cs).

Dual-tracer loop: two independent tracer instances per frame purely to
estimate temporal variance (Simulation.cs:78), realtime vs reference modes,
profile loading, dirty-scene invalidation, convergence-threshold stopping,
importance-map refresh scheduling, and perf counters. The "run until
converged" loop stays on the host, with a scalar read back every
`measurement_interval` frames (the reference's async readback,
Simulation.cs:434-438, 469-493).

Everything runs on `device` ("cuda" unless the caller asks for "cpu"); a
scene on another device is refused. One `torch.Generator` on that device,
seeded from `seed`, feeds every tracer in turn. The host reads the scene
only when it changes: the structural diff of `set_scene`, the lights'
bounce counts and each tracer's per-scene specializations. Both
strategies run: the forward-only `LightTransportTracer` and the hybrid
`HybridTracer` (the forward pass feeding the backward gather).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable

import torch

from ..core.types import GBuffer, SimulationProfile
from ..post.tracer_post import compute_cv_and_mips, importance_pyramid, measure_convergence
from ..scene.gbuffer import rasterize
from ..scene.scene import Scene
from ..sim.tracers import HybridTracer, LightTransportTracer, make_paired_light_transport


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dataclasses, tuples and tensors; the
    path carries each level's type and field name, so two trees of another
    structure differ in their paths."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (type(tree), f.name))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (type(tree), i))
    else:
        yield path, tree


def _pytree_equal(a, b) -> bool:
    """Structural equality: the same tree, and each leaf the same object or
    an equal tensor (identity first, so an unchanged scene costs no read)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    return all(x is y or (x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y))
               for (_, x), (_, y) in zip(la, lb))


def _substrate_unchanged(prev, scene) -> bool:
    """True when nothing that feeds the GBuffer rasterizer differs."""
    return (_pytree_equal(prev.shapes, scene.shapes)
            and _pytree_equal(prev.textures, scene.textures))


class Strategy(enum.Enum):
    LIGHT_TRANSPORT = "light_transport"
    HYBRID = "hybrid"


class Mode(enum.Enum):
    REALTIME = "realtime"
    REFERENCE = "reference"


@dataclasses.dataclass
class Simulation:
    width: int = 256
    height: int = 256
    strategy: Strategy = Strategy.LIGHT_TRANSPORT
    mode: Mode = Mode.REALTIME
    rays_per_frame: int = 65536
    photon_bounces: int = -1
    integration_interval: float = 0.1
    frame_limit: int = -1
    convergence_threshold: float = -1.0
    measurement_interval: int = 100
    seed: int = 0
    # 'rbt' (production), 'oracle' (reference semantics), or 'rbt-paired'
    # (both variance tracers in ONE combined RBT trace per frame;
    # LIGHT_TRANSPORT only).
    engine: str = "rbt"
    # Hybrid-strategy forward->backward refresh cadence: 1 is the
    # reference's cadence (HybridTracer.cs:17, the backward gather re-reads
    # the forward HDR every frame); REALTIME mode takes 4 to amortize the
    # forward resolve unless it is set (tracers.HybridTracer).
    forward_refresh_interval: int | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._tracers = None
        self._strategy_built = None
        self._scene: Scene | None = None
        self._scene_bounces = 2
        self._gbuffer: GBuffer | None = None
        self._dirty = True
        self._lights_dirty = False
        self.iterations_since_clear = 0
        self.has_converged = False
        self.convergence_progress = -1.0
        self.convergence_start_time = 0.0
        self._output_hdr = None
        self._variance_map = None
        self._outputs_stale = False
        self.importance_map = None
        # Consumer-driven pyramid generation: stays False until something
        # that reads the pyramid attaches (see _should_update_importance_map).
        self.wants_importance_map = False
        self.photon_writes_per_second = 0.0
        self.photons_per_second = 0.0
        self._last_perf = None
        self.on_step: list[Callable[[int], None]] = []
        self.on_converged: list[Callable[[], None]] = []
        self.on_convergence_update: list[Callable[[float], None]] = []
        self._gen = None  # made on the device at the first frame

    # ----- scene management -----

    def set_scene(self, scene: Scene):
        """Set/replace the scene with fine-grained change detection.

        The reference's ChangeManager invalidates only the 'dirtyFrame'
        group when a light moves, while substrate edits also rebuild the
        GBuffer (PhotonerComponent.cs:6-91, ChangeManager.cs:9-94). Here a
        structural diff on assignment does the same: if only lights changed,
        accumulation resets but the GBuffer, and with it the RBT engine's
        rotated-field precompute keyed on GBuffer identity, is reused.
        """
        dev = torch.device(self.device)
        for _, leaf in _leaves(scene):
            if leaf.device.type != dev.type or (
                    dev.index is not None and leaf.device.index != dev.index):
                raise ValueError(f"the scene lies on {leaf.device}, the simulation on "
                                 f"{self.device}: build it with device={self.device!r}")
        prev = self._scene
        self._scene = scene
        lights = scene.lights
        self._scene_bounces = int(max(1, int((lights.bounces * lights.active).max())))
        if prev is not None and _substrate_unchanged(prev, scene):
            if not _pytree_equal(prev.lights, scene.lights):
                self._lights_dirty = True
            return
        self.invalidate()

    def invalidate(self):
        """Mark the whole scene dirty (reference: OnInvalidated('dirtyFrame'),
        Simulation.cs:122-131)."""
        self._dirty = True

    def load_profile(self, profile: SimulationProfile):
        """Apply a run profile (Simulation.cs:133-141)."""
        self.frame_limit = profile.frame_limit
        self.rays_per_frame = profile.rays_per_frame
        self.integration_interval = profile.integration_interval
        self.photon_bounces = profile.photon_bounces
        self.has_converged = False
        self.iterations_since_clear = 0
        self._dirty = True

    def _refresh_outputs(self):
        if self._outputs_stale:
            mean, cv, _ = compute_cv_and_mips(
                self._tracers[0].tracer_output, self._tracers[1].tracer_output)
            self._output_hdr = mean
            self._variance_map = cv
            self._outputs_stale = False

    @property
    def simulation_output_hdr(self):
        self._refresh_outputs()
        return self._output_hdr

    @property
    def display_hdr(self):
        """Realtime display image: the tracer-pair mean of the display
        outputs (the grouped approximate resolve when resolve_groups > 1 on
        the RBT engine). Quality-bearing consumers read
        simulation_output_hdr, which is always the exact resolve."""
        a, b = self._tracers
        return (a.display_output + b.display_output) * 0.5

    @property
    def variance_map(self):
        self._refresh_outputs()
        return self._variance_map

    @property
    def gbuffer(self) -> GBuffer | None:
        return self._gbuffer

    @property
    def tracer_a(self):
        return self._tracers[0]

    @property
    def tracer_b(self):
        return self._tracers[1]

    @property
    def is_running(self) -> bool:
        if self.frame_limit != -1:
            return self.iterations_since_clear < self.frame_limit
        return not self.has_converged

    # ----- internals -----

    def _validate_tracers(self):
        if self._strategy_built != (self.strategy, self.engine):
            if self.engine == "rbt-paired":
                if self.strategy != Strategy.LIGHT_TRANSPORT:
                    raise ValueError(
                        "engine='rbt-paired' supports the LIGHT_TRANSPORT "
                        "strategy only (Hybrid keeps per-tracer backward "
                        "accumulators; use engine='rbt')")
                self._tracers = make_paired_light_transport()
            elif self.strategy == Strategy.LIGHT_TRANSPORT:
                self._tracers = [LightTransportTracer(engine=self.engine)
                                 for _ in range(2)]
            else:
                refresh = self.forward_refresh_interval
                if refresh is None:
                    refresh = 4 if self.mode == Mode.REALTIME else 1
                self._tracers = [HybridTracer(engine=self.engine,
                                              forward_refresh_interval=refresh)
                                 for _ in range(2)]
            self._strategy_built = (self.strategy, self.engine)
            self._dirty = True
        for t in self._tracers:
            t.forward.integration_interval = self.integration_interval
            t.forward.rays_to_emit = self.rays_per_frame
            t.forward.override_bounce_count = (
                None if self.photon_bounces == -1 else self.photon_bounces)
            t.forward.max_bounces = self._max_bounces()
            if isinstance(t, HybridTracer):
                t.backward.integration_interval = self.integration_interval

    def _max_bounces(self) -> int:
        """The deepest active light's bounce count (read at set_scene), or
        the override."""
        if self.photon_bounces != -1:
            return max(1, self.photon_bounces)
        if self._scene is None:
            return 2
        return self._scene_bounces

    def _should_update_importance_map(self) -> bool:
        """Refresh schedule 1/10/100 (Simulation.cs:368-373), gated on an
        attached consumer (`wants_importance_map`): nothing in the engine
        reads the pyramid, and each refresh costs two forward resolves. The
        map is also made on the first iteration, except in realtime mode,
        which resets the counter every frame (Simulation.cs:370)."""
        if not self.wants_importance_map:
            return False
        i = self.iterations_since_clear
        if i <= 1:
            return self.mode != Mode.REALTIME
        if i < 100:
            return i % 10 == 0
        return i % 100 == 0

    def refresh_importance_map(self):
        """On-demand pyramid for a consumer attaching mid-run; also sets
        wants_importance_map so later frames keep it fresh on the schedule.
        The forward-only strategy has no early radiance, so the exact
        outputs stand in."""
        self.wants_importance_map = True
        if self._tracers is None:
            return None
        # Each early radiance read once: the hybrid's is a forward resolve.
        rads = [r if (r := t.early_radiance) is not None else t.tracer_output
                for t in self._tracers]
        self.importance_map = importance_pyramid(rads[0], rads[1])
        return self.importance_map

    def _generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self._gen

    # ----- frame loop -----

    def step(self):
        """One simulation frame (reference: Update + LateUpdate,
        Simulation.cs:323-467)."""
        if self._scene is None:
            raise RuntimeError("step() called with no scene set")
        self._validate_tracers()

        # The GBuffer (and the RBT field precompute keyed on it) rebuilds
        # only when the substrate changed.
        if self._dirty or self._gbuffer is None:
            self._gbuffer = rasterize(self._scene, self.height, self.width)
        if self._dirty or self._lights_dirty or self.mode == Mode.REALTIME:
            self.has_converged = False
            self.iterations_since_clear = 0
            self._dirty = False
            self._lights_dirty = False

        if not self.is_running:
            return

        if self.iterations_since_clear == 0:
            self.convergence_progress = -1.0
            self.convergence_start_time = time.monotonic()
            for t in self._tracers:
                t.gbuffer = self._gbuffer
                t.new_scene()

        self.iterations_since_clear += 1
        gen = self._generator()
        for t in self._tracers:
            t.begin_trace(self._scene, gen)

        # Gate check first: the hybrid's early radiance is a forward resolve,
        # read once a tracer.
        if self._should_update_importance_map():
            early = [t.early_radiance for t in self._tracers]
            if all(r is not None for r in early):
                self.importance_map = importance_pyramid(*early)

        for t in self._tracers:
            t.end_trace(self.importance_map, gen)

        # Outputs resolve lazily, when they are read.
        self._outputs_stale = True

        for cb in self.on_step:
            cb(self.iterations_since_clear)

        fire_converged = False
        if self.frame_limit != -1 and self.iterations_since_clear >= self.frame_limit:
            self.has_converged = True
            fire_converged = True

        if (self.measurement_interval
                and self.iterations_since_clear % self.measurement_interval == 0
                or (self.iterations_since_clear == 1 and self.convergence_threshold > 0)):
            self._measure_convergence(initial=self.iterations_since_clear == 1)

        if fire_converged:
            for cb in self.on_converged:
                cb()

    def _measure_convergence(self, initial: bool):
        if self.has_converged:
            return
        self.convergence_progress = float(measure_convergence(self.variance_map))
        for cb in self.on_convergence_update:
            cb(self.convergence_progress)
        if not initial and 0 < self.convergence_threshold > self.convergence_progress:
            self.has_converged = True
            for cb in self.on_converged:
                cb()

    def run(self, max_frames: int | None = None):
        """Drive until converged or the frame limit; returns the output."""
        frames = 0
        while self.is_running:
            self.step()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
            if self.mode == Mode.REALTIME and self.frame_limit == -1:
                break  # realtime frames are independent; caller drives the loop
        return self.simulation_output_hdr

    def update_performance_metrics(self):
        """Throughput counters (Simulation.cs:440-461). photons_per_second
        has the same unit for every engine; photon_writes_per_second keeps
        each engine's own write unit (ForwardIntegrator.write_count)."""
        if self._tracers is None:
            return
        now = time.monotonic()
        total_writes = sum(t.forward_write_count for t in self._tracers)
        total_photons = sum(t.forward_photon_count for t in self._tracers)
        if self._last_perf is not None:
            dt = now - self._last_perf[0]
            if dt > 0:
                self.photon_writes_per_second = (total_writes - self._last_perf[1]) / dt
                self.photons_per_second = (total_photons - self._last_perf[2]) / dt
        self._last_perf = (now, total_writes, total_photons)

    @property
    def estimated_convergence_time(self) -> float:
        if self.convergence_threshold <= 0 or self.convergence_progress <= 0:
            return float("inf")
        elapsed = time.monotonic() - self.convergence_start_time
        return elapsed * self.convergence_progress / self.convergence_threshold

    @property
    def estimated_remaining_convergence_time(self) -> float:
        return self.estimated_convergence_time - (time.monotonic() - self.convergence_start_time)
