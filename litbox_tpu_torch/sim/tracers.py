"""Tracer orchestration (counterpart of the JAX package's sim/tracers.py;
reference: ITracer.cs, LightTransportTracer.cs, HybridTracer.cs,
ForwardMonteCarlo.cs, BackwardMonteCarlo.cs).

Host-side objects that own device accumulators and call the trace and
resolve functions. Two tracer strategies:

  LightTransportTracer: forward-only, the outscatter finalized in its HDR
                        output.
  HybridTracer:         the forward pass (outscatter not finalized) feeds
                        the backward per-pixel gather (`BackwardIntegrator`);
                        the output is the backward accumulation
                        (HybridTracer.cs:17-21, 96-101).

The forward integrator is the oracle march (`ForwardIntegrator`) or the
rotated-bin transport (`RBTForwardIntegrator`, with the deterministic
multi-bounce cascade of sim/dom.py behind `dom_bounce`), and
`make_paired_light_transport` gives the 'rbt-paired' engine's two views of
one dual-tracer integrator.

Every call takes an explicit `torch.Generator` on the scene's device where
the JAX version takes a key. Per-scene static choices (which direct-light
phases run, the light kinds, BRDF) are read on the host once per scene
change, in one copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import luts
from ..core.types import GBuffer
from .backward import backward_bin_for_frame, backward_gather, backward_gather_rbt
from .dom import dom_bounce_sources
from .emission import effective_bounces
from .oracle import to_hdr, trace_frame
from .rbt import (analytic_light_mask, collimated_direct_raw, collimated_light_mask,
                  precompute_rotated_fields, rbt_trace_frame, resolve_raw,
                  zero_sources)


@functools.cache
def _brdf_on(device: torch.device) -> torch.Tensor:
    """The BRDF LUT on `device`, built and copied once per device."""
    return torch.from_numpy(luts.brdf_lut()).to(device)


@functools.cache
def _teardrop_on(device: torch.device) -> torch.Tensor:
    """The backward gather's teardrop LUT on `device`, copied once per device."""
    return torch.from_numpy(luts.teardrop_scattering_lut(3.0)).to(device)


def _to_host(*tensors) -> list:
    """Several small device tensors read on the host in ONE copy (one wait
    for the stream): flattened to int64, concatenated, split back."""
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu().numpy()
    return np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])


class ForwardIntegrator:
    """Forward Monte Carlo host (reference: ForwardMonteCarlo.cs), on the
    oracle march (sim/oracle.py)."""

    def __init__(self, finalize_outscatter: bool = True, bilinear_writes: bool = True):
        self.finalize_outscatter = finalize_outscatter
        self.bilinear_writes = bilinear_writes
        self.integration_interval = 0.2
        self.rays_to_emit = 65536
        self.override_bounce_count: int | None = None
        self.max_bounces = 4
        self.gbuffer: GBuffer | None = None
        self.iterations_since_clear = 0
        self._write_count = 0
        self._photon_count = 0
        self._accum = None

    @property
    def _brdf(self) -> torch.Tensor:
        return _brdf_on(self.gbuffer.albedo.device)

    @property
    def write_count(self) -> int:
        """Progress counter since clear. Units differ by engine: the oracle
        counts texture deposits (the reference's MWrites semantics,
        Simulation.cs:447-451), the RBT engine counts photons emitted. The
        oracle's count accumulates on the device; reading this property is
        its only wait for the stream."""
        return int(self._write_count)

    @property
    def photon_count(self) -> int:
        """Photons emitted since clear: the same unit for every engine."""
        return int(self._photon_count)

    @property
    def interval_texels(self) -> float:
        # ForwardMonteCarlo.cs:242 (per-dispatch value; the max(1,..) branch).
        return max(1.0, self.integration_interval * self.gbuffer.height)

    def clear(self):
        self.iterations_since_clear = 0
        self._write_count = 0
        self._photon_count = 0
        self._accum = None

    def _zeros(self) -> torch.Tensor:
        gb = self.gbuffer
        return torch.zeros((gb.height, gb.width, 3), device=gb.albedo.device)

    def integrate(self, scene, generator: torch.Generator) -> None:
        if self._accum is None:
            self._accum = self._zeros()
        self.iterations_since_clear += 1
        override = -1 if self.override_bounce_count is None else int(self.override_bounce_count)
        raw, wc = trace_frame(
            self.gbuffer, scene.lights, scene.field_textures, self._brdf, generator,
            self.rays_to_emit, float(self.interval_texels), override,
            max_bounces=self.max_bounces, bilinear=self.bilinear_writes)
        self._accum = self._accum + raw
        self._write_count = self._write_count + wc  # on the device; no wait
        self._photon_count = self._photon_count + self.rays_to_emit

    @property
    def raw_accumulation(self) -> torch.Tensor:
        """Raw pre-HDR accumulated deposits (the reference's
        ForwardAccumulation debug view, SimulationTexturePicker.cs:9,96-97)."""
        return self._zeros() if self._accum is None else self._accum

    @property
    def output_hdr(self) -> torch.Tensor:
        if self._accum is None:
            return self._zeros()
        return to_hdr(self._accum, float(self.iterations_since_clear),
                      self.gbuffer, self.finalize_outscatter)


class RBTForwardIntegrator(ForwardIntegrator):
    """Forward integrator on the rotated-bin transport engine (sim/rbt.py).
    Same interface and normalization as ForwardIntegrator; the per-bin
    source accumulator replaces the raw deposit map and is resolved (scan +
    rotate-back, kernels K1-K3) lazily on output."""

    def __init__(self, finalize_outscatter: bool = True, bilinear_writes: bool = True,
                 n_bins: int = 128, n_tracers: int = 1):
        self.n_bins = n_bins
        # Dual-tracer axis: n_tracers=2 traces both tracers of the variance
        # pair in one batch into a tracer-major (2D, S, S) source buffer.
        # rays_to_emit stays the per-tracer budget.
        self.n_tracers = n_tracers
        self.bounce_rays = 0  # 0 = no Russian-roulette culling after wave 0
        # Analytic zero-variance direct lighting; disable to reproduce the
        # reference's Monte-Carlo direct-light noise.
        self.analytic_direct = True
        # Bin-fan phase ladder: frame i uses phase ((i mod K)+0.5)/K, which
        # stratifies each bin's angular cone over K sub-angles. Per-phase
        # rotated fields and source buffers are cached; the readout sums the
        # K per-phase resolves.
        self.jitter_bins = False
        self.jitter_phases = 8
        # Ladder memory cap (bytes): per phase (5 + 1/16)*D*S^2*4 B of
        # cached fields and sources; _effective_jitter_phases clamps K.
        self.jitter_memory_budget = 3.2e9
        self._phase_fields = {}
        self._phase_src = {}
        self._fields = None
        self._src = None
        self._resolved = {}
        self._gbuffer = None
        self._mc_direct = None
        self._enable_brdf = True
        self._light_kinds = None
        self._hist_direct = False
        # Exact-direction wave-0 for collimated lights (lasers, directional
        # lights): zero variance and no D-bin angular quantization. A
        # scene-static field added at readout.
        self.exact_collimated = True
        self._exact_raw = None
        # What the specializations were derived from: options, then the
        # scene and GBuffer objects (compared by identity).
        self._spec_key = self._spec_scene = self._spec_gb = None
        # Angular group-interleaved display resolve: with resolve_groups=K,
        # each display_hdr read resolves only the bins d == t (mod K) of one
        # (phase, group) combination and composes the cached partial rates
        # of the others. output_hdr is always the exact full resolve.
        self._resolve_groups = 1
        self._group_rate = {}
        self._group_sum = {}
        self._group_next = {}
        self._group_frame = {}
        self._group_display = {}
        # Deterministic multi-bounce (sim/dom.py): per-frame tracing is
        # direct only and bounce transport is the zero-variance cascade,
        # recomputed from the accumulated direct sources every dom_refresh
        # frames and added at readout as a per-frame rate image (as the
        # exact collimated field is). Engages only on normal-free medium
        # scenes with bounces to cascade (_dom_active).
        self.dom_bounce = False
        self.dom_refresh = 8
        self._dom_waves = 0
        self._dom_ok = None
        self._dom_raw_rate = None
        self._dom_it = -1
        super().__init__(finalize_outscatter, bilinear_writes)

    @property
    def resolve_groups(self) -> int:
        return self._resolve_groups

    @resolve_groups.setter
    def resolve_groups(self, k: int):
        k = int(k)
        if k < 1 or self.n_bins % k != 0:
            raise ValueError(
                f"resolve_groups={k} must be >=1 and divide n_bins={self.n_bins}"
                " (the grouped scan selects bins d == t (mod K) with a static stride)")
        if k != self._resolve_groups:
            self._resolve_groups = k
            self._clear_groups()

    def _clear_groups(self):
        self._group_rate = {}
        self._group_sum = {}
        self._group_next = {}
        self._group_frame = {}
        self._group_display = {}

    @property
    def gbuffer(self):
        return self._gbuffer

    @gbuffer.setter
    def gbuffer(self, gb):
        if gb is not self._gbuffer or gb is None:
            self._gbuffer = gb
            self._fields = None  # rotated fields are scene-dependent
            self._phase_fields = {}

    def clear(self):
        super().clear()
        self._src = None
        self._resolved = {}
        self._phase_src = {}
        self._dom_raw_rate = None
        self._dom_it = -1
        self._clear_groups()

    def _effective_jitter_phases(self, gb) -> int:
        """Phase-ladder length clamped to jitter_memory_budget bytes of
        cached per-phase rotated fields + source buffers."""
        s = int(-(-int(np.ceil((gb.height**2 + gb.width**2) ** 0.5)) // 128) * 128)
        per_phase = (5.0 + 1.0 / 16.0) * self.n_bins * s * s * 4.0
        max_k = max(1, int(self.jitter_memory_budget // per_phase))
        return min(self.jitter_phases, max_k)

    def _specialize(self, scene, override: int) -> None:
        """The per-scene static choices, read on the host in one copy. They
        are kept until the scene, the GBuffer, the bounce override or an
        option they read changes (the JAX version derives them again after
        every clear, so once a frame in realtime mode)."""
        gb = self.gbuffer
        lights, shapes = scene.lights, scene.shapes
        eff_b = effective_bounces(lights.bounces, override)
        active = lights.active & (eff_b != 0)
        brdf = (shapes.active & (shapes.alignment > 0)).any()
        mask, collim, eff_b, active, kinds, on, brdf = _to_host(
            analytic_light_mask(lights, override), collimated_light_mask(lights, override),
            eff_b, active, lights.kind, lights.active, brdf)
        mask, collim, active, on = (a.astype(bool) for a in (mask, collim, active, on))
        self._exact_raw = None
        if self.exact_collimated and collim.any():
            self._exact_raw = collimated_direct_raw(gb, lights, gb.height, gb.width,
                                                    override)
        if self._exact_raw is None:
            collim = np.zeros_like(active)
        not_exact = active & ~collim
        self._mc_direct = ((not self.analytic_direct) and bool(not_exact.any())
                           ) or bool((not_exact & ~mask).any())
        self._enable_brdf = bool(brdf[0])
        self._light_kinds = tuple(sorted({int(k) for k, a in zip(kinds, on) if a}))
        # Histogram fast path for the MC direct deposits: every active light
        # is a point light whose stamp never clips.
        self._hist_direct = (self._mc_direct and not self.analytic_direct
                             and bool(mask[active].all()))
        # DOM eligibility (a normal-free medium with bounces to cascade);
        # the normal field is read only when dom_bounce asks.
        self._dom_waves = max(0, min(self.max_bounces,
                                     int(eff_b[active].max()) if active.any() else 0) - 1)
        self._dom_ok = None

    def _dom_active(self) -> bool:
        """Whether the cascade runs: dom_bounce on a normal-free medium
        (no BRDF shape, no normal in the GBuffer) with bounces to cascade.
        The normal field is read on the host once per scene change, and only
        when dom_bounce asks."""
        if not (self.dom_bounce and not self._enable_brdf and self._dom_waves > 0):
            return False
        if self._dom_ok is None:
            self._dom_ok = float(torch.abs(self.gbuffer.normal[..., :2]).max()) == 0.0
        return self._dom_ok

    def integrate(self, scene, generator: torch.Generator) -> None:
        gb = self.gbuffer
        if self.jitter_bins:
            phases = self._effective_jitter_phases(gb)
            k = self.iterations_since_clear % phases
            if k not in self._phase_fields:
                self._phase_fields[k] = precompute_rotated_fields(
                    gb, n_bins=self.n_bins, phase=(k + 0.5) / phases)
            self._fields = self._phase_fields[k]
            self._src = self._phase_src.get(k)
        if self._fields is None:
            self._fields = precompute_rotated_fields(gb, n_bins=self.n_bins)
            self._src = None
        if self._src is None:
            self._src = zero_sources(self._fields, n_tracers=self.n_tracers)
        self.iterations_since_clear += 1
        override = -1 if self.override_bounce_count is None else int(self.override_bounce_count)
        key = (override, self.exact_collimated, self.analytic_direct, self.max_bounces)
        if (self._spec_key != key or self._spec_scene is not scene
                or self._spec_gb is not gb):
            self._specialize(scene, override)
            self._spec_key, self._spec_scene, self._spec_gb = key, scene, gb
        dom_on = self._dom_active()
        if dom_on and self.jitter_bins:
            raise NotImplementedError(
                "dom_bounce with the jitter-phase ladder needs a per-phase "
                "cascade; disable one of the two")
        if dom_on and self.n_tracers > 1:
            raise NotImplementedError(
                "dom_bounce needs per-tracer cascade sources; use the "
                "single-tracer integrator for DOM scenes")
        self._src, n = rbt_trace_frame(
            self._fields, self._src, gb, scene.lights, scene.field_textures,
            self._brdf, generator, self.n_tracers * self.rays_to_emit, override,
            # DOM: per-frame tracing is direct only; bounce transport is the
            # cascade, refreshed on a cadence.
            max_bounces=1 if dom_on else self.max_bounces,
            bounce_photons=self.bounce_rays,
            mc_direct=self._mc_direct, enable_brdf=self._enable_brdf,
            light_kinds=self._light_kinds, analytic_direct=self.analytic_direct,
            hist_direct=self._hist_direct,
            exact_collimated=self._exact_raw is not None, n_tracers=self.n_tracers)
        self._write_count += n  # RBT writes ARE photons
        self._photon_count += n
        self._resolved = {}
        if self.jitter_bins:
            k = (self.iterations_since_clear - 1) % self._effective_jitter_phases(gb)
            self._phase_src[k] = self._src
        # Returns nothing: outputs resolve lazily at readout.

    def _with_exact(self, raw: torch.Tensor) -> torch.Tensor:
        """Add the per-frame-rate side fields, the scene-static exact
        collimated wave-0 field and the DOM bounce cascade, scaled by the
        accumulated iteration count."""
        it = float(self.iterations_since_clear)
        if self._exact_raw is not None:
            raw = raw + self._exact_raw * it
        dom = self._dom_rate()
        if dom is not None:
            raw = raw + dom * it
        return raw

    def _dom_rate(self):
        """The cascade's bounce lightmap per accumulated frame, cached and
        refreshed every dom_refresh frames (dom_bounce_sources is linear in
        the accumulated direct sources, so rate * iterations is exact up to
        the refresh lag)."""
        if self._src is None or not self._dom_active():
            return None
        it = max(1, self.iterations_since_clear)
        if self._dom_raw_rate is None or it - self._dom_it >= self.dom_refresh:
            gb = self.gbuffer
            dom_src = dom_bounce_sources(self._fields, gb, self._src,
                                         n_waves=self._dom_waves)
            self._dom_raw_rate = resolve_raw(self._fields, dom_src, gb.height,
                                             gb.width) / float(it)
            self._dom_it = it
        return self._dom_raw_rate

    @property
    def raw_accumulation(self) -> torch.Tensor:
        """Raw pre-HDR accumulated deposits: the lazy resolve of the per-bin
        sources plus the exact collimated field. Tracer 0's view."""
        return self.raw_accumulation_for(0)

    def raw_accumulation_for(self, tracer: int) -> torch.Tensor:
        """Per-tracer raw accumulation (the scan reads the tracer's block of
        the tracer-major sources in place)."""
        gb = self.gbuffer
        if self.jitter_bins:
            if not self._phase_src:
                return self._zeros()
            if self._resolved.get(tracer) is None:
                total = None
                for k, src in self._phase_src.items():
                    raw = resolve_raw(self._phase_fields[k], src, gb.height, gb.width,
                                      traced_phase=True, tracer=tracer)
                    total = raw if total is None else total + raw
                self._resolved[tracer] = total
            return self._with_exact(self._resolved[tracer])
        if self._src is None:
            return self._zeros()
        if self._resolved.get(tracer) is None:
            self._resolved[tracer] = resolve_raw(
                self._fields, self._src, gb.height, gb.width, tracer=tracer)
        return self._with_exact(self._resolved[tracer])

    def _display_raw_rate(self, tracer: int = 0) -> torch.Tensor:
        """Per-frame-rate raw deposits for the realtime display: refresh one
        (phase, group) combination's partial resolve, compose the cache.

        Each cached entry is resolve_raw(group=t)/iters_at_resolve, an
        unbiased estimate of that angular group's per-frame deposit rate.
        Until the cache is full the sum is rescaled by expected/cached.
        Grouped state is independent per tracer view."""
        gb = self.gbuffer
        k_groups = self.resolve_groups
        iters = float(max(1, self.iterations_since_clear))
        phases = sorted(self._phase_src) if self.jitter_bins else [None]
        if not phases or (phases == [None] and self._src is None):
            return self._zeros()
        c = self._group_next.get(tracer, 0)
        self._group_next[tracer] = c + 1
        t = c % k_groups
        p = phases[(c // k_groups) % len(phases)]
        if p is None:
            fields, src, traced = self._fields, self._src, False
        else:
            fields, src, traced = self._phase_fields[p], self._phase_src[p], True
        rate = resolve_raw(fields, src, gb.height, gb.width, traced_phase=traced,
                           group=t, n_groups=k_groups, tracer=tracer) / iters
        prev = self._group_rate.get((tracer, p, t))
        if self._group_sum.get(tracer) is None:
            self._group_sum[tracer] = rate
        elif prev is None:
            self._group_sum[tracer] = self._group_sum[tracer] + rate
        else:
            self._group_sum[tracer] = self._group_sum[tracer] + (rate - prev)
        self._group_rate[(tracer, p, t)] = rate
        expected = k_groups * len(phases)
        n_cached = sum(1 for key in self._group_rate if key[0] == tracer)
        scale = expected / n_cached
        total = (self._group_sum[tracer] * scale if scale != 1.0
                 else self._group_sum[tracer])
        if self._exact_raw is not None:
            total = total + self._exact_raw
        dom = self._dom_rate()
        if dom is not None:
            total = total + dom
        return total

    @property
    def output_hdr(self) -> torch.Tensor:
        """Exact HDR output (full resolve): what convergence measurement and
        every quality-bearing consumer read."""
        return self.output_hdr_for(0)

    def output_hdr_for(self, tracer: int) -> torch.Tensor:
        return to_hdr(self.raw_accumulation_for(tracer),
                      float(self.iterations_since_clear),
                      self.gbuffer, self.finalize_outscatter)

    @property
    def display_hdr(self) -> torch.Tensor:
        """Realtime display HDR: the group-interleaved composed resolve when
        resolve_groups > 1, else exact."""
        return self.display_hdr_for(0)

    def display_hdr_for(self, tracer: int) -> torch.Tensor:
        if self.resolve_groups > 1:
            # One refresh per traced frame no matter how many reads.
            if self._group_frame.get(tracer, -1) != self.iterations_since_clear:
                self._group_frame[tracer] = self.iterations_since_clear
                self._group_display[tracer] = to_hdr(
                    self._display_raw_rate(tracer), 1.0, self.gbuffer,
                    self.finalize_outscatter)
            return self._group_display[tracer]
        return self.output_hdr_for(tracer)


class BackwardIntegrator:
    """Backward gather host (reference: BackwardMonteCarlo.cs).

    When the forward pass runs on the RBT engine, HybridTracer shares its
    rotated fields here (rbt_fields) and each frame evaluates the exact
    gather integral along one direction bin for every pixel
    (backward_gather_rbt), the deterministic-cubature replacement for the
    reference's one lobed ray per pixel. Without fields it takes the
    faithful per-pixel march (backward_gather)."""

    def __init__(self):
        self.integration_interval = 0.2
        self.gbuffer: GBuffer | None = None
        self.importance_target_uv = (0.5, 0.5)
        self.rbt_fields = None
        self._accum = None
        self.frame_count = 0

    def clear(self):
        self._accum = None
        self.frame_count = 0

    def integrate(self, forward_hdr: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        gb = self.gbuffer
        if self.rbt_fields is not None:
            b = backward_bin_for_frame(self.frame_count, self.rbt_fields.n_bins)
            sample = backward_gather_rbt(self.rbt_fields, gb, forward_hdr, b)
        else:
            interval = max(0.01, self.integration_interval * gb.height)
            sample = backward_gather(gb, forward_hdr, _teardrop_on(gb.albedo.device),
                                     generator, interval, self.importance_target_uv)
        self._accum = sample if self._accum is None else self._accum + sample
        self.frame_count += 1
        return self.output

    @property
    def output(self) -> torch.Tensor:
        if self._accum is None or self.frame_count == 0:
            gb = self.gbuffer
            return torch.zeros((gb.height, gb.width, 3), device=gb.albedo.device)
        return self._accum / self.frame_count


def _make_forward(engine: str, finalize_outscatter: bool) -> ForwardIntegrator:
    if engine == "rbt":
        return RBTForwardIntegrator(finalize_outscatter=finalize_outscatter)
    if engine == "oracle":
        return ForwardIntegrator(finalize_outscatter=finalize_outscatter)
    raise ValueError(f"unknown engine {engine!r} (expected 'rbt' or 'oracle')")


class PairedTracerView:
    """One tracer's view of a SHARED paired RBT integrator.

    The engine runs two independent tracers per frame purely for variance
    estimation (Simulation.cs:78); with the tracer axis
    (rbt_trace_frame(n_tracers=2)) both trace in one batch. Two views
    duck-type LightTransportTracer over one RBTForwardIntegrator(n_tracers=2):
    view 0 drives the shared frame work when Simulation steps the tracers in
    order; view 1's begin_trace/new_scene do nothing. Outputs and grouped
    display caches are per tracer. Use both views through the owning
    Simulation.
    """

    def __init__(self, forward: RBTForwardIntegrator, idx: int):
        self.forward = forward
        self.idx = idx

    @property
    def gbuffer(self):
        return self.forward.gbuffer

    @gbuffer.setter
    def gbuffer(self, gb):
        if self.idx == 0:
            self.forward.gbuffer = gb

    @property
    def early_radiance(self):
        return None

    @property
    def tracer_output(self):
        return self.forward.output_hdr_for(self.idx)

    @property
    def display_output(self):
        return self.forward.display_hdr_for(self.idx)

    @property
    def forward_write_count(self):
        # The shared integrator counts both tracers' photons; each view
        # reports its share, in the unpaired engines' units.
        return self.forward.write_count // self.forward.n_tracers

    @property
    def forward_photon_count(self):
        return self.forward.photon_count // self.forward.n_tracers

    def new_scene(self):
        if self.idx == 0:
            self.forward.clear()

    def begin_trace(self, scene, generator: torch.Generator):
        if self.idx == 0:
            self.forward.integrate(scene, generator)

    def end_trace(self, importance_map=None, generator=None):
        pass


def make_paired_light_transport(n_bins: int = 128) -> list:
    """The 'rbt-paired' engine: two PairedTracerViews over one shared
    RBTForwardIntegrator(n_tracers=2)."""
    shared = RBTForwardIntegrator(finalize_outscatter=True, n_bins=n_bins, n_tracers=2)
    return [PairedTracerView(shared, 0), PairedTracerView(shared, 1)]


class LightTransportTracer:
    """Forward-only strategy (reference: LightTransportTracer.cs)."""

    def __init__(self, engine: str = "rbt"):
        self.forward = _make_forward(engine, finalize_outscatter=True)

    @property
    def gbuffer(self):
        return self.forward.gbuffer

    @gbuffer.setter
    def gbuffer(self, gb):
        self.forward.gbuffer = gb

    @property
    def early_radiance(self):
        return None

    @property
    def tracer_output(self):
        return self.forward.output_hdr

    @property
    def display_output(self):
        """Realtime display image: the grouped approximate resolve when the
        forward integrator has one, its exact output otherwise. (The JAX
        version passes output_hdr as getattr's default, which Python
        evaluates first: a full resolve on every display read. Here the
        exact output is read only when there is no display.)"""
        display = getattr(self.forward, "display_hdr", None)
        return self.forward.output_hdr if display is None else display

    @property
    def forward_write_count(self):
        return self.forward.write_count

    @property
    def forward_photon_count(self):
        return self.forward.photon_count

    def new_scene(self):
        self.forward.clear()

    def begin_trace(self, scene, generator: torch.Generator):
        self.forward.integrate(scene, generator)

    def end_trace(self, importance_map=None, generator=None):
        pass


class HybridTracer:
    """The forward pass feeds the per-pixel backward gather (reference:
    HybridTracer.cs).

    forward_refresh_interval amortizes the forward resolve: the backward
    gather reuses the last resolved forward HDR for K-1 frames. The
    reference re-reads the forward texture every frame (HybridTracer.cs:17);
    a slightly stale forward radiance converges to the same gather integral
    but alters early-frame transients, so the default is 1 (the reference's
    cadence) and Simulation's realtime mode takes 4."""

    def __init__(self, engine: str = "rbt", forward_refresh_interval: int = 1):
        self.forward = _make_forward(engine, finalize_outscatter=False)
        self.backward = BackwardIntegrator()
        self.forward_refresh_interval = max(1, forward_refresh_interval)
        self._cached_forward_hdr = None

    @property
    def gbuffer(self):
        return self.forward.gbuffer

    @gbuffer.setter
    def gbuffer(self, gb):
        self.forward.gbuffer = gb
        self.backward.gbuffer = gb

    @property
    def early_radiance(self):
        return self.forward.output_hdr

    @property
    def tracer_output(self):
        return self.backward.output

    @property
    def display_output(self):
        return self.backward.output

    @property
    def forward_write_count(self):
        return self.forward.write_count

    @property
    def forward_photon_count(self):
        return self.forward.photon_count

    def new_scene(self):
        self.forward.clear()
        self.backward.clear()
        self._cached_forward_hdr = None

    def begin_trace(self, scene, generator: torch.Generator):
        self.forward.integrate(scene, generator)

    def end_trace(self, importance_map=None, generator=None):
        # The forward integrator's current fields (its jitter phase's, when
        # the ladder is on); the oracle march has none.
        fields = getattr(self.forward, "_fields", None)
        if fields is not None:
            self.backward.rbt_fields = fields
        if (self._cached_forward_hdr is None
                or self.backward.frame_count % self.forward_refresh_interval == 0):
            self._cached_forward_hdr = self.forward.output_hdr
        self.backward.integrate(self._cached_forward_hdr, generator)
