"""Port parity for the hybrid strategy: litbox_tpu_torch's HybridTracer,
BackwardIntegrator and Simulation(strategy=Strategy.HYBRID) against the JAX
package's, on the CPU at 32x32.

The forward pass is Monte Carlo with another generator, so the output is
held in mass; the schedule (the forward refresh cadence, the fields the
backward gather reads, the strategy's construction) is held exactly."""

import numpy as np
import pytest
import torch

from litbox_tpu.engine import Mode as JaxMode
from litbox_tpu.engine import Simulation as JaxSimulation
from litbox_tpu.engine import Strategy as JaxStrategy
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu_torch.engine import Mode, Simulation, Strategy
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import tracers

W = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(builder_cls):
    """A point light in a medium with a denser rect (tests/test_backward.py's
    refresh scene)."""
    b = builder_cls()
    b.add_point_light((16, 16), radius=3, intensity=1.0, bounces=2)
    b.add_rect((16, 16), (32, 32), color=(0.8, 0.8, 0.8, 1), log_density=-1.0)
    b.add_rect((24, 20), (8, 6), color=(1, 1, 1, 1), log_density=-0.8)
    return b


def _scene():
    return _build(SceneBuilder).build(max_lights=2, max_shapes=4, device="cpu")


def _small_bins(sim):
    """Build the simulation's tracers and give their RBT forward integrators
    16 bins."""
    sim._validate_tracers()
    for t in sim._tracers:
        t.forward.n_bins = 16


def _hybrid(cls, strategy, engine, **kw):
    """A hybrid Simulation of either package at W: 4 frames of 2048 photons,
    forward refresh 2."""
    return cls(width=W, height=W, strategy=strategy.HYBRID, engine=engine,
               rays_per_frame=2048, frame_limit=4, measurement_interval=0,
               forward_refresh_interval=2, **kw)


@pytest.mark.parametrize("engine", ["rbt", "oracle"])
def test_hybrid_simulation_matches_jax_in_mass(engine):
    """The same scene and settings through both packages' hybrid Simulation
    (forward refresh 2, 4 frames, 16 bins on 'rbt'): the output's mass
    within 5% (the forward passes' photon noise is under 1% of it), the
    backward frame counts and photon counts equal exactly."""
    js = _hybrid(JaxSimulation, JaxStrategy, engine, mode=JaxMode.REFERENCE)
    js.set_scene(_build(JaxSceneBuilder).build(max_lights=2, max_shapes=4))
    ps = _hybrid(Simulation, Strategy, engine, mode=Mode.REFERENCE, device="cpu")
    ps.set_scene(_scene())
    for sim in (js, ps):
        sim._validate_tracers()
        for t in sim._tracers:
            assert t.forward_refresh_interval == 2
            if engine == "rbt":
                t.forward.n_bins = 16
    ref = np.asarray(js.run(), np.float64)
    got = ps.run().double().numpy()
    assert abs(got.sum() / ref.sum() - 1) < 0.05, (got.sum(), ref.sum())
    assert np.isfinite(got).all() and got.min() >= 0
    for jt, pt in zip(js._tracers, ps._tracers):
        assert pt.backward.frame_count == jt.backward.frame_count == 4
        assert pt.forward_photon_count == jt.forward_photon_count == 4 * 2048
        assert (pt.backward.rbt_fields is None) == (engine == "oracle")


def test_hybrid_forward_refresh_amortization(monkeypatch):
    """tests/test_backward.py's check on the port: with refresh 4 the forward
    lightmap is resolved at frames 0 and 4 only, and the backward gather
    reuses the cached HDR in between."""
    calls = {"n": 0}
    real = tracers.resolve_raw

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tracers, "resolve_raw", counting)
    scene = _scene()
    t = tracers.HybridTracer(forward_refresh_interval=4)
    t.forward.n_bins = 16
    t.forward.rays_to_emit = 2048
    t.gbuffer = rasterize(scene, W, W)
    t.new_scene()
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        t.begin_trace(scene, gen)
        t.end_trace(None, gen)
    assert calls["n"] == 2, calls["n"]
    assert t.tracer_output.shape == (W, W, 3)
    assert t.backward.rbt_fields is t.forward._fields


def test_hybrid_backward_reads_current_jitter_fields():
    """With the jitter ladder on the forward integrator, each frame's
    backward gather reads the current phase's fields."""
    scene = _scene()
    t = tracers.HybridTracer()
    t.forward.n_bins = 16
    t.forward.rays_to_emit = 256
    t.forward.jitter_bins = True
    t.forward.jitter_phases = 2
    t.gbuffer = rasterize(scene, W, W)
    t.new_scene()
    gen = torch.Generator().manual_seed(0)
    seen = []
    for _ in range(3):
        t.begin_trace(scene, gen)
        t.end_trace(None, gen)
        assert t.backward.rbt_fields is t.forward._fields
        seen.append(t.backward.rbt_fields)
    assert seen[0] is not seen[1] and seen[0] is seen[2]


@pytest.mark.parametrize("mode,field,expect", [
    (Mode.REALTIME, None, 4), (Mode.REFERENCE, None, 1), (Mode.REALTIME, 3, 3)])
def test_simulation_builds_hybrid_tracers(mode, field, expect):
    """Simulation builds HybridTracer as the JAX package does: refresh 4 in
    REALTIME and 1 otherwise unless forward_refresh_interval is set; the
    backward integrator takes the simulation's integration interval; both
    outputs are the backward accumulation; no early radiance is read
    without an importance-map consumer."""
    s = Simulation(width=W, height=W, device="cpu", strategy=Strategy.HYBRID, mode=mode,
                   rays_per_frame=512, integration_interval=0.15,
                   forward_refresh_interval=field, frame_limit=1, measurement_interval=0)
    s.set_scene(_scene())
    _small_bins(s)
    s.step()
    for t in s._tracers:
        assert isinstance(t, tracers.HybridTracer)
        assert t.forward_refresh_interval == expect
        assert t.backward.integration_interval == 0.15
        assert not t.forward.finalize_outscatter
        assert t.display_output is t.tracer_output or torch.equal(t.display_output,
                                                                  t.tracer_output)
        assert t.backward.frame_count == 1
    assert s.importance_map is None
    out = s.display_hdr
    assert out.shape == (W, W, 3) and bool(torch.isfinite(out).all())


def test_paired_engine_refuses_hybrid():
    s = Simulation(width=W, height=W, device="cpu", strategy=Strategy.HYBRID,
                   engine="rbt-paired", frame_limit=1)
    s.set_scene(_scene())
    with pytest.raises(ValueError, match="LIGHT_TRANSPORT"):
        s.step()


def test_hybrid_importance_map_reads_early_radiance_once(monkeypatch):
    """With a consumer attached, the importance map is made from each
    tracer's early radiance (its forward output) on the 1/10/100 schedule.
    Each is read once, and the backward gather's forward HDR of the same
    frame reuses that resolve: one resolve a tracer in all."""
    s = Simulation(width=W, height=W, device="cpu", strategy=Strategy.HYBRID,
                   mode=Mode.REFERENCE, rays_per_frame=256, frame_limit=1,
                   measurement_interval=0, forward_refresh_interval=4)
    s.set_scene(_scene())
    _small_bins(s)
    s.wants_importance_map = True
    calls = {"n": 0}
    real = tracers.resolve_raw

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tracers, "resolve_raw", counting)
    s.step()
    assert calls["n"] == 2, calls["n"]
    assert s.importance_map is not None and len(s.importance_map) == 4
