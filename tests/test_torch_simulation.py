"""Port parity for the user's entry point: litbox_tpu_torch's Simulation with
its tracers, tracer post-processing, camera binding, perf text and
AIAccelerator, against the JAX package on the CPU at 48x48.

tests/test_engine.py's flows run on the port (test_torch_simulation_jax.py
holds its output against the JAX package's Simulation in distribution); the
post-processing, the camera binding, the perf text and the denoiser
host are deterministic and held elementwise, the denoiser on the same
tracer outputs with the Flax weights carried by convert.unet_from_flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _flax_variables

from litbox_tpu.engine import Mode as JaxMode
from litbox_tpu.engine import Simulation as JaxSimulation
from litbox_tpu.engine import camera as jcamera
from litbox_tpu.engine import perf as jperf
from litbox_tpu.engine import pipeline as jpipeline
from litbox_tpu.nn import unet as junet
from litbox_tpu.post import tracer_post as jpost
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu_torch.convert import unet_from_flax
from litbox_tpu_torch.core.types import SimulationProfile
from litbox_tpu_torch.engine import Mode, Simulation, Strategy, camera, perf, pipeline
from litbox_tpu_torch.post import tracer_post
from litbox_tpu_torch.scene import SceneBuilder
from litbox_tpu_torch.sim import tracers

W = 48
SIZE, FEATURES = 2, 4  # the small mono UNet of the denoiser tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(builder_cls):
    """tests/test_engine.py's scene: a point light in a medium with a denser
    ellipse."""
    b = builder_cls()
    b.add_point_light((W / 2, W / 2), radius=1.5, color=(1, 0.9, 0.8), intensity=1.5,
                      bounces=2)
    b.add_rect((W / 2, W / 2), (W, W), color=(1, 1, 1, 1), log_density=-1.2)
    b.add_ellipse((W * 0.7, W * 0.3), (6, 6), color=(0.9, 0.4, 0.4, 1), log_density=-0.4)
    return b


def _scene():
    return _build(SceneBuilder).build(max_lights=2, max_shapes=4, device="cpu")


def _sim(**kw):
    return Simulation(width=W, height=W, device="cpu", **kw)


@pytest.fixture(scope="module")
def sim():
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=2048, integration_interval=0.1,
             measurement_interval=2)
    s.set_scene(_scene())
    return s


def test_reference_mode_accumulates(sim):
    sim.frame_limit = 4
    events = []
    sim.on_step.append(events.append)
    sim.on_converged.append(lambda: events.append("converged"))
    sim.run(max_frames=10)
    assert events[:4] == [1, 2, 3, 4]
    assert events[-1] == "converged"
    assert sim.has_converged
    out = sim.simulation_output_hdr
    assert out.shape == (W, W, 3) and out.device.type == "cpu"
    assert float(out.sum()) > 0 and bool(torch.isfinite(out).all())
    assert sim.variance_map.shape == (W // 4, W // 4)


def test_variance_decreases_with_accumulation():
    """The pair's relative temporal variance falls roughly as 1/N: measured
    at frames 2, 4 and 6 (frame 8 reaches the limit, and a converged run
    measures no more), the last is under half the first."""
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=2048, measurement_interval=2,
             frame_limit=8, seed=3)
    s.set_scene(_scene())
    xis = []
    s.on_convergence_update.append(xis.append)
    s.run(max_frames=8)
    assert len(xis) == 3 and xis[-1] < xis[0] * 0.5, xis


def test_profile_and_invalidation(sim):
    sim.load_profile(SimulationProfile(frame_limit=2, rays_per_frame=1024,
                                       integration_interval=0.2, photon_bounces=1))
    sim.run(max_frames=3)
    assert sim.iterations_since_clear == 2
    assert sim.has_converged
    assert sim.tracer_a.forward.max_bounces == 1  # the profile's override
    sim.invalidate()
    sim.step()
    assert sim.iterations_since_clear == 1


def test_light_move_keeps_gbuffer_and_fields():
    """Moving a light resets accumulation but reuses the GBuffer and the
    rotated-field precompute; an equal scene changes nothing."""
    def scene_with_light(x):
        b = SceneBuilder()
        b.add_point_light((x, W / 2), radius=1.5, bounces=2)
        b.add_rect((W / 2, W / 2), (W, W), color=(1, 1, 1, 1), log_density=-1.2)
        return b.build(max_lights=2, max_shapes=2, device="cpu")

    s = _sim(mode=Mode.REFERENCE, rays_per_frame=512, frame_limit=2)
    s.set_scene(scene_with_light(W / 3))
    s.step()
    gb = s.gbuffer
    fields = s.tracer_a.forward._fields
    assert fields is not None

    s.set_scene(scene_with_light(2 * W / 3))
    assert s.iterations_since_clear == 1
    s.step()
    assert s.iterations_since_clear == 1
    assert s.gbuffer is gb
    assert s.tracer_a.forward._fields is fields

    s.set_scene(scene_with_light(2 * W / 3))  # equal scene: a no-op
    s.step()
    assert s.iterations_since_clear == 2


def test_realtime_unchanged_scene_keeps_precompute(monkeypatch):
    """Realtime frames of an unchanged scene reuse the GBuffer, the fields
    and the per-scene specializations (read on the host once a tracer); a
    new scene object derives them again."""
    calls = []
    real = tracers.RBTForwardIntegrator._specialize
    monkeypatch.setattr(tracers.RBTForwardIntegrator, "_specialize",
                        lambda self, *a: (calls.append(1), real(self, *a)))
    s = _sim(mode=Mode.REALTIME, rays_per_frame=512)
    s.set_scene(_scene())
    s.step()
    gb = s.gbuffer
    fields = s.tracer_a.forward._fields
    s.step()
    s.step()
    assert s.gbuffer is gb
    assert s.tracer_a.forward._fields is fields
    assert s.iterations_since_clear == 1  # realtime resets every frame
    assert len(calls) == 2
    s.set_scene(_scene())  # an equal scene, another object
    s.step()
    assert len(calls) == 4 and s.gbuffer is gb


def test_importance_map_is_consumer_driven():
    """Without a consumer no pyramid is made; the on-demand refresh attaches
    one and makes it at once; realtime never schedules it at iteration 0/1
    (Simulation.cs:370), reference mode does, then on 10/100."""
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=512, frame_limit=3)
    s.set_scene(_scene())
    s.step()
    assert s.importance_map is None and not s._should_update_importance_map()
    pyr = s.refresh_importance_map()
    assert s.wants_importance_map and s.importance_map is pyr
    assert pyr[0].shape == (W // 2, W // 2) and pyr[3].shape == (W // 16, W // 16)
    assert all(bool(torch.isfinite(p).all()) for p in pyr)
    schedule = []
    for i in (1, 2, 10, 11, 100, 150, 200):
        s.iterations_since_clear = i
        schedule.append(s._should_update_importance_map())
    assert schedule == [True, False, True, False, True, False, True]

    r = _sim(mode=Mode.REALTIME, rays_per_frame=512)
    r.set_scene(_scene())
    r.wants_importance_map = True
    for _ in range(3):
        r.step()
        assert not r._should_update_importance_map()
    assert r.importance_map is None


def test_rbt_paired_engine_matches_rbt():
    """engine='rbt-paired' is the same dual-tracer estimator as 'rbt':
    bright-region means within 10%, independent tracers, a live variance
    map, and per-tracer photon counts in the unpaired units."""
    def build(engine):
        b = SceneBuilder()
        b.add_point_light((W / 2, W / 2), radius=1.0, intensity=1.5, bounces=2)
        b.add_rect((W / 2, W / 2), (W, W), log_density=-1.2)
        s = _sim(mode=Mode.REFERENCE, rays_per_frame=2048, engine=engine,
                 measurement_interval=0, frame_limit=4, seed=3)
        s.set_scene(b.build(max_lights=1, max_shapes=1, device="cpu"))
        s.run(max_frames=4)
        return s

    paired = build("rbt-paired")
    plain = build("rbt")
    a = paired.tracer_a.tracer_output.numpy()
    b_ = paired.tracer_b.tracer_output.numpy()
    ref = plain.simulation_output_hdr.numpy()
    assert np.abs(a - b_).max() > 0
    mask = ref > np.percentile(ref, 90)
    np.testing.assert_allclose(((a + b_) / 2)[mask].mean(), ref[mask].mean(), rtol=0.1)
    v = paired.variance_map
    assert bool(torch.isfinite(v).all()) and float(v.max()) > 0
    paired.update_performance_metrics()
    assert sum(t.forward_photon_count for t in paired._tracers) == 2 * 4 * 2048


def test_rbt_paired_rejects_hybrid():
    s = Simulation(width=32, height=32, strategy=Strategy.HYBRID, engine="rbt-paired",
                   device="cpu")
    b = SceneBuilder()
    b.add_point_light((16, 16), radius=1.0, intensity=1.0)
    s.set_scene(b.build(max_lights=1, max_shapes=1, device="cpu"))
    with pytest.raises(ValueError):
        s.step()


def test_tracer_post_matches_jax():
    """compute_cv_and_mips (with two further mips), importance_pyramid and
    measure_convergence elementwise on the same arrays (rtol 1e-6)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 2, (40, 56, 3)).astype(np.float32)
    b = rng.uniform(0, 2, (40, 56, 3)).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    got = tracer_post.compute_cv_and_mips(ta, tb, mip_count=3)
    ref = jpost.compute_cv_and_mips(ja, jb, mip_count=3)
    for g, r in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    for g, r in zip(tracer_post.importance_pyramid(ta, tb), jpost.importance_pyramid(ja, jb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    np.testing.assert_allclose(float(tracer_post.measure_convergence(got[1])),
                               float(jpost.measure_convergence(ref[1])), rtol=1e-6)


def test_camera_and_perf_text_match_jax():
    """CameraBinding's size, UV transform and apply, and format_perf_text in
    both modes, equal to the JAX package's."""
    for args in ((1920, 1080), (1280, 720, 0.5, 10.0), (7, 3, 0.1)):
        got, ref = camera.CameraBinding(*args), jcamera.CameraBinding(*args)
        assert got.sim_size == ref.sim_size
        np.testing.assert_array_equal(got.screen_to_sim_uv, ref.screen_to_sim_uv)
    s = _sim()
    camera.CameraBinding(1920, 1080).apply(s)
    assert (s.width, s.height) == (480, 270) and s._dirty
    for mode, jmode in ((Mode.REFERENCE, JaxMode.REFERENCE),
                        (Mode.REALTIME, JaxMode.REALTIME)):
        ps, js = _sim(mode=mode), JaxSimulation(width=W, height=W, mode=jmode)
        for obj in (ps, js):
            obj.photons_per_second = 12.345e6
            obj.photon_writes_per_second = 6.78e6
            obj.convergence_progress = 0.0123456
        assert perf.format_perf_text(ps) == jperf.format_perf_text(js)


class _Outputs:
    """The part of a Simulation that the JAX package's AIAccelerator reads,
    holding the port's tracer outputs as JAX arrays."""

    def __init__(self, a, b):
        self.on_step = []
        self.tracer_a = type("T", (), {"tracer_output": jnp.asarray(a)})()
        self.tracer_b = type("T", (), {"tracer_output": jnp.asarray(b)})()
        self.simulation_output_hdr = (jnp.asarray(a) + jnp.asarray(b)) * 0.5


@pytest.fixture(scope="module")
def flax_mono():
    model = junet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES)
    return _flax_variables(model, (1, 32, 32, 1), 4)


@pytest.mark.parametrize("blend,tonemap", [("auto", "ue5"), (0.5, "uchimura")])
def test_ai_accelerator_matches_jax(flax_mono, blend, tonemap):
    """AIAccelerator on the port's Simulation against the JAX package's on
    the same tracer outputs, with the Flax weights carried: HDR and tone-
    mapped outputs to 1e-4 of their maximum, and the auto blend's k to
    1e-5; detach stops it."""
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=1024, measurement_interval=0,
             frame_limit=2)
    s.set_scene(_scene())
    acc = pipeline.AIAccelerator(
        s, unet_from_flax(flax_mono, unet_size=SIZE, initial_features=FEATURES),
        unet_size=SIZE, initial_features=FEATURES, blend=blend, tonemap=tonemap)
    s.run()
    ref = jpipeline.AIAccelerator(
        _Outputs(s.tracer_a.tracer_output.numpy(), s.tracer_b.tracer_output.numpy()),
        flax_mono, unet_size=SIZE, initial_features=FEATURES, blend=blend,
        tonemap=tonemap)
    ref._on_step()
    for got, want in ((acc.hdr_output, ref.hdr_output),
                      (acc.tonemapped_output, ref.tonemapped_output)):
        want = np.asarray(want)
        assert got.shape == want.shape == (W, W, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    if blend == "auto":
        np.testing.assert_allclose(float(acc.last_blend), float(ref.last_blend),
                                   rtol=0, atol=1e-5)
    acc.detach()
    assert acc._on_step not in s.on_step


def test_display_reads_no_full_resolve(monkeypatch):
    """With resolve_groups > 1 a display read runs ONE grouped resolve per
    tracer and no full one (the JAX package's display_output also evaluates
    output_hdr, getattr's default, litbox_tpu/sim/tracers.py:671), and the
    realtime jitter ladder with groups gives a finite, non-negative display."""
    calls = []
    real = tracers.resolve_raw

    def counting(*args, **kw):
        calls.append(kw.get("n_groups", 1))
        return real(*args, **kw)

    monkeypatch.setattr(tracers, "resolve_raw", counting)
    s = _sim(mode=Mode.REALTIME, rays_per_frame=1024)
    s.set_scene(_scene())
    s.step()
    for t in s._tracers:
        t.forward.jitter_bins = True
        t.forward.resolve_groups = 16
    for _ in range(3):
        s.step()
        calls.clear()
        hdr = s.display_hdr
        assert calls == [16, 16]
        assert bool(torch.isfinite(hdr).all()) and float(hdr.min()) >= 0
        assert float(hdr.sum()) > 0


def test_collimated_scene_runs():
    """The default exact_collimated on a scene with a laser and a directional
    light: the exact field is precomputed once and added at readout; the
    output is finite, non-negative and brighter than without those lights."""
    b = _build(SceneBuilder)
    b.add_laser_light((6, W * 0.4), (4, 1), rotation=1.9, intensity=1.0, bounces=2)
    b.add_directional_light(rotation=0.6, intensity=0.6, bounces=2)
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=1024, measurement_interval=0,
             frame_limit=2)
    s.set_scene(b.build(max_lights=4, max_shapes=4, device="cpu"))
    out = s.run()
    exact = s.tracer_a.forward._exact_raw
    assert exact is not None and exact.shape == (W, W, 3)
    # Analytic point light, exact collimated lights: no MC direct phase; the
    # bounce chains still emit every kind.
    assert not s.tracer_a.forward._mc_direct
    assert s.tracer_a.forward._light_kinds == (1, 3, 6)
    assert bool(torch.isfinite(out).all()) and float(out.min()) >= 0
    base = _sim(mode=Mode.REFERENCE, rays_per_frame=1024, measurement_interval=0,
                frame_limit=2)
    base.set_scene(_scene())
    assert float(out.sum()) > float(base.run().sum())


def _unported(option):
    s = _sim(mode=Mode.REFERENCE, rays_per_frame=512, frame_limit=1)
    s.set_scene(_scene())
    if option == "from_checkpoint":
        pipeline.AIAccelerator.from_checkpoint(s, "model_best.npz")
    else:
        pipeline.AIAccelerator(s, {}, blend_prior=np.zeros(3))


@pytest.mark.parametrize("option,match", [
    ("from_checkpoint", "nn/train.py"), ("blend_prior", "blend_prior")])
def test_unported_options_raise(option, match):
    with pytest.raises(NotImplementedError, match=match):
        _unported(option)


def test_cpu_scene_refused_on_another_device():
    """A Simulation on another device refuses a CPU scene at set_scene,
    before any work."""
    s = Simulation(width=W, height=W, device="meta")
    with pytest.raises(ValueError, match="device"):
        s.set_scene(_scene())
    assert s._scene is None
