"""Port parity for dataset generation: litbox_tpu_torch.data (noise,
substrates, scene descriptions, TrainingFactory, sessions) against the JAX
package on the CPU, on the same numpy inputs and seeds.

The JAX substrate compiles once per static configuration (size, has_noise,
octave range; 5-9 s each on the CPU), so the texture tests hold four
configurations. The JAX TrainingFactory's own end-to-end run is a slow test
(tests/test_data_factory.py), so the factory's flags are held against the
JAX factory's code path driven with a stand-in Simulation."""

import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.data import factory as jfactory
from litbox_tpu.data import noise as jnoise
from litbox_tpu.data import sessions as jsessions
from litbox_tpu.data import substrate as jsubstrate
from litbox_tpu_torch.core.types import SimulationProfile
from litbox_tpu_torch.data import factory, noise, sessions, substrate
from litbox_tpu_torch.engine import Mode, Simulation
from litbox_tpu_torch.io import read_exr_rgb, write_exr_rgb

# XLA's jit contracts the noise's multiply-adds, which moves it by a few
# ulps of values in [-1, 1]; eager JAX runs op by op and agrees bit for bit.
SNOISE_JIT_ATOL = 1e-6
# Substrates: the affines and the gradient are multiply-adds here and XLA
# dots in the JAX version, and pow/sqrt differ by ulps: 1.2e-7 at most at the
# configurations below, 5.8e-6 at seed 5, version 1, 64² (its octaves).
TEXTURE_ATOL = 1e-5
# Shape tests that may flip between the two packages: a texel whose local
# coordinate lies within an ulp of a shape's edge. None flips at these
# configurations; the bound is what the test allows.
FLIP_BOUND = 2
FLIP_EDGE_EPS = 1e-5
SCENE_ATOL = 1e-6
W = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_scene_close(got, want, tex_atol: float = SCENE_ATOL) -> None:
    """Every array of a port Scene against the JAX package's: integer and
    bool arrays equal, floats to SCENE_ATOL, textures to `tex_atol`."""
    for part in ("lights", "shapes"):
        for f in dataclasses.fields(getattr(got, part)):
            g = getattr(getattr(got, part), f.name).cpu().numpy()
            w = np.asarray(getattr(getattr(want, part), f.name))
            assert g.shape == w.shape, (part, f.name)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=SCENE_ATOL, err_msg=f.name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f.name)
    for name in ("textures", "field_textures"):
        g, w = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tex_atol, err_msg=name)


# ----- noise -----

@pytest.mark.parametrize("jit", [False, True])
def test_snoise_matches_jax(jit):
    """snoise on 200,000 points at scales 1 to 70,000: bit for bit against
    eager JAX, within SNOISE_JIT_ATOL of jitted JAX."""
    rng = np.random.default_rng(0)
    fn = jax.jit(jnoise.snoise) if jit else jnoise.snoise
    for scale in (1.0, 10.0, 300.0, 5000.0, 70000.0):
        pts = (rng.uniform(-1, 1, (40000, 2)) * scale).astype(np.float32)
        want = np.asarray(fn(jnp.asarray(pts)))
        got = noise.snoise(torch.from_numpy(pts)).numpy()
        if jit:
            np.testing.assert_allclose(got, want, rtol=0, atol=SNOISE_JIT_ATOL)
        else:
            np.testing.assert_array_equal(got, want)
    got01 = noise.snoise01(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got01, np.asarray(jnoise.snoise01(jnp.asarray(pts))))


# ----- substrates -----

@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("version", [1, 2])
def test_random_params_equal(seed, version):
    a = jsubstrate.generate_random_params(seed, version, 64)
    b = substrate.generate_random_params(seed, version, 64)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "shapes":
            assert len(va) == len(vb)
            for sa, sb in zip(va, vb):
                assert (sa["kind"], sa["inverse"]) == (sb["kind"], sb["inverse"])
                np.testing.assert_array_equal(sa["inv_affine"], sb["inv_affine"])
        else:
            assert va == vb, f.name


@jax.jit
def _jax_inside(kinds, inverse, inv_aff, active, xy):
    """The JAX package's shape test (litbox_tpu/data/substrate.py:139-149)."""
    inside = jnp.zeros(xy.shape[:2], bool)
    for i in range(jsubstrate.MAX_SUBSTRATE_SHAPES):
        local = jnp.einsum("ij,hwj->hwi", inv_aff[i, :, :2], xy) + inv_aff[i, :, 2]
        rect_in = jnp.max(jnp.abs(local), -1) <= 1.0
        ell_in = jnp.sum(local * local, -1) <= 1.0
        s_in = jnp.where(kinds[i] == 1, ell_in, rect_in)
        add = jnp.where(active[i] & ~inverse[i], inside | s_in, inside)
        inside = jnp.where(active[i] & inverse[i], inside & ~s_in, add)
    return inside


def _edge_distance(params, xy: torch.Tensor) -> torch.Tensor:
    """Per texel, how near its local coordinate lies to any shape's edge."""
    near = torch.full(xy.shape[:2], float("inf"))
    for sh in params.shapes:
        m = torch.from_numpy(np.asarray(sh["inv_affine"], np.float32))
        lx = m[0, 0] * xy[..., 0] + m[0, 1] * xy[..., 1] + m[0, 2]
        ly = m[1, 0] * xy[..., 0] + m[1, 1] * xy[..., 1] + m[1, 2]
        r = lx * lx + ly * ly if sh["kind"] == 1 else torch.maximum(lx.abs(), ly.abs())
        near = torch.minimum(near, (r - 1.0).abs())
    return near


def shape_flips(params, device: str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(texels whose shape test differs between the packages, those of them
    that lie on an edge), both (size, size) bool."""
    _, _, xy = substrate._grid(params.texture_size, device)
    got = substrate._inside(params, xy).cpu().numpy()
    want = np.asarray(_jax_inside(*jsubstrate._pack(params), jnp.asarray(xy.cpu().numpy())))
    flips = torch.from_numpy(got != want)
    return flips, flips & (_edge_distance(params, xy.cpu()) < FLIP_EDGE_EPS)


# (seed, version, size): no noise with cutouts and no gradient; noise with
# cutouts and a gradient; no noise, no cutouts, a gradient; noise, no
# cutouts, a gradient at octaves 5..5.
TEXTURE_CASES = [(7, 1, 32), (11, 2, 64), (17, 1, 64), (3, 1, 32)]


def test_texture_cases_cover_the_branches():
    ps = [substrate.generate_random_params(s, v, n) for s, v, n in TEXTURE_CASES]
    assert {p.has_noise for p in ps} == {True, False}
    assert any(any(sh["inverse"] for sh in p.shapes) for p in ps)
    assert any(p.color_a == p.color_b and p.density_a == p.density_b for p in ps)
    assert {p.texture_size for p in ps} == {32, 64}


@pytest.mark.parametrize("seed,version,size", TEXTURE_CASES)
def test_generate_texture_matches_jax(seed, version, size):
    """The texture to TEXTURE_ATOL of the JAX package's, away from texels
    whose shape test flips (at most FLIP_BOUND, each on a shape's edge; the
    comparison skips texels within edge_blur + 2 of one)."""
    p = substrate.generate_random_params(seed, version, size)
    want = np.asarray(jsubstrate.generate_texture(jsubstrate.generate_random_params(
        seed, version, size)))
    got = substrate.generate_texture(p, "cpu").numpy()
    assert got.shape == want.shape == (size, size, 4)
    flips, on_edge = shape_flips(p)
    assert int(flips.sum()) <= FLIP_BOUND and torch.equal(flips, on_edge)
    keep = np.ones((size, size), bool)
    if flips.any():
        ys, xs = np.mgrid[0:size, 0:size]
        for fy, fx in torch.nonzero(flips).tolist():
            keep &= np.hypot(ys - fy, xs - fx) > p.edge_blur + 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=TEXTURE_ATOL)
    _, again = substrate.generate_random(seed, version, size, device="cpu")
    assert torch.equal(again, torch.from_numpy(got))


# ----- scene descriptions -----

def test_scene_descriptions_write_the_same_json():
    ra, rb = np.random.default_rng(123), np.random.default_rng(123)
    for _ in range(20):
        a = json.dumps(jfactory.generate_random_scene_description(ra), indent=2)
        b = json.dumps(factory.generate_random_scene_description(rb), indent=2)
        assert a == b


def _description() -> dict:
    """A drawn description with one substrate seed, held to one of each
    light type the factory draws, so every light branch is built."""
    desc = factory.generate_random_scene_description(np.random.default_rng(4))
    desc["substrateSeedsV2"] = desc["substrateSeedsV2"][:1]
    kinds = {"Point": [1.0, -2.0], "Spot": [3.0, 4.0], "Laser": [-1.0, 2.0]}
    desc["lights"] = [dict(desc["lights"][0], type=t, position=p, angle=40.0,
                           scale=[0.3, 0.1]) for t, p in kinds.items()]
    desc["lights"].append(dict(desc["lights"][0], type="Directional", angle=200.0))
    return desc


def test_build_scene_from_description_matches_jax():
    """Every scene array at substrate size 32 to SCENE_ATOL (the substrate
    texture to TEXTURE_ATOL, as above), and the same exposure."""
    desc = _description()
    want, want_exp = jfactory.build_scene_from_description(desc, W, W, substrate_texture_size=32)
    got, got_exp = factory.build_scene_from_description(desc, W, W, substrate_texture_size=32,
                                                        device="cpu")
    assert got_exp == want_exp
    assert_scene_close(got, want, TEXTURE_ATOL)
    assert int(got.lights.active.sum()) == 4 + (desc["ambientLightIntensity"] > 0)


# ----- TrainingFactory -----

TINY_INPUTS = (SimulationProfile(1, 512, 0.1, 2), SimulationProfile(2, 256, 0.1, 2))
TINY_CONVERGENCE = SimulationProfile(-1, 512, 0.1, 2)
FACTORY = dict(samples_to_generate=1, width=W, height=W, input_profiles=TINY_INPUTS,
               convergence_profile=TINY_CONVERGENCE, convergence_threshold=10.0,
               max_convergence_frames=150, seed=5, substrate_texture_size=32,
               jitter_bins=False)


def _flags(tracers) -> list:
    return [(t.forward.analytic_direct, t.forward.jitter_bins, t.forward.bounce_rays)
            for t in tracers]


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """One port factory run at 32x32 on the CPU, recording at each
    load_profile the profile and the integrators' flags."""
    calls = []

    class Recording(Simulation):
        def load_profile(self, profile):
            calls.append((profile.rays_per_frame, profile.frame_limit, _flags(self._tracers)))
            super().load_profile(profile)

    root = tmp_path_factory.mktemp("factory")
    saved, factory.Simulation = factory.Simulation, Recording
    try:
        fac = factory.TrainingFactory(output_folder=str(root), device="cpu", **FACTORY)
        done = fac.generate(log=lambda _: None)
    finally:
        factory.Simulation = saved
    return fac, done, calls


def _files(path) -> dict:
    return {f: (os.stat(os.path.join(path, f)).st_size, os.stat(os.path.join(path, f)).st_mtime_ns)
            for f in sorted(os.listdir(path))}


def test_factory_writes_the_file_set_and_resumes(made, tmp_path):
    """tests/test_data_factory.py's file set; a resumed factory returns the
    same ids and writes nothing (sizes and mtimes unchanged)."""
    fac, done, _ = made
    assert done == [0]
    files = _files(fac.dataset_path)
    for name in ("Scene_00000.json", "Input0_Radiance_A_00000.exr",
                 "Input0_Radiance_B_00000.exr", "Input1_Radiance_A_00000.exr",
                 "Output_Reference_00000.exr", "Output_Preview_00000.png",
                 "Albedo_00000.png", "Transmissibility_00000.exr"):
        assert name in files, name
    assert sessions.is_complete(fac.dataset_path, 0, len(TINY_INPUTS))
    again = factory.TrainingFactory(
        output_folder=os.path.dirname(fac.dataset_path), device="cpu",
        continue_previous_session=True, **dict(FACTORY, max_convergence_frames=5, seed=6))
    assert again.dataset_path == fac.dataset_path
    assert again.generate(log=lambda _: None) == [0]
    assert _files(fac.dataset_path) == files


def _stand_in(calls: list, host: bool):
    """A Simulation stand-in that records, at each load_profile, the
    profile and the flags a factory set; its outputs are zeros (numpy for
    the JAX factory, tensors for the port's)."""
    zeros = np.zeros if host else torch.zeros
    ones = np.ones if host else torch.ones

    class StandIn:
        def __init__(self, width, height, mode, seed, device=None):
            out = zeros((height, width, 3))
            self._tracers = [types.SimpleNamespace(
                forward=types.SimpleNamespace(analytic_direct=True, jitter_bins=False,
                                              bounce_rays=0), tracer_output=out)
                for _ in range(2)]
            self.tracer_a, self.tracer_b = self._tracers
            self.simulation_output_hdr = out
            self.gbuffer = types.SimpleNamespace(albedo=zeros((height, width, 4)),
                                                 transmissibility=ones((height, width)))
            self.has_converged, self.convergence_progress = False, 0.0

        def set_scene(self, scene):
            pass

        def _validate_tracers(self):
            pass

        def load_profile(self, profile):
            calls.append((profile.rays_per_frame, profile.frame_limit, _flags(self._tracers)))
            self.has_converged = False

        def invalidate(self):
            pass

        def run(self, max_frames=None):
            pass

        @property
        def is_running(self):
            return not self.has_converged

        def step(self):
            self.has_converged = True

    return StandIn


@pytest.mark.parametrize("run", ["real", "stand-in"])
def test_factory_flags_match_the_jax_factory(made, monkeypatch, tmp_path, run):
    """The profiles loaded and the integrator flags (analytic_direct,
    jitter_bins, bounce_rays) set before each, against the JAX factory's
    generate driven with a stand-in Simulation: the port's real run above,
    and the port's factory with the same stand-in at the other settings of
    mc_direct_inputs and jitter_bins."""
    kw = dict(FACTORY)
    if run == "real":
        calls = made[2]
        want = [(False, False, 128), (False, False, 64), (True, False, 128)]
    else:
        kw.update(mc_direct_inputs=False, jitter_bins=True)
        calls = []
        monkeypatch.setattr(factory, "Simulation", _stand_in(calls, host=False))
        monkeypatch.setattr(factory, "build_scene_from_description", lambda *a, **k: (None, 0.0))
        factory.TrainingFactory(output_folder=str(tmp_path / "port"), device="cpu",
                                **kw).generate(log=lambda _: None)
        want = [(True, True, 128), (True, True, 64), (True, True, 128)]
    jax_calls = []
    monkeypatch.setattr(jfactory, "Simulation", _stand_in(jax_calls, host=True))
    monkeypatch.setattr(jfactory, "build_scene_from_description", lambda *a, **k: (None, 0.0))
    (tmp_path / "jax").mkdir()
    jfactory.TrainingFactory(output_folder=str(tmp_path / "jax"), **kw).generate(
        log=lambda _: None)
    assert calls == jax_calls
    assert [c[2][0] for c in calls] == want
    assert all(c[2][0] == c[2][1] for c in calls)


def test_factory_reference_equals_a_run_by_hand(made, tmp_path):
    """The reference EXR equals, bit for bit, a port Simulation run by hand
    with the sample's seed, scene and the factory's sequence of profiles."""
    fac, _, _ = made
    with open(os.path.join(fac.dataset_path, "Scene_00000.json")) as f:
        desc = json.load(f)
    scene, _ = factory.build_scene_from_description(desc, W, W, substrate_texture_size=32,
                                                    device="cpu")
    sim = Simulation(width=W, height=W, mode=Mode.REFERENCE, seed=0, device="cpu")
    sim.set_scene(scene)
    sim._validate_tracers()

    def configure(analytic, rays):
        for t in sim._tracers:
            t.forward.analytic_direct, t.forward.jitter_bins = analytic, False
            t.forward.bounce_rays = rays // 4

    for k, profile in enumerate(TINY_INPUTS):
        configure(False, profile.rays_per_frame)
        sim.load_profile(profile)
        sim.invalidate()
        sim.run(max_frames=profile.frame_limit)
        got = read_exr_rgb(os.path.join(fac.dataset_path, f"Input{k}_Radiance_A_00000.exr"))
        np.testing.assert_array_equal(got, sim.tracer_a.tracer_output.numpy())
    configure(True, TINY_CONVERGENCE.rays_per_frame)
    sim.load_profile(TINY_CONVERGENCE)
    sim.invalidate()
    sim.convergence_threshold, sim.measurement_interval = FACTORY["convergence_threshold"], 100
    frames = 0
    while sim.is_running and frames < FACTORY["max_convergence_frames"]:
        sim.step()
        frames += 1
    assert sim.has_converged and frames == 100
    mine = str(tmp_path / "ref.exr")
    write_exr_rgb(mine, sim.simulation_output_hdr.numpy())
    with open(mine, "rb") as a, open(os.path.join(fac.dataset_path,
                                                  "Output_Reference_00000.exr"), "rb") as b:
        assert a.read() == b.read()


def test_factory_discards_a_scene_that_does_not_converge(tmp_path):
    """An unreachable threshold within 3 frames: the sample's files go,
    discarded.json keeps the id, and a resumed factory skips it."""
    kw = dict(FACTORY, input_profiles=TINY_INPUTS[:1], convergence_threshold=1e-12,
              max_convergence_frames=3)
    fac = factory.TrainingFactory(output_folder=str(tmp_path), device="cpu", **kw)
    logs = []
    assert fac.generate(log=logs.append) == []
    assert any("Discarding scene 00000" in m for m in logs)
    with open(os.path.join(fac.dataset_path, "discarded.json")) as f:
        assert json.load(f) == [0]
    left = [f for f in os.listdir(fac.dataset_path) if f != "discarded.json"]
    assert left == []
    again = factory.TrainingFactory(output_folder=str(tmp_path), device="cpu",
                                    continue_previous_session=True, **kw)
    assert again.generate(log=logs.append) == []
    assert os.listdir(fac.dataset_path) == ["discarded.json"]


def test_factory_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fac = factory.TrainingFactory(output_folder=str(tmp_path), **FACTORY)
    with pytest.raises((RuntimeError, AssertionError)):
        fac.generate(log=lambda _: None)


# ----- sessions -----

def _session_tree(root) -> None:
    """Two sessions: complete samples 0 and 2 and an incomplete 1 in the
    first, a complete 0 and a non-scene file in the second."""
    def sample(d, sid, drop=None):
        names = [f"Scene_{sid:05d}.json", f"Albedo_{sid:05d}.png",
                 f"Transmissibility_{sid:05d}.exr", f"Output_Reference_{sid:05d}.exr",
                 f"Output_Preview_{sid:05d}.png"]
        names += [f"Input{k}_Radiance_{t}_{sid:05d}.exr" for k in range(3) for t in "AB"]
        for n in names:
            if n != drop:
                with open(os.path.join(d, n), "w") as f:
                    f.write(f"{os.path.basename(d)} {n}")

    for name in ("2026-01-01-00-00-00", "2026-01-02-00-00-00"):
        os.makedirs(os.path.join(root, name))
    first, second = (os.path.join(root, n) for n in sorted(os.listdir(root)))
    sample(first, 0)
    sample(first, 1, drop="Input2_Radiance_B_00001.exr")
    sample(first, 2)
    sample(second, 0)
    with open(os.path.join(second, "notes.txt"), "w") as f:
        f.write("x")


def _listing(root) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f)) as h:
                out[os.path.relpath(os.path.join(d, f), root)] = h.read()
    return out


@pytest.mark.parametrize("move", [False, True])
def test_consolidate_sessions_matches_jax(tmp_path, move):
    trees = {}
    for name, mod in (("jax", jsessions), ("port", sessions)):
        root = tmp_path / name
        root.mkdir()
        _session_tree(str(root))
        first = os.path.join(str(root), sorted(os.listdir(root))[0])
        assert [mod.is_complete(first, s, 3) for s in range(3)] == [True, False, True]
        assert mod.list_sample_ids(first) == [0, 1, 2]
        dest = mod.consolidate_sessions(str(root), move=move)
        assert mod.list_sample_ids(dest) == [0, 1, 2]
        trees[name] = _listing(str(root))
        shutil.rmtree(root)
    assert trees["port"] == trees["jax"]
