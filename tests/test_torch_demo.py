"""Port parity for the Abduction demo and the testbeds: litbox_tpu_torch.demo
against the JAX package on the CPU. The game is pure Python and held state
for state; the scenes array for array; a frame's composition on the same
HDR and transmissibility. Also: the slice's modules import without JAX and
without the JAX package."""

import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_data import TEXTURE_ATOL, _one_torch_thread, assert_scene_close  # noqa: F401

from litbox_tpu.demo import abduction as jabduction
from litbox_tpu.demo import game as jgame
from litbox_tpu.demo import testbeds as jtestbeds
from litbox_tpu_torch.demo import abduction, game, testbeds

# The frame's composition: elementwise float32 in the same order, with the
# relight's exp/pow and the Uchimura tone map's exp an ulp or so apart.
FRAME_ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _script(mod) -> list:
    """play_sequence's canonical 20 inputs, preceded by a step at the title
    (no intent: the game stays there) and with a pause of 3 steps (the
    inputs between are ignored) in the middle."""
    gi = mod.GameInput
    canonical = ([gi(move_x=1.0)] * 6 + [gi(tractor=True)] * 8
                 + [gi(move_x=-0.6, tractor=True)] * 6)
    return ([gi()] + canonical[:10] + [gi(pause=True), gi(move_x=1.0), gi(pause=True)]
            + canonical[10:])


def test_game_matches_jax_at_every_step():
    """The same script through both packages' AbductionGame: scene_params
    equal at every step, through a pause, a title transition and back to
    playing."""
    ours, ref = game.AbductionGame(), jgame.AbductionGame()
    states = []
    for inp, jinp in zip(_script(game), _script(jgame)):
        ours.step(0.25, inp)
        ref.step(0.25, jinp)
        assert ours.scene_params() == ref.scene_params()
        states.append(ours.scene_params()["state"])
    assert states[0] == "title" and "paused" in states and states[-1] == "playing"
    for g, mod in ((ours, game), (ref, jgame)):
        g.step(0.25, mod.GameInput(pause=True))
        g.fsm.transition(mod.GameStates.TITLE)
    assert ours.scene_params() == ref.scene_params()
    ours.step(0.25, game.GameInput(move_y=1.0))
    ref.step(0.25, jgame.GameInput(move_y=1.0))
    assert ours.scene_params() == ref.scene_params()
    assert ours.scene_params()["state"] == "playing" and ours.score == ref.score


@pytest.mark.parametrize("name", sorted(testbeds.ALL_TESTBEDS))
def test_testbeds_match_jax(name):
    """Every testbed's scene arrays; the procedural one's three substrates
    at 256 to TEXTURE_ATOL (tests/test_torch_data.py)."""
    w = 64
    got = testbeds.ALL_TESTBEDS[name](w, device="cpu")
    want = jtestbeds.ALL_TESTBEDS[name](w)
    assert_scene_close(got, want, TEXTURE_ATOL if name == "procedural" else 0.0)


def test_demo_scenes_match_jax():
    """build_demo_scene at two times and build_game_scene at two game
    states (beam off and on, a target captured): every array, the noise
    textures included, equal to the JAX package's."""
    w = 96
    for t in (0.0, 1.5):
        assert_scene_close(abduction.build_demo_scene(w, t, device="cpu"),
                           jabduction.build_demo_scene(w, t), 0.0)
    g = game.AbductionGame()
    for inp in [game.GameInput(move_x=1.0)] * 3 + [game.GameInput(tractor=True)] * 6:
        g.step(0.25, inp)
        params = g.scene_params()
        assert_scene_close(abduction.build_game_scene(w, params, device="cpu"),
                           jabduction.build_game_scene(w, params), 0.0)
    assert params["beam_on"]


def test_render_frame_matches_jax():
    """render_frame on one HDR and transmissibility fed to both packages
    through a stand-in with simulation_output_hdr and gbuffer."""
    rng = np.random.default_rng(3)
    hdr = rng.uniform(0, 12, (40, 40, 3)).astype(np.float32)
    trans = rng.uniform(0.3, 1.0, (40, 40)).astype(np.float32)
    backdrop = jabduction._star_backdrop(40, 40)
    np.testing.assert_array_equal(abduction._star_backdrop(40, 40), backdrop)

    def stand_in(x):
        return types.SimpleNamespace(simulation_output_hdr=x(hdr),
                                     gbuffer=types.SimpleNamespace(transmissibility=x(trans)))

    got = abduction.render_frame(stand_in(torch.from_numpy), backdrop)
    want = np.asarray(jabduction.render_frame(stand_in(jnp.asarray), backdrop))
    assert isinstance(got, np.ndarray) and got.shape == (40, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL)


def _pngs(paths, w):
    for p in paths:
        img = np.asarray(Image.open(p))
        assert img.shape == (w, w, 3) and img.dtype == np.uint8
    return len(paths)


def test_render_and_play_sequences_on_the_cpu(tmp_path, monkeypatch):
    """render_sequence and play_sequence at width 32, two steps each:
    finite PNGs, and play_sequence's state that of the same inputs on an
    AbductionGame alone."""
    w = 32
    steps = []

    class Counting(abduction.Simulation):
        def step(self):
            steps.append(self.iterations_since_clear)
            super().step()

    monkeypatch.setattr(abduction, "Simulation", Counting)
    assert _pngs(abduction.render_sequence(str(tmp_path / "seq"), n_frames=2, width=w,
                                           rays=4096, sim_frames=2, device="cpu"), w) == 2
    # Only the first frame is simulated, as in the JAX package: run() finds
    # the count at the frame limit before step() would reset it (ROADMAP C7).
    assert steps == [0, 1]
    inputs = [game.GameInput(move_x=1.0), game.GameInput(tractor=True)]
    out = abduction.play_sequence(str(tmp_path / "play"), inputs=inputs, width=w, rays=4096,
                                  device="cpu")
    assert _pngs(out.pop("frames"), w) == 2
    alone = game.AbductionGame()
    for inp in inputs:
        alone.step(0.25, inp)
    assert out == alone.scene_params()


def test_demo_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        abduction.render_sequence(str(tmp_path), n_frames=1, width=32)


def test_slice_imports_without_jax():
    """The slice's modules import in a process where `jax` and
    `litbox_tpu` cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['litbox_tpu'] = None\n"
            "import litbox_tpu_torch.data, litbox_tpu_torch.diag.picker\n"
            "import litbox_tpu_torch.demo.abduction, litbox_tpu_torch.post.cloud_relight\n"
            "import litbox_tpu_torch.demo.testbeds, litbox_tpu_torch.data.sessions\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
