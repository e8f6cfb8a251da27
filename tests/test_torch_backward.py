"""Port parity for the backward gather (litbox_tpu_torch/sim/backward.py
against the JAX package's sim/backward.py) at 32x32 on the CPU.

backward_gather_rbt is deterministic: it is held elementwise to the JAX
function run undecorated with its bilinear gathers in float32 (the JAX
default rounds the gathered radiance and the per-pixel result to bf16), and
to the jitted bf16 default at a bf16 tolerance. The faithful march draws from
torch's generator where the JAX package draws from threefry, so it is held
in distribution: exact zeros, its mean over frames within 4 sigma of the JAX
march's, and the RBT ladder's mass within 10% (tests/test_backward.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rbt import _to_port

import litbox_tpu.sim.backward as jbackward
from litbox_tpu.core import luts as jluts
from litbox_tpu.ops.resample import gather_bilinear_mxu
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu_torch.core import luts
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt
from litbox_tpu_torch.sim.backward import (backward_bin_for_frame, backward_gather,
                                           backward_gather_rbt)

W = 32
TEARDROP = torch.from_numpy(luts.teardrop_scattering_lut(3.0))
INTERVAL = 3.2
FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(builder_cls, log_density=-1.0, medium=True):
    """tests/test_backward.py's scene: a point light in a uniform medium."""
    b = builder_cls()
    b.add_point_light((W / 2, W / 2), radius=1.0)
    if medium:
        b.add_rect((W / 2, W / 2), (W, W), color=(0.8, 0.8, 0.8, 1), log_density=log_density)
    return b


def _gb(log_density=-1.0, medium=True):
    scene = _build(SceneBuilder, log_density, medium).build(max_lights=1, max_shapes=1,
                                                            device="cpu")
    return rasterize(scene, W, W)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX GBuffer and 16-bin fields of the scene, the port's copies of
    both, and a radiance field drawn with numpy."""
    gb = jax_rasterize(_build(JaxSceneBuilder, -0.7).build(max_lights=1, max_shapes=1), W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=16)
    hdr = np.random.default_rng(1).uniform(0.0, 2.0, (W, W, 3)).astype(np.float32)
    return gb, fields, hdr, _to_port(gb), _to_port(fields)


def test_bin_ladder_matches_jax():
    """The coprime-stride ladder equals the JAX package's for every n in
    1..400 (329 = 7 * 47 among them) and visits every bin once a cycle."""
    for n in range(1, 401):
        ladder = [backward_bin_for_frame(f, n) for f in range(n)]
        assert ladder == [jbackward.backward_bin_for_frame(f, n) for f in range(n)], n
        assert sorted(ladder) == list(range(n)), n


@pytest.mark.parametrize("block,bin_index", [(32, 5), (64, 11)])
def test_gather_rbt_matches_jax_f32(monkeypatch, jax_case, block, bin_index):
    """backward_gather_rbt against the undecorated JAX function with its
    gathers in float32, on the same fields and radiance: 1e-5 of the
    maximum, at two block sizes (which move pairs between the within-block
    and the cross-block products)."""
    gb, fields, hdr, pgb, pfields = jax_case
    monkeypatch.setattr(jbackward, "gather_bilinear_mxu",
                        functools.partial(gather_bilinear_mxu, precision="f32"))
    ref = np.asarray(jbackward.backward_gather_rbt.__wrapped__(
        fields, gb, jnp.asarray(hdr), jnp.int32(bin_index), block=block))
    got = backward_gather_rbt(pfields, pgb, torch.from_numpy(hdr), bin_index,
                              block=block).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gather_rbt_block_invariance(jax_case):
    """The block rebasing is exact: blocks of 128, 64, 32 and 16 give the
    same field to 1e-5 of its maximum."""
    _, _, hdr, pgb, pfields = jax_case
    outs = [backward_gather_rbt(pfields, pgb, torch.from_numpy(hdr), 5, block=b).numpy()
            for b in (128, 64, 32, 16)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=0, atol=1e-5 * np.abs(outs[0]).max())


def test_gather_rbt_matches_jax_bf16_default(jax_case):
    """Against the jitted JAX default (bf16 gathers): the port is float32,
    so the two differ by bf16 rounding of the gathered radiance and of the
    per-pixel result, each a relative 2^-8; held to 1% of the maximum and
    0.5% of the mean in mean absolute difference."""
    gb, fields, hdr, pgb, pfields = jax_case
    ref = np.asarray(jbackward.backward_gather_rbt(fields, gb, jnp.asarray(hdr),
                                                   jnp.int32(7)))
    got = backward_gather_rbt(pfields, pgb, torch.from_numpy(hdr), 7).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert np.abs(got - ref).mean() < 5e-3 * np.abs(ref).mean()


def test_gather_rbt_zero_radiance_gives_zero():
    gb = _gb()
    fields = rbt.precompute_rotated_fields(gb, n_bins=16)
    out = backward_gather_rbt(fields, gb, torch.zeros((W, W, 3)), 3)
    assert float(out.abs().max()) == 0.0


def test_march_zero_radiance_and_vacuum_give_zero():
    """Zero radiance gathers nothing; in vacuum the outscatter (1 - T) masks
    every pixel, whatever the radiance."""
    gen = torch.Generator().manual_seed(0)
    out = backward_gather(_gb(), torch.zeros((W, W, 3)), TEARDROP, gen, INTERVAL)
    assert float(out.abs().max()) == 0.0
    out = backward_gather(_gb(medium=False), torch.ones((W, W, 3)), TEARDROP, gen, INTERVAL)
    assert float(out.abs().max()) == 0.0


def test_march_matches_jax_in_distribution(jax_case):
    """The faithful march's mean over FRAMES frames against the JAX march's
    on the same GBuffer and radiance: the frame totals' means, and those of
    each quadrant, within 4 sigma of their difference (each side's spread
    over frames); per pixel, the squared difference of the means over its
    variance averages between 0.7 and 1.5."""
    gb, _, hdr, pgb, _ = jax_case
    jmarch = jax.jit(jbackward.backward_gather)
    teardrop = jnp.asarray(jluts.teardrop_scattering_lut(3.0))
    ref = np.stack([np.asarray(jmarch(gb, jnp.asarray(hdr), teardrop, jax.random.key(f),
                                      INTERVAL)) for f in range(FRAMES)])
    gen = torch.Generator().manual_seed(0)
    got = np.stack([backward_gather(pgb, torch.from_numpy(hdr), TEARDROP, gen,
                                    INTERVAL).numpy() for _ in range(FRAMES)])
    h = W // 2
    regions = [(slice(None), slice(None))] + [(slice(y, y + h), slice(x, x + h))
                                              for y in (0, h) for x in (0, h)]
    for ys, xs in regions:
        a = got[:, ys, xs].sum((1, 2, 3))
        b = ref[:, ys, xs].sum((1, 2, 3))
        sigma = np.sqrt(a.var(ddof=1) / FRAMES + b.var(ddof=1) / FRAMES)
        assert abs(a.mean() - b.mean()) < 4 * sigma, (a.mean(), b.mean(), sigma)
    # Per pixel: the squared difference of the means over its variance
    # averages about 1 when both sample one distribution.
    var = got.var(0, ddof=1) / FRAMES + ref.var(0, ddof=1) / FRAMES
    lit = var > 0
    z2 = ((got.mean(0) - ref.mean(0)) ** 2)[lit] / var[lit]
    assert 0.7 < z2.mean() < 1.5, z2.mean()


def test_rbt_ladder_matches_march():
    """tests/test_backward.py's check on the port: a full ladder cycle of
    the RBT gather (64 bins) against 96 frames of the march, interiors: mass
    within 10%, median relative difference under 15%."""
    gb = _gb(log_density=-1.0)
    hdr = torch.from_numpy(np.random.default_rng(0).uniform(0.2, 1.0, (W, W, 3))
                           .astype(np.float32))
    fields = rbt.precompute_rotated_fields(gb, n_bins=64)
    d = fields.n_bins
    a = sum(backward_gather_rbt(fields, gb, hdr, backward_bin_for_frame(f, d))
            for f in range(d)).numpy() / d
    gen = torch.Generator().manual_seed(100)
    frames = 96
    o = sum(backward_gather(gb, hdr, TEARDROP, gen, INTERVAL)
            for _ in range(frames)).numpy() / frames
    ai, oi = a[6:-6, 6:-6], o[6:-6, 6:-6]
    assert abs(ai.sum() / oi.sum() - 1) < 0.1, (ai.sum(), oi.sum())
    rel = np.abs(ai - oi) / (oi + 1e-3)
    assert np.median(rel) < 0.15, float(np.median(rel))
