"""Port parity for the samplers the backward gather and the guided sampling
read: litbox_tpu_torch's LUT samplers, gather_2d, scatter_mie,
scatter_importance_lobed, scatter_importance_guided and the GBuffer's
transmissibility pyramid against the JAX package on the same inputs, drawn
with numpy from a seed, on the CPU.

All are deterministic given their uniforms, so they are held elementwise:
the LUT samplers and the scatter directions to 1e-6 relative, the guided
sampler to 1e-6 relative on the JAX package's cumulative sums and to 1e-4
of its maximum on its own (its picks may then differ in at most 1 sample in
1,000), the pyramid's
levels to 1e-5 of their maximum and its quadtree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.core import luts as jluts
from litbox_tpu.core import sampling as jsampling
from litbox_tpu.core.types import GBuffer as JaxGBuffer
from litbox_tpu.post.tracer_post import importance_pyramid as jax_importance_pyramid
from litbox_tpu.scene import build_pyramid as jax_build_pyramid
from litbox_tpu.sim import materials as jmaterials
from litbox_tpu_torch.core import luts, sampling
from litbox_tpu_torch.core.types import GBuffer
from litbox_tpu_torch.post.tracer_post import importance_pyramid
from litbox_tpu_torch.scene import build_pyramid
from litbox_tpu_torch.sim import materials

RTOL = 1e-6  # float32 rounding of the same arithmetic
N = 4096


def _uniforms(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("table", ["mie", "teardrop"])
def test_lut_samplers_match_jax(table):
    """sample_lut and sample_lut_mxu on the same uniforms (the ends and the
    clamp beyond them included), 1e-6 relative."""
    lut = (jluts.mie_scattering_lut() if table == "mie"
           else jluts.teardrop_scattering_lut(3.0))
    np.testing.assert_array_equal(lut, luts.mie_scattering_lut() if table == "mie"
                                  else luts.teardrop_scattering_lut(3.0))
    u = np.concatenate([_uniforms(1, (N,)), np.float32([0.0, 1.0, -0.1, 1.1])])
    ref = jax.jit(jsampling.sample_lut)(jnp.asarray(lut), jnp.asarray(u))
    ref_mxu = jax.jit(jsampling.sample_lut_mxu)(jnp.asarray(lut), jnp.asarray(u))
    t, tu = torch.from_numpy(lut), torch.from_numpy(u)
    _close(sampling.sample_lut(t, tu), ref)
    _close(sampling.sample_lut_mxu(t, tu), ref_mxu)


def test_gather_2d_matches_jax():
    """Clamped integer gather, indices past every edge: exact."""
    rng = np.random.default_rng(2)
    field = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    ix = rng.integers(-5, 45, (512,)).astype(np.int32)
    iy = rng.integers(-5, 30, (512,)).astype(np.int32)
    ref = jsampling.gather_2d(jnp.asarray(field), jnp.asarray(ix), jnp.asarray(iy))
    got = sampling.gather_2d(torch.from_numpy(field), torch.from_numpy(ix),
                             torch.from_numpy(iy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scatter_mie_matches_jax():
    """The Mie rotation with its (y, -x) perpendicular, 1e-6 relative."""
    lut = luts.mie_scattering_lut()
    theta = _uniforms(3, (N,)) * 2 * np.pi
    incoming = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    u = _uniforms(4, (N,))
    ref = jax.jit(jmaterials.scatter_mie)(jnp.asarray(lut), jnp.asarray(incoming),
                                         jnp.asarray(u))
    got = materials.scatter_mie(torch.from_numpy(lut), torch.from_numpy(incoming),
                                torch.from_numpy(u))
    _close(got, ref)


def test_scatter_importance_lobed_matches_jax():
    """The teardrop lobe toward a target: direction and inverse-density
    weight, 1e-6 relative (an origin on the target included)."""
    lut = luts.teardrop_scattering_lut(3.0)
    origin = (_uniforms(5, (N, 2)) * 64).astype(np.float32)
    origin[0] = (32.0, 32.0)
    target = np.float32([32.0, 32.0])
    u = _uniforms(6, (N,))
    rd, rw = jax.jit(jmaterials.scatter_importance_lobed)(
        jnp.asarray(lut), jnp.asarray(origin), jnp.asarray(target), jnp.asarray(u))
    gd, gw = materials.scatter_importance_lobed(
        torch.from_numpy(lut), torch.from_numpy(origin), torch.from_numpy(target),
        torch.from_numpy(u))
    _close(gd, rd)
    _close(gw, rw)


@pytest.mark.parametrize("cdf", ["jax", "torch"])
def test_scatter_importance_guided_matches_jax(monkeypatch, cdf):
    """The guided sampler's categorical descent on the same pyramid and
    uniforms (tests/test_importance_guided.py's two blobs on a dim floor).

    The two packages' float32 cumulative sums of the coarsest level round
    differently (jnp.cumsum is not a sequential sum on the CPU), and each
    level's selector rescale divides by a cell's share, which magnifies
    that rounding. With the port's `torch.cumsum` fed the JAX sums
    ("jax"), every offset and weight agrees to 1e-6 relative. With its own
    ("torch"), a selector within that rounding of a cell edge may descend
    into the neighbouring cell: at most 1 in 1,000 picks may differ, and
    the other samples agree to 1e-4 of the largest offset and weight."""
    w = 64
    rng = np.random.default_rng(7)
    radiance = rng.uniform(0.0, 0.05, (w, w, 3)).astype(np.float32)
    radiance[8:16, 40:56] += 4.0
    radiance[40:56, 8:16] += 1.0
    jpyr = jax_importance_pyramid(jnp.asarray(radiance), jnp.asarray(radiance))
    pyr = importance_pyramid(torch.from_numpy(radiance), torch.from_numpy(radiance))
    for a, b in zip(pyr, jpyr):
        _close(a, b, 1e-6)
    pyr = tuple(torch.from_numpy(np.array(level)) for level in jpyr)
    if cdf == "jax":
        jax_cumsum = jax.jit(jnp.cumsum)
        monkeypatch.setattr(torch, "cumsum", lambda x, dim: torch.from_numpy(
            np.array(jax_cumsum(jnp.asarray(x.numpy())))))

    rand2 = _uniforms(8, (N, 2))
    origin = np.tile(np.float32([[0.5, 0.5]]), (N, 1))
    ro, rw = jax.jit(jmaterials.scatter_importance_guided)(
        jpyr, jnp.asarray(origin), jnp.asarray(rand2))
    go, gw = materials.scatter_importance_guided(pyr, torch.from_numpy(origin),
                                                 torch.from_numpy(rand2))
    ro, rw, go, gw = np.asarray(ro), np.asarray(rw), go.numpy(), gw.numpy()
    if cdf == "jax":
        np.testing.assert_allclose(go, ro, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(gw, rw, rtol=RTOL, atol=RTOL * np.abs(rw).max())
        return
    # Another pick moves a sample by a cell (1/32 of the frame), or reaches
    # the same edge from the other side with another weight.
    same = (np.abs(go - ro) < 1e-3).all(-1) & (np.abs(gw - rw) < 1e-3 * np.abs(rw).max())
    assert (~same).sum() <= N // 1000, int((~same).sum())
    np.testing.assert_allclose(go[same], ro[same], rtol=0, atol=1e-4 * np.abs(ro).max())
    np.testing.assert_allclose(gw[same], rw[same], rtol=0, atol=1e-4 * np.abs(rw).max())


def test_build_pyramid_matches_jax():
    """Every level of the transmissibility pyramid to 1e-5 of its maximum
    and the quadtree's leaf lods exactly, on a smoothed random field with
    flat regions (so that leaves form at several levels)."""
    rng = np.random.default_rng(9)
    h, w = 48, 64
    trans = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
    for _ in range(3):
        trans = (np.roll(trans, 1, 0) + np.roll(trans, -1, 0) + np.roll(trans, 1, 1)
                 + np.roll(trans, -1, 1) + trans) / 5.0
    trans[:, :24] = 1.0
    trans[32:, 40:] = 0.5
    albedo = np.ones((h, w, 4), np.float32)
    normal = np.zeros((h, w, 4), np.float32)
    ref = jax_build_pyramid(JaxGBuffer(albedo=jnp.asarray(albedo),
                                       transmissibility=jnp.asarray(trans),
                                       normal=jnp.asarray(normal)))
    got = build_pyramid(GBuffer(albedo=torch.from_numpy(albedo),
                                transmissibility=torch.from_numpy(trans),
                                normal=torch.from_numpy(normal)))
    assert len(got.levels) == len(ref.levels)
    for a, b in zip(got.levels, ref.levels):
        assert a.shape == b.shape
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_array_equal(got.quadtree.numpy(), np.asarray(ref.quadtree))
    assert len(np.unique(got.quadtree.numpy())) > 1
