"""Port parity: litbox_tpu_torch's shear kernels (K2 shear, K3 shear_reduce)
and the planar rotate-and-sum glue against the JAX package's Pallas
versions, which run in interpret mode off the TPU. The Pallas kernels are
exact while |coef| stays within their static coef_bound; the inputs below
keep it there, so the two agree to float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.ops import rotate as jrot
from litbox_tpu_torch.ops import rotate as trot

S, D = 64, 16
ALPHA_BOUND = jrot.ALPHA_BOUND
BETA_BOUND = jrot.BETA_BOUND


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# (rows, width, row_div, elem_scale, coef bound): the x-shear of
# channel-interleaved rows, the y-shear on their transpose, and the planar case.
SHEAR_CASES = [(S, S, 1, 1, ALPHA_BOUND), (S, 3 * S, 1, 3, ALPHA_BOUND),
               (3 * S, S, 3, 1, BETA_BOUND)]


@pytest.mark.parametrize("rows,width,row_div,elem_scale,bound", SHEAR_CASES)
def test_shear_matches_pallas(rows, width, row_div, elem_scale, bound):
    img = _rand(0, (D, rows, width))
    coef = _rand(1, (D,), -bound + 1e-3, bound - 1e-3)
    ref = jrot.shear(jnp.asarray(img), jnp.asarray(coef), row_div, elem_scale,
                     S, coef_bound=bound)
    got = trot.shear(torch.from_numpy(img), torch.from_numpy(coef), row_div,
                     elem_scale, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_shear_is_exact_beyond_the_pallas_bound():
    """|coef| > 1: the port shifts whole rows by any amount (a pure integer
    shift at coef = 2 moves row r by 2*(r + 0.5 - S/2) texels)."""
    img = _rand(2, (1, 8, 32))
    coef = torch.tensor([2.0])
    got = trot.shear(torch.from_numpy(img), coef, 1, 1, 32)
    for r in range(8):
        shift = 2.0 * (r + 0.5 - 16)
        i = int(np.floor(shift))
        f = shift - i
        for lane in range(32):
            a = img[0, r, lane + i] if 0 <= lane + i < 32 else 0.0
            b = img[0, r, lane + i + 1] if 0 <= lane + i + 1 < 32 else 0.0
            assert abs(float(got[0, r, lane]) - ((1 - f) * a + f * b)) < 1e-6


@pytest.mark.parametrize("groups,row_lo,row_hi", [(1, 8, 56), (2, 0, 64),
                                                  (4, 16, 40)])
def test_shear_reduce_matches_pallas(groups, row_lo, row_hi):
    img = _rand(3, (D, S, S))
    coef = _rand(4, (D,), -0.4, 0.4)
    ref = jrot.shear_reduce(jnp.asarray(img), jnp.asarray(coef), 1, 1, S,
                            ALPHA_BOUND, row_lo, row_hi, groups=groups)
    got = trot.shear_reduce(torch.from_numpy(img), torch.from_numpy(coef), 1,
                            1, S, row_lo, row_hi, groups=groups)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_quadrant_groups_match():
    angles = tuple(-i * 2 * np.pi / 24 for i in range(24))
    assert trot._quadrant_groups(angles) == jrot._quadrant_groups(angles)


@pytest.mark.parametrize("delta_frac", [0.0, -0.3])
def test_rotate_planar_sum_matches_pallas(delta_frac):
    """Bin angles spanning all four quadrants, with and without a traced
    jitter delta."""
    d = D
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    max_delta = 2 * np.pi / d
    delta = delta_frac * max_delta
    chans = [_rand(5 + c, (d, S, S)) for c in range(3)]
    ref = jrot.rotate_planar_sum(tuple(map(jnp.asarray, chans)), base,
                                 jnp.float32(delta), max_delta, 8, 56)
    got = trot.rotate_planar_sum(tuple(map(torch.from_numpy, chans)), base,
                                 torch.tensor(delta, dtype=torch.float32), 8, 56)
    assert got.shape == (3, 48, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kwargs", [dict(n_texels=S - 1),
                                    dict(row_lo=40, row_hi=40),
                                    dict(groups=3)])
def test_shear_reduce_rejects_bad_arguments(kwargs):
    args = dict(row_div=1, elem_scale=1, n_texels=S, row_lo=0, row_hi=S,
                groups=2)
    args.update(kwargs)
    with pytest.raises(ValueError):
        trot.shear_reduce(torch.zeros(D, S, S), torch.zeros(D), **args)

