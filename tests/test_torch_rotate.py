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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores (a test took 11x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# (rows, width, row_div, elem_scale, coef bound), n_texels = width /
# elem_scale: the x-shear of channel-interleaved rows, the y-shear on their
# transpose, and the planar case; then the same at an odd width (n_texels
# 37), where the card's kernels take 4-byte copies and stores.
SHEAR_CASES = [(S, S, 1, 1, ALPHA_BOUND), (S, 3 * S, 1, 3, ALPHA_BOUND),
               (3 * S, S, 3, 1, BETA_BOUND), (S, 37, 1, 1, ALPHA_BOUND),
               (S, 111, 1, 3, ALPHA_BOUND), (120, 37, 3, 1, BETA_BOUND)]


@pytest.mark.parametrize("rows,width,row_div,elem_scale,bound", SHEAR_CASES)
def test_shear_matches_pallas(rows, width, row_div, elem_scale, bound):
    n_texels = width // elem_scale
    img = _rand(0, (D, rows, width))
    coef = _rand(1, (D,), -bound + 1e-3, bound - 1e-3)
    ref = jrot.shear(jnp.asarray(img), jnp.asarray(coef), row_div, elem_scale,
                     n_texels, coef_bound=bound)
    got = trot.shear(torch.from_numpy(img), torch.from_numpy(coef), row_div,
                     elem_scale, n_texels)
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


@pytest.mark.parametrize("groups,row_lo,row_hi,width", [
    pytest.param(1, 8, 56, S, id="1-8-56"), pytest.param(2, 0, 64, S, id="2-0-64"),
    pytest.param(4, 16, 40, S, id="4-16-40"),
    pytest.param(2, 8, 48, 37, id="2-8-48-width37")])
def test_shear_reduce_matches_pallas(groups, row_lo, row_hi, width):
    """S rows of `width` texels; width 37 takes the card's 4-byte path."""
    img = _rand(3, (D, S, width))
    coef = _rand(4, (D,), -0.4, 0.4)
    ref = jrot.shear_reduce(jnp.asarray(img), jnp.asarray(coef), 1, 1, width,
                            ALPHA_BOUND, row_lo, row_hi, groups=groups)
    got = trot.shear_reduce(torch.from_numpy(img), torch.from_numpy(coef), 1,
                            1, width, ALPHA_BOUND, row_lo, row_hi, groups=groups)
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
                                 torch.tensor(delta, dtype=torch.float32),
                                 max_delta, 8, 56)
    assert got.shape == (3, 48, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kwargs", [dict(n_texels=S - 1),
                                    dict(row_lo=40, row_hi=40),
                                    dict(groups=3)])
def test_shear_reduce_rejects_bad_arguments(kwargs):
    args = dict(row_div=1, elem_scale=1, n_texels=S, coef_bound=ALPHA_BOUND,
                row_lo=0, row_hi=S, groups=2)
    args.update(kwargs)
    with pytest.raises(ValueError):
        trot.shear_reduce(torch.zeros(D, S, S), torch.zeros(D), **args)



def test_rotate_planar_sum_takes_jax_positional_arguments():
    """(channels, base_angles, delta, max_delta, row_lo, row_hi) by position,
    as the JAX function takes them, gives the JAX result; a float delta
    beyond max_delta raises."""
    d = D
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    max_delta = 2 * np.pi / d
    chans = [_rand(20 + c, (d, S, S)) for c in range(3)]
    args = (0.4 * max_delta, max_delta, 16, 48)
    ref = jrot.rotate_planar_sum(tuple(map(jnp.asarray, chans)), base, *args)
    got = trot.rotate_planar_sum(tuple(map(torch.from_numpy, chans)), base, *args)
    assert got.shape == (3, 32, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="max_delta"):
        trot.rotate_planar_sum(tuple(map(torch.from_numpy, chans)), base,
                               1.5 * max_delta, max_delta, 16, 48)


@pytest.mark.parametrize("delta_frac", [0.0, -0.3, 1.5])
def test_rotate_planar_sum_fused_matches_pallas(delta_frac):
    """The fused whole-image rotate-and-sum against the JAX Pallas kernel in
    interpret mode (s=128, d=8): the same shears in the same order, so
    float32 rounding only. delta_frac 1.5 (about 1.18 rad) puts residuals
    beyond the bins' +-pi/4: the coefficients have no bound. There XLA and
    PyTorch round tan and sin of some residuals one ulp apart (6e-8 at
    |alpha| near 1.5), which moves a shift by up to 6e-8 x 64 texels: the
    two are held to 5e-5 there."""
    s, d = 128, 8
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    delta = delta_frac * 2 * np.pi / d
    chans = [_rand(30 + c, (d, s, s)) for c in range(3)]
    ref = np.asarray(jrot.rotate_planar_sum_fused(tuple(map(jnp.asarray, chans)),
                                                  base, delta))
    got = trot.rotate_planar_sum_fused(tuple(map(torch.from_numpy, chans)), base,
                                       torch.tensor(delta, dtype=torch.float32))
    assert got.shape == (3, s, s)
    atol = 1e-5 if abs(delta_frac) < 1 else 5e-5
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)
    plain = trot.rotate_planar_sum_fused_plain(tuple(map(torch.from_numpy, chans)),
                                               base, delta)
    np.testing.assert_allclose(plain.numpy(), ref, atol=atol, rtol=0)


def test_rotate_planar_sum_fused_conserves_mass_like_pipeline():
    """Fused against the planar pipeline on smooth fields (the JAX package's
    test_rotate_planar_sum_fused_matches_pipeline): total mass within 1e-3,
    mean absolute difference below 2% of the mean."""
    s, d = 128, 8
    img = _rand(40, (3, d, s, s))
    for _ in range(4):
        img = (np.roll(img, 1, 2) + np.roll(img, -1, 2) + np.roll(img, 1, 3)
               + np.roll(img, -1, 3) + img) / 5
    chans = tuple(torch.from_numpy(c) for c in img)
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    pipe = trot.rotate_planar_sum(chans, base, 0.0, 2 * np.pi / d, 16, 112).numpy()
    fused = trot.rotate_planar_sum_fused(chans, base, 0.0)[:, 16:112].numpy()
    assert abs(fused.sum() / pipe.sum() - 1) < 1e-3
    assert np.abs(fused - pipe).mean() < 0.02 * pipe.mean()


def test_shear_functions_take_jax_positional_arguments():
    """shear(img, coef, row_div, elem_scale, n_texels, coef_bound) and
    shear_reduce(img, coef, row_div, elem_scale, n_texels, coef_bound,
    row_lo, row_hi, groups) by position, as the JAX functions take them:
    the same shape and values as the Pallas versions (interpreted). The
    shear_reduce case is (384, 256, 256), rows [64, 128), one group."""
    img = _rand(50, (384, 256, 256))
    coef = _rand(51, (384,), -0.9, 0.9)
    args = (1, 1, 256, 1.0, 64, 128)
    ref = np.asarray(jrot.shear_reduce(jnp.asarray(img), jnp.asarray(coef), *args))
    got = trot.shear_reduce(torch.from_numpy(img), torch.from_numpy(coef), *args)
    assert got.shape == ref.shape == (64, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    img, coef = img[:8, :64, :], coef[:8]
    args = (1, 1, 256, 1.0)
    ref = np.asarray(jrot.shear(jnp.asarray(img), jnp.asarray(coef), *args))
    got = trot.shear(torch.from_numpy(img), torch.from_numpy(coef), *args)
    assert got.shape == ref.shape == (8, 64, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["copy_accum", "transpose2_accum",
                                  "shear1_accum", "shear3_accum"])
def test_rotfused_split_matches_jax(name):
    """The four variants of the K4 cost split (runs/prof_rotfused.py) at
    (6, 128, 128), against the JAX package's operations they stand for: the
    sum, swapaxes twice, and the Pallas shear (interpreted) once or three
    times with the bound of the script's residual angles (|alpha| <= tan(pi/8),
    |beta| <= sin(pi/4)). Sums of 6 images: to 1e-5 of the maximum."""
    from litbox_tpu_torch.prof import rotfused

    n, s = 6, 128
    img = _rand(60, (n, s, s))
    resid = (_rand(61, (n,)) - 0.5) * (np.pi / 2)
    alpha = (-np.tan(resid / 2)).astype(np.float32)
    beta = np.sin(resid).astype(np.float32)
    x, ja, jb = jnp.asarray(img), jnp.asarray(alpha), jnp.asarray(beta)
    if name == "copy_accum":
        ref, args = x.sum(0), ()
    elif name == "transpose2_accum":
        ref, args = jnp.swapaxes(jnp.swapaxes(x, 1, 2), 1, 2).sum(0), ()
    elif name == "shear1_accum":
        ref, args = jrot.shear(x, ja, 1, 1, s, ALPHA_BOUND).sum(0), (alpha,)
    else:
        t = jrot.shear(x, ja, 1, 1, s, ALPHA_BOUND)
        t = jrot.shear(t, jb, 1, 1, s, BETA_BOUND)
        ref, args = jrot.shear(t, ja, 1, 1, s, ALPHA_BOUND).sum(0), (alpha, beta)
    ref = np.asarray(ref)
    got = getattr(rotfused, name)(torch.from_numpy(img), *map(torch.from_numpy, args))
    assert got.shape == ref.shape == (s, s)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_kernel_counts_come_from_the_kernel_only():
    """K4 and V4 count their work only on the card: a counts tensor beside
    CPU inputs raises rather than being left at zero."""
    from litbox_tpu_torch.prof import rotfused

    s, d = 32, 4
    chans = tuple(torch.from_numpy(c) for c in _rand(70, (3, d, s, s)))
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    with pytest.raises(ValueError):
        trot.rotate_planar_sum_fused(chans, base, 0.0, torch.zeros(4, dtype=torch.int64))
    coef = torch.zeros(d)
    with pytest.raises(ValueError):
        rotfused.shear3_accum(chans[0], coef, coef, torch.zeros(1, dtype=torch.int64))
