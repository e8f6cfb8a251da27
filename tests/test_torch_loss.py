"""The port's losses (litbox_tpu_torch.nn.loss) and tone-map inverses against
the JAX package's, on numpy inputs from a seed: values to 1e-6 relative,
hdr_loss's gradient with respect to pred to 1e-5 of its maximum on inputs
with exact zeros (MC renders have them; jnp.maximum splits the gradient
at a tie)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.nn import loss as jloss
from litbox_tpu.post import tonemap as jtonemap
from litbox_tpu_torch.nn import loss as tloss
from litbox_tpu_torch.post import tonemap as ttonemap

REL = 1e-6
GRAD_TOL = 1e-5

CONFIGS = {
    "default": {},
    "log1p": dict(compress="log1p"),
    "normalized": dict(normalize_weights=True),
    "capped": dict(weight_cap=2.0),
    "log_l1": dict(log_l1=0.25),
    "rel_l2": dict(rel_l2=1.0),
    # runs/train_denoiser_r5.py's production loss
    "r5": dict(normalize_weights=True, log_l1=0.25, rel_l2=1.0, compress="log1p"),
    "all": dict(normalize_weights=True, weight_cap=3.0, log_l1=0.5, rel_l2=0.5,
                compress="log1p", alpha=1.2, beta=0.3, gamma=0.1, base_weight=0.4),
}


def _pair(seed, shape=(2, 20, 24, 3)):
    """HDR-like pred/target with exact zeros in both, a few ties at -0.5 in
    pred and negative values, as a net's output and an MC render have."""
    rng = np.random.default_rng(seed)
    target = rng.exponential(0.5, shape).astype(np.float32)
    target[rng.uniform(size=shape) < 0.2] = 0.0
    target[0, 3, 4] = 40.0
    pred = (target + rng.normal(0, 0.3, shape)).astype(np.float32)
    pred[rng.uniform(size=shape) < 0.1] = 0.0
    pred[1, 2, :3] = -0.5
    return pred, target


def _rel(got, ref):
    return abs(float(got) - float(ref)) / max(abs(float(ref)), 1e-30)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hdr_loss_matches_jax(name):
    pred, target = _pair(0)
    jcfg = jloss.HdrLossConfig(**CONFIGS[name])
    tcfg = tloss.HdrLossConfig(**CONFIGS[name])
    ref = jax.jit(lambda p, t: jloss.hdr_loss(p, t, jcfg))(pred, target)
    got = tloss.hdr_loss(torch.from_numpy(pred), torch.from_numpy(target), tcfg)
    assert _rel(got, ref) < REL, (float(got), float(ref))


@pytest.mark.parametrize("name", ["default", "log1p", "normalized", "r5", "all"])
def test_hdr_loss_gradient_matches_jax(name):
    pred, target = _pair(1)
    assert (pred == 0).any() and (target == 0).any() and (pred == -0.5).any()
    jcfg = jloss.HdrLossConfig(**CONFIGS[name])
    ref = np.asarray(jax.jit(jax.grad(lambda p: jloss.hdr_loss(p, target, jcfg)))(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tloss.hdr_loss(p, torch.from_numpy(target), tloss.HdrLossConfig(**CONFIGS[name])).backward()
    err = np.abs(p.grad.numpy() - ref).max()
    assert err <= GRAD_TOL * np.abs(ref).max(), err


def test_ties_split_the_gradient_as_jnp_maximum():
    """At pred = -0.5 (log1p's floor) and pred = 0 (log_l1's relu) the
    gradient is half of each side's, as jnp.maximum's."""
    cfg = dict(compress="log1p", log_l1=1.0, beta=0.0, gamma=0.0)
    pred = np.full((1, 4, 4, 1), -0.5, np.float32)
    pred[0, 0, 0, 0] = 0.0
    target = np.ones_like(pred)
    ref = np.asarray(jax.grad(lambda p: jloss.hdr_loss(
        p, target, jloss.HdrLossConfig(**cfg)))(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tloss.hdr_loss(p, torch.from_numpy(target), tloss.HdrLossConfig(**cfg)).backward()
    np.testing.assert_allclose(p.grad.numpy(), ref, rtol=REL, atol=0)


# SSIM against a constant image: the constant's E[x^2] - E[x]^2 cancels to
# float32 noise of order 1e-8 (clamped at 0) beside c2 = 9e-4, which both
# packages sum in their own order, so the score is held to 1e-5 there.
FLAT_SSIM_REL = 1e-5


@pytest.mark.parametrize("window", [11, 7])
def test_ssim_matches_jax(window):
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 32, 28, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    cases = ((a, b, REL), (a, a, REL), (b, a * a, REL), (a * 0.0 + 0.25, b, FLAT_SSIM_REL))
    for x, y, tol in cases:
        ref = jax.jit(lambda u, v: jloss.ssim(u, v, window))(x, y)
        got = tloss.ssim(torch.from_numpy(x), torch.from_numpy(y), window)
        assert _rel(got, ref) < tol, (float(got), float(ref))


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 2, (1, 16, 16, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    for peak in (1.0, 2.5):
        ref = jloss.psnr(jnp.asarray(a), jnp.asarray(b), peak)
        got = tloss.psnr(torch.from_numpy(a), torch.from_numpy(b), peak)
        assert _rel(got, ref) < REL
    assert _rel(tloss.psnr(torch.from_numpy(a), torch.from_numpy(a)),
                jloss.psnr(jnp.asarray(a), jnp.asarray(a))) < REL  # the 1e-12 floor


# tonemap_ue5_inverse is 10^(black + t (white - black)): torch's and XLA's
# float32 asin and sin differ by up to 2^-23 in t = smoothstep_inverse(y),
# which the exponent scales by (white - black) ln 10 = 11.5, and XLA fuses
# the affine step and pow its own way; the two agree to 2.5e-6 relative
# (2.0e-6 measured on 400,000 values in [-0.1, 1.1]).
INVERSE_REL = 2.5e-6


def test_tonemap_inverses_match_jax():
    y = np.concatenate([np.linspace(-0.1, 1.1, 2401), [0.0, 1.0, 0.5]]).astype(np.float32)
    t_ref = np.asarray(jtonemap.smoothstep_inverse(y))
    t = ttonemap.smoothstep_inverse(torch.from_numpy(y))
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=0, atol=REL)  # t lies in [0, 1]
    for shape in (ttonemap.GOLDEN_PNG_SHAPE, ttonemap.UE5Shape(exposure=0.3)):
        jshape = jtonemap.UE5Shape(shape.exposure, shape.white_point, shape.black_point)
        ref = np.asarray(jax.jit(lambda v: jtonemap.tonemap_ue5_inverse(v, jshape))(y))
        got = ttonemap.tonemap_ue5_inverse(torch.from_numpy(y), shape).numpy()
        np.testing.assert_allclose(got, ref, rtol=INVERSE_REL, atol=0)
    assert ttonemap.GOLDEN_PNG_SHAPE == ttonemap.UE5Shape(0.0, 2.0, -3.0)
    x = torch.logspace(-2.9, 1.9, 50)
    back = ttonemap.tonemap_ue5_inverse(ttonemap.tonemap_ue5(x, ttonemap.GOLDEN_PNG_SHAPE))
    torch.testing.assert_close(back, x, rtol=2e-3, atol=0)
