"""Port parity for the legacy estimators (litbox_tpu_torch/sim/legacy_integrators.py
against the JAX package's, reference: LegacyIntegrators.cginc).

The estimators draw from torch's generator where the JAX package draws from
threefry, so each is held to the closed forms of
tests/test_legacy_integrators.py at the same tolerances; the deterministic
crossing-point inversion is held to the JAX function on the same inputs to
1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.sim import legacy_integrators as jlegacy
from litbox_tpu_torch.sim.legacy_integrators import (
    _crossing_point,
    _cum_transmittance,
    explicit_bounce_implicit_interval,
    explicit_bounded_endpoint,
    explicit_endpoint,
    implicit_endpoint,
    implicit_free_flight,
    implicit_interval_deposits,
)

N = 64          # profile length (texels)
T_UNIFORM = 0.97
BATCH = 200_000


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform_profile(batch=BATCH, t=T_UNIFORM, n=N):
    return torch.full((batch, n), t)


def _line_integral(t=T_UNIFORM, n=N):
    """int_0^n T(u) sigma(u) du for a uniform medium, T(u)=t^u, sigma=1-t."""
    return (1.0 - t) * (1.0 - t**n) / (-np.log(t))


def test_crossing_point_matches_jax():
    """The cumulative transmittance and its log-interpolated crossing on
    random profiles and targets (past either end included): 1e-6 relative."""
    rng = np.random.default_rng(0)
    ts = rng.uniform(0.5, 1.0, (256, 32)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (256,)).astype(np.float32)
    target[:2] = (1.0, 1e-12)
    np.testing.assert_allclose(_cum_transmittance(torch.from_numpy(ts)).numpy(),
                               np.asarray(jlegacy._cum_transmittance(jnp.asarray(ts))),
                               rtol=1e-6)
    ref = np.asarray(jlegacy._crossing_point(jnp.asarray(ts), jnp.asarray(target)))
    got = _crossing_point(torch.from_numpy(ts), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_implicit_endpoint_unbiased():
    u, w = implicit_endpoint(_uniform_profile(), _gen(0))
    est = float(w.mean()) * N  # 1/pdf = n for uniform sampling
    assert abs(est / _line_integral() - 1.0) < 0.02, est


def test_explicit_endpoint_reweighting():
    """E[quantum * f(u_hit)] = int_0^1 f(T^-1(tp)) dtp."""
    u_hit, quantum, _ = explicit_endpoint(_uniform_profile(), _gen(1))
    est = float((quantum * u_hit).double().mean())
    tp = np.linspace(1e-6, 1.0, 200_001)
    expect = np.trapezoid(np.minimum(np.log(tp) / np.log(T_UNIFORM), N), tp)
    assert abs(est / expect - 1.0) < 0.02, (est, expect)


def test_explicit_bounded_endpoint_distribution():
    """tp ~ U[T_esc, 1]: the endpoint's CDF is (1 - T(x)) / (1 - T_esc) and
    the energy scale is exactly 1 - T_esc."""
    u_hit, scale, _ = explicit_bounded_endpoint(_uniform_profile(), _gen(2))
    t_esc = T_UNIFORM**N
    np.testing.assert_allclose(scale.numpy(), 1.0 - t_esc, rtol=1e-5)
    xs = np.linspace(0.0, N, 101)
    expect_mean = np.trapezoid((T_UNIFORM**xs - t_esc) / (1.0 - t_esc), xs)
    est = float(u_hit.double().mean())
    assert abs(est / expect_mean - 1.0) < 0.02, (est, expect_mean)
    assert float(u_hit.max()) <= N


def test_implicit_interval_deposits_stratified():
    """interval * sum(weights) is the stratified estimator of the in-scatter
    line integral."""
    interval = 8
    u_s, w = implicit_interval_deposits(_uniform_profile(batch=50_000), _gen(3), interval)
    assert u_s.shape[-1] == N // interval
    est = float(w.sum(-1).double().mean()) * interval
    assert abs(est / _line_integral() - 1.0) < 0.03, est


def test_explicit_bounce_implicit_interval_consistency():
    u_hit, quantum, u_s, w, efac = explicit_bounce_implicit_interval(
        _uniform_profile(batch=10_000), _gen(4), 8)
    assert bool(((w == 0.0) | (u_s < u_hit[:, None])).all())
    assert float(efac.min()) > 0.0 and float(efac.max()) <= 1.0
    some = w.sum(-1) > 0
    assert bool(torch.where(some, efac < 1.0, efac == 1.0).all())


def test_nonuniform_profile_crossing_exact():
    """The crossing inversion is exact on a two-segment profile."""
    ts = torch.cat([torch.full((1, 16), 0.99), torch.full((1, 16), 0.8)], -1)
    u_hit, scale, tp = explicit_bounded_endpoint(ts, _gen(5))
    u = float(u_hit[0])
    t_at = 0.99 ** min(u, 16.0) * (0.8 ** max(u - 16.0, 0.0))
    np.testing.assert_allclose(t_at, float(tp[0]), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_implicit_free_flight_distribution(seed):
    """tests/test_backward.py's free flight: the mean free path in a uniform
    medium of t = 0.8 a texel matches the geometric mean t/(1-t) texels
    within 15%."""
    w = 32
    t = 0.8
    trans = torch.full((w, w), t)
    n = 4096
    origin = torch.tensor([[2.0, w / 2.0]]).repeat(n, 1)
    direction = torch.tensor([[1.0, 0.0]]).repeat(n, 1)
    hit_pos, hit = implicit_free_flight(trans, origin, direction, _gen(seed), max_steps=64)
    dist = (hit_pos[:, 0] - 2.0)[hit].numpy()
    expected = t / (1 - t)
    assert abs(dist.mean() / expected - 1) < 0.15, (dist.mean(), expected)
