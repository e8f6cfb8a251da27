"""Legacy integrator strategies (counterpart of the JAX package's
sim/legacy_integrators.py; reference: Assets/Resources/LegacyIntegrators.cginc).

The reference keeps five alternative IMonteCarloMethod implementations as
design-space documentation; none is dispatched. They are kept here the same
way, as executable estimators for A/B experiments:

  Implicit               (:8)   march to the first interaction sampled by
                                per-texel survival tests; deposit the full
                                energy at the interaction point only.
  ImplicitInterval       (:78)  implicit walk + stratified interval
                                deposits along the way.
  Explicit               (:161) deposit E*(1-t) at every texel crossed (the
                                RBT engine's dense scan is this estimator's
                                exact integral form).
  ExplicitBounded        (:224) explicit deposits with a transmittance floor
                                that ends the walk early.
  ExplicitBounceImplicitInterval (:302) explicit deposits between
                                implicit-sampled bounces.

`implicit_free_flight` is the 2D batched form; the other four work on 1D ray
profiles (per-texel transmissibility along a ray, texel k covering u in
[k, k+1)). Each returns its deposit weights and the sampled bounce endpoint,
so tests can hold it to closed forms. Random numbers come from an explicit
`torch.Generator` where the JAX version takes a key.
"""

from __future__ import annotations

import torch

from ..core.sampling import sample_bilinear_uv


def implicit_free_flight(trans_field: torch.Tensor, origin: torch.Tensor,
                         direction: torch.Tensor, generator: torch.Generator,
                         max_steps: int = 512):
    """The Implicit estimator's free flight (LegacyIntegrators.cginc:8-76):
    per-texel survival sampling, lock-step over the batch.

    Returns (hit_position (N, 2), hit (N,)); hit False means the photon
    escaped without interacting.
    """
    n = origin.shape[0]
    dev = origin.device
    height, width = trans_field.shape
    pos = origin
    live = torch.ones(n, dtype=torch.bool, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_pos = origin
    for _ in range(max_steps):
        uv = torch.stack([pos[:, 0] / float(width), pos[:, 1] / float(height)], -1)
        t = sample_bilinear_uv(trans_field, uv)
        u = torch.rand((n,), generator=generator, device=dev)
        interact = live & ~hit & (u > t)
        hit_pos = torch.where(interact[:, None], pos, hit_pos)
        hit = hit | interact
        pos = torch.where((live & ~hit)[:, None], pos + direction, pos)
        inside = ((pos[:, 0] >= -1.0) & (pos[:, 0] <= width + 1.0)
                  & (pos[:, 1] >= -1.0) & (pos[:, 1] <= height + 1.0))
        live = live & inside
    return hit_pos, hit


# 1D ray-profile estimators. `ts` is the per-texel transmissibility along a
# ray; T(x) = prod_{k<x} ts[k] with a fractional last texel.


def _cum_transmittance(ts: torch.Tensor) -> torch.Tensor:
    """T after crossing each texel: T[k] = prod_{j<=k} ts[j], shape (..., n)."""
    return torch.cumprod(ts, dim=-1)


def _take(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[..., k] per leading index, for k of x's leading shape."""
    return torch.gather(x, -1, k[..., None])[..., 0]


def _t_before(cum: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Transmittance before texel k (1 before the first)."""
    return torch.where(k > 0, torch.gather(cum, -1, (k - 1).clamp(min=0)), 1.0)


def _crossing_point(ts: torch.Tensor, target_t: torch.Tensor) -> torch.Tensor:
    """Fractional distance u where the cumulative transmittance first drops
    below target_t (the log interpolation of EndTraversal,
    LegacyIntegrators.cginc:203: u = k + log(tp/T_before)/log(ts[k]))."""
    cum = _cum_transmittance(ts)
    n = ts.shape[-1]
    k = (cum > target_t[..., None]).sum(-1).clamp(0, n - 1)
    t_before = _t_before(cum, k[..., None])[..., 0]
    log_ts = torch.log(torch.clamp(_take(ts, k), 1e-30, 1.0 - 1e-7))
    frac = torch.clamp(torch.log(torch.clamp(target_t, min=1e-30)
                                 / torch.clamp(t_before, min=1e-30)) / log_ts, 0.0, 1.0)
    return k.to(torch.float32) + frac


def implicit_endpoint(ts: torch.Tensor, generator: torch.Generator):
    """Implicit estimator (LegacyIntegrators.cginc:8-76).

    Samples the bounce endpoint uniformly along the ray (uTarget =
    rand*uEscape, :32) and weights it by the transmittance up to it times
    the local interaction density (1 - ts) (hitIntensity, :57).

    Returns (u_target, weight): times n (the uniform sampling's 1/pdf, left
    to the caller) an unbiased one-sample estimator of the line integral
    int_0^n T(u) sigma(u) du.
    """
    n = ts.shape[-1]
    u = torch.rand(ts.shape[:-1], generator=generator, device=ts.device) * n
    cum = _cum_transmittance(ts)
    k = torch.floor(u).long().clamp(0, n - 1)
    t_before = _t_before(cum, k[..., None])[..., 0]
    ts_k = _take(ts, k)
    t_at = t_before * ts_k ** (u - k.to(torch.float32))
    return u, t_at * (1.0 - ts_k)


def explicit_endpoint(ts: torch.Tensor, generator: torch.Generator):
    """The Explicit estimator's distance sampling (LegacyIntegrators.cginc:161-222).

    Draws the transmit potential tp = u^3 with quantum scale 3u^2
    (:181-184): for any f, E[3u^2 f(T^-1(u^3))] = int_0^1 f(T^-1(tp)) dtp.
    A tp below the ray's escape transmittance clamps to the profile end.

    Returns (u_hit, quantum_scale, tp).
    """
    u = torch.rand(ts.shape[:-1], generator=generator, device=ts.device)
    tp = u ** 3
    return _crossing_point(ts, tp), 3.0 * u ** 2, tp


def explicit_bounded_endpoint(ts: torch.Tensor, generator: torch.Generator):
    """ExplicitBounded estimator (LegacyIntegrators.cginc:224-300).

    Phase 1 marches to escape, measuring the escape transmittance T_esc.
    Phase 2 redraws tp ~ U[T_esc, 1] (:290), conditioning on interaction
    with its probability (1 - T_esc) folded into the energy (:293), and
    flies to the crossing point.

    Returns (u_hit, energy_scale=(1 - T_esc), tp).
    """
    t_esc = _cum_transmittance(ts)[..., -1]
    u = torch.rand(ts.shape[:-1], generator=generator, device=ts.device)
    tp = t_esc + u * (1.0 - t_esc)
    return _crossing_point(ts, tp), 1.0 - t_esc, tp


def implicit_interval_deposits(ts: torch.Tensor, generator: torch.Generator,
                               interval: float):
    """ImplicitInterval estimator's stratified in-scatter deposits
    (LegacyIntegrators.cginc:89-95,126-130).

    One deposit per stride of `interval` texels at jittered positions
    u_k = (k + xi) * interval, weighted by the transmittance up to u_k times
    the local interaction density.

    Returns (u_samples (..., m), weights (..., m)) with m = ceil(n/interval).
    """
    n = ts.shape[-1]
    m = int(-(-n // interval))
    xi = torch.rand(ts.shape[:-1] + (m,), generator=generator, device=ts.device)
    u_s = (torch.arange(m, dtype=torch.float32, device=ts.device) + xi) * interval
    cum = _cum_transmittance(ts)
    k = torch.floor(u_s).long().clamp(0, n - 1)
    t_before = _t_before(cum, k)
    ts_k = torch.gather(ts.expand(xi.shape[:-1] + (n,)), -1, k)
    t_at = t_before * ts_k ** (u_s - k.to(torch.float32))
    weights = t_at * (1.0 - ts_k) * (u_s < n).to(torch.float32)
    return u_s, weights


def explicit_bounce_implicit_interval(ts: torch.Tensor, generator: torch.Generator,
                                      interval: float):
    """ExplicitBounceImplicitInterval (LegacyIntegrators.cginc:302-381):
    explicit (tp = u^3) bounce endpoint sampling with stratified interval
    deposits that self-attenuate the photon energy as they are written
    (:319, energy -= energy*albedo*outScatter).

    Returns (u_hit, quantum, u_samples, deposit_weights, energy_factor),
    energy_factor the energy left after the deposits before u_hit (albedo
    taken as 1; the caller applies its own albedo track).
    """
    u_hit, quantum, _ = explicit_endpoint(ts, generator)
    u_s, w = implicit_interval_deposits(ts, generator, interval)
    before = u_s < u_hit[..., None]
    w = w * before
    energy_factor = torch.where(before, 1.0 - w, 1.0).prod(-1)
    return u_hit, quantum, u_s, w, energy_factor
