"""Inverse-CDF lookup-table builders (reference: Assets/Scripts/Util/LUT.cs).

These reproduce the reference's sampling tables:
  * `mie_scattering_lut`     — artistic Mie-ish phase function (LUT.cs:211-222)
  * `teardrop_scattering_lut`— importance lobe toward a target (LUT.cs:224-228)
  * `brdf_lut`               — 3D GGX-based BRDF table over
                               (rand, cross2d(normal, reflected), roughness)
                               (LUT.cs:230-290)

The reference inverts CDFs with a cubic-read binary search; tables here are
inverted with monotone linear interpolation, which is exact to within table
resolution (goldens are statistical, not bit-exact — SURVEY.md section 4).

Tables are numpy on the host (built once, cached). This module is a copy of
the JAX package's `core/luts.py`, so that the port imports nothing from it.
"""

from __future__ import annotations

import functools

import numpy as np

LUT_SIZE = 2048
BRDF_LUT_SHAPE = (128, 64, 16)  # (rand, normal x reflected, roughness)


def invert_cdf(pdf_values: np.ndarray, domain: np.ndarray, n_out: int | None = None) -> np.ndarray:
    """Invert the CDF of a tabulated (unnormalized) pdf.

    Mirrors LUT.cs GenerateFunctionTable -> NormalizeDistribution ->
    IntegrateDistribution -> Invert: the CDF is a cumulative sum of the
    normalized table (so cdf[-1] == 1), and the inverse is evaluated at
    linspace(cdf.min(), cdf.max(), n_out).
    """
    pdf_values = np.asarray(pdf_values, dtype=np.float64)
    n_out = n_out or pdf_values.shape[-1]
    norm = pdf_values / pdf_values.sum(-1, keepdims=True)
    cdf = np.cumsum(norm, axis=-1)
    lo = cdf[..., :1]
    hi = cdf[..., -1:]
    targets = lo + (hi - lo) * np.linspace(0.0, 1.0, n_out)
    if cdf.ndim == 1:
        return np.interp(targets, cdf, domain)
    # Batched inversion via searchsorted per row.
    flat_cdf = cdf.reshape(-1, cdf.shape[-1])
    flat_targets = targets.reshape(-1, n_out)
    out = np.empty_like(flat_targets)
    for i in range(flat_cdf.shape[0]):
        out[i] = np.interp(flat_targets[i], flat_cdf[i], domain)
    return out.reshape(*cdf.shape[:-1], n_out)


def vectorized_angle_pdf_lut(pdf_fn, samples: int = LUT_SIZE,
                             lower: float = -np.pi, upper: float = np.pi) -> np.ndarray:
    """(N, 3) table of (cos(theta), sin(theta), avg_pdf / pdf(theta)).

    Sampling the table at uniform u in [0,1] yields angles distributed
    according to pdf_fn; the z channel is the inverse relative density
    (LUT.cs:150-168).
    """
    theta = np.linspace(lower, upper, samples)
    pdf = np.asarray(pdf_fn(theta), dtype=np.float64)
    avg = pdf.mean()
    inv = invert_cdf(pdf, theta)
    return np.stack([np.cos(inv), np.sin(inv), avg / pdf_fn(inv)], axis=-1).astype(np.float32)


@functools.cache
def mie_scattering_lut(samples: int = LUT_SIZE) -> np.ndarray:
    """Artistic Mie/Rayleigh hybrid phase function (LUT.cs:211-222)."""
    forward_bias, softener, lobe_sharpness = 0.3, 0.5, 2.0

    def pdf(theta):
        c = np.cos(theta)
        return (softener + c ** lobe_sharpness) / (1.0 + forward_bias * c)

    return vectorized_angle_pdf_lut(pdf, samples)


@functools.cache
def teardrop_scattering_lut(spike_strength: float = 3.0, samples: int = LUT_SIZE) -> np.ndarray:
    """Teardrop importance lobe: pdf = 1 + strength*(theta/pi)^6 (LUT.cs:224-228)."""

    def pdf(theta):
        return 1.0 + spike_strength * (theta / np.pi) ** 6

    return vectorized_angle_pdf_lut(pdf, samples)


@functools.cache
def brdf_lut(shape: tuple[int, int, int] = BRDF_LUT_SHAPE) -> np.ndarray:
    """3D GGX-based BRDF table, channels (cos, sin, slope_mag, weight).

    Dimensions (LUT.cs:230-290):
      i — random scatter variable (inverse-CDF sampled)
      j — (cross2d(normal, reflected) + 1) / 2, i.e. sin(incident angle)
      k — roughness in [0, 1]

    The slope/weight channels feed the Hermite interpolation along i in
    StandardBRDF (SimulationCommon.cginc:294-339); weight is 0 at the table
    ends and the returned energy scale is weight^2.
    """
    ni, nj, nk = shape
    out = np.zeros((ni, nj, nk, 4), dtype=np.float32)
    eps = 1e-4
    theta = np.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, ni)

    for j in range(nj):
        normal_cross_incident = 2.0 * j / (nj - 1) - 1.0
        incident_angle = np.arcsin(normal_cross_incident)
        for k in range(nk):
            roughness = k / (nk - 1)
            r2 = roughness * roughness

            def pdf(th, incident_angle=incident_angle, r2=r2):
                half = (th + incident_angle) / 2.0
                ch = np.cos(half)
                return 1.0 / (ch * ch * (r2 * r2 - 1.0) + 1.0) ** 2

            inv = invert_cdf(pdf(theta), theta)
            vec = np.stack([np.cos(inv), np.sin(inv)], axis=-1)  # (ni, 2)

            slope = np.empty_like(vec)
            slope[0] = vec[1] - vec[0]
            slope[-1] = vec[-1] - vec[-2]
            slope[1:-1] = (vec[2:] - vec[:-2]) / 2.0
            dots = np.clip(np.sum(vec[1:] * vec[:-1], axis=-1), -1.0, 1.0)
            gaps = np.arccos(dots)  # angle between adjacent entries
            max_mag = np.full(ni, np.inf)
            max_mag[1:-1] = np.minimum(gaps[1:], gaps[:-1]) * 1.5
            slope_mag = np.minimum(max_mag, np.linalg.norm(slope, axis=-1))

            weight = np.ones(ni)
            weight[0] = weight[-1] = 0.0

            out[:, j, k, 0] = vec[:, 0]
            out[:, j, k, 1] = vec[:, 1]
            out[:, j, k, 2] = slope_mag
            out[:, j, k, 3] = weight

            if roughness == 0.0:
                # Perfect mirror: interior entries snap to the reflected dir.
                out[1:-1, j, k, 0] = np.cos(-incident_angle)
                out[1:-1, j, k, 1] = np.sin(-incident_angle)
                out[1:-1, j, k, 2] = 0.0
                out[1:-1, j, k, 3] = 1.0

    return out
