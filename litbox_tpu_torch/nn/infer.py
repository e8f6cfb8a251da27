"""Tiled inference, blend factors and golden-set evaluation (counterpart of
the JAX package's nn/infer.py; reference: train_litbox_denoiser.py:283-360).

The per-frame blends (`blend_pair_symmetric`, `blend_from_pair`,
`blend_pair_banded`, `blend_prior_lookup`) take tensors and keep k on
their device: clamps and `torch.where`, no read-back to the host. Their
sums run in the inputs' dtype, in another order than XLA's, so they agree
with the JAX package to float32 rounding. The tiled inference and the
offline fits (`infer_large`, `fit_blend`, `fit_blend_prior`, `evaluate`)
are host loops over numpy images, as in the JAX package; `run_mono` takes
a CPU tensor of tiles and returns a tensor on any device.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..io.exr import write_exr_rgb
from ..io.images import read_image_linear, write_png


def infer_large(run_mono, img: np.ndarray, tile: int = 256, overlap: int = 32,
                batch: int = 8, rgb: bool = False,
                blend: float = 1.0) -> np.ndarray:
    """Denoise (H, W, C) channel-wise in overlapping tiles (the reference's
    infer_large with its boundary-crop scheme; boundary tiles keep their
    edge rows and columns, and the last tile is clamped to the image).

    run_mono maps (N, tile, tile, 1) -> (N, tile, tile, 1) (with rgb,
    (N, tile, tile, 3) in one pass); tiles x channels go through it in
    batches of `batch`, the last one padded with zeros. An input smaller
    than a tile is reflect-padded up to one tile and cropped back.
    """
    h, w, c = img.shape
    if h < tile or w < tile:
        if min(h, w) < 2:
            raise ValueError(f"input too small to denoise: {img.shape}")
        padded = img
        while padded.shape[0] < tile or padded.shape[1] < tile:
            py = min(tile - padded.shape[0], padded.shape[0] - 1)
            px = min(tile - padded.shape[1], padded.shape[1] - 1)
            padded = np.pad(padded, ((0, max(py, 0)), (0, max(px, 0)), (0, 0)),
                            mode="reflect")
        return infer_large(run_mono, padded, tile, overlap, batch,
                           rgb=rgb, blend=blend)[:h, :w]
    stride = tile - overlap
    out = np.zeros_like(img, dtype=np.float32)
    counts = np.zeros((h, w, 1), dtype=np.float32)
    inner = overlap // 2

    ys = list(range(0, max(h - overlap, 1), stride))
    xs = list(range(0, max(w - overlap, 1), stride))
    if ys and ys[-1] + tile > h:
        ys[-1] = max(0, h - tile)
    if xs and xs[-1] + tile > w:
        xs[-1] = max(0, w - tile)

    chans = [None] if rgb else list(range(c))
    work = [(y, x, ci) for y in dict.fromkeys(ys) for x in dict.fromkeys(xs)
            if y + tile <= h and x + tile <= w for ci in chans]

    for s in range(0, len(work), batch):
        group = work[s:s + batch]
        blocks = np.stack([img[y:y + tile, x:x + tile]
                           if ci is None else img[y:y + tile, x:x + tile,
                                                  ci:ci + 1]
                           for y, x, ci in group])
        pad = batch - len(group)
        if pad:
            blocks = np.concatenate([blocks, np.zeros((pad,) + blocks.shape[1:],
                                                      blocks.dtype)])
        res = run_mono(torch.from_numpy(np.ascontiguousarray(blocks, np.float32)))
        res = res.detach().float().cpu().numpy()[:len(group)]
        for (y, x, ci), r in zip(group, res):
            sl = slice(None) if ci is None else ci
            iy0 = inner if y > 0 else 0
            iy1 = inner if y + tile < h else 0
            ix0 = inner if x > 0 else 0
            ix1 = inner if x + tile < w else 0
            out[y + iy0:y + tile - iy1, x + ix0:x + tile - ix1, sl] += (
                r[iy0:tile - iy1, ix0:tile - ix1,
                  slice(None) if ci is None else 0])
            if ci is None or ci == 0:
                counts[y + iy0:y + tile - iy1, x + ix0:x + tile - ix1] += 1

    out = out / np.maximum(counts, 1.0)
    if blend != 1.0:
        # Residual-blend shrinkage: out = x + k (net(x) - x). See fit_blend.
        out = img + np.float32(blend) * (out - img)
    return out


def fit_blend(run_mono, pairs, rgb: bool = False, tile: int = 256,
              overlap: int = 32, batch: int = 8) -> float:
    """Closed-form calibration of the residual-blend factor k over
    (noisy, reference) HDR pairs: k* = sum <net(x)-x, ref-x> /
    sum |net(x)-x|^2, clipped to [0, 1]."""
    num = 0.0
    den = 0.0
    for noisy, ref in pairs:
        out = infer_large(run_mono, np.asarray(noisy, np.float32), tile,
                          overlap, batch, rgb=rgb)
        d = out - noisy
        num += float((d * (ref - noisy)).sum())
        den += float((d * d).sum())
    return float(np.clip(num / max(den, 1e-12), 0.0, 1.0))

# The shipped floor of the per-frame k (measured on the JAX package's
# training and held-out scenes): k_floor 0.5 behind the noise-evidence gate
# sigma_rel^2 > 1e-4.
PRODUCTION_K_FLOOR = 0.5
PRODUCTION_FLOOR_GATE = 1e-4


def blend_pair_symmetric(out_a: torch.Tensor, out_b: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12,
                         k_floor: float = 0.0, floor_gate: float | None = None):
    """Production auto-blend: returns (display, k) with

        display = x + k * dbar,   x = (a+b)/2,  dbar = (d_a+d_b)/2,  d_i = out_i - i,
        k = clip(<d_a - d_b, b - a> / 4 / max(<dbar, dbar>, eps), 0, 1),

    the cross-projection estimate of the MSE-optimal k from two independent
    tracers, raised to k_floor. With floor_gate the floor applies only when
    the pair disagrees: mean|a-b|^2 / max(mean(x^2), eps) > floor_gate.
    k is a 0-d tensor on the inputs' device.
    """
    d_a = out_a - a
    d_b = out_b - b
    dbar = (d_a + d_b) * 0.5
    num = ((d_a - d_b) * (b - a)).sum() * 0.25
    den = (dbar * dbar).sum()
    x = (a + b) * 0.5
    k = torch.clamp(num / torch.clamp(den, min=eps), 0.0, 1.0)
    floor = torch.full_like(k, k_floor)
    if floor_gate is not None:
        s2 = ((a - b) ** 2).mean() / torch.clamp((x * x).mean(), min=eps)
        floor = torch.where(s2 > floor_gate, floor, 0.0)
    k = torch.maximum(k, floor)
    return x + k * dbar, k


def blend_from_pair(out: torch.Tensor, x: torch.Tensor, other: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """Per-image residual-blend factor calibrated from the tracer pair:
    k = clip(<d, other - x> / max(<d, d>, eps), 0, 1) with d = out - x, a 0-d
    tensor on the inputs' device."""
    d = out - x
    num = (d * (other - x)).sum()
    den = (d * d).sum()
    return torch.clamp(num / torch.clamp(den, min=eps), 0.0, 1.0)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's "linear" method along one
    axis (antialiased: the triangle is widened by the scale when shrinking;
    half-pixel centres; each column renormalized; samples outside the input
    zeroed)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[None, :] - pos[:, None]).abs() / kernel_scale
    w = torch.clamp(1 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_linear(z: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jax.image.resize(z, (h, w), "linear") of a 2-D tensor."""
    out = z
    if h != z.shape[0]:
        out = _resize_weights(z.shape[0], h, z.device).T @ out
    if w != z.shape[1]:
        out = out @ _resize_weights(z.shape[1], w, z.device)
    return out


def blend_pair_banded(out_a, out_b, a, b, n_bands: int = 6, pool: int = 16,
                      lo: float = -6.0, hi: float = 0.0, gate: float = 0.01,
                      eps: float = 1e-12):
    """Spatially varying auto-blend: per-band k by the cross-projection of
    blend_pair_symmetric, bands partitioning pixels by their local noise
    index sigma_rel^2 = pool(|a-b|^2) / pool(lum(x))^2 (down and up by
    jax.image.resize's linear method), each pixel's weight split linearly
    between its two nearest log10-spaced bands; a band with less than
    `gate` of the correction energy takes the global k. (H, W, C) tensors;
    returns (display, k_map (H, W))."""
    d_a = out_a - a
    d_b = out_b - b
    dbar = (d_a + d_b) * 0.5
    x = (a + b) * 0.5

    h, w = a.shape[:2]
    hp, wp = max(1, h // pool), max(1, w // pool)

    def down_up(z):
        return _resize_linear(_resize_linear(z, hp, wp), h, w)

    diff2 = down_up(((a - b) ** 2).mean(-1))
    lum2 = down_up((x * x).mean(-1))
    s2 = diff2 / torch.clamp(lum2, min=eps)
    idx = torch.clamp((torch.log10(torch.clamp(s2, min=1e-30)) * 0.5 - lo)
                      / (hi - lo) * (n_bands - 1), 0.0, n_bands - 1.0)
    i0 = torch.floor(idx).long()
    t = idx - i0
    oh = (F.one_hot(i0, n_bands).to(t.dtype) * (1.0 - t)[..., None]
          + F.one_hot(torch.clamp(i0 + 1, max=n_bands - 1), n_bands).to(t.dtype)
          * t[..., None])                                   # (H, W, n_bands)

    num_p = ((d_a - d_b) * (b - a)).sum(-1) * 0.25          # (H, W)
    den_p = (dbar * dbar).sum(-1)
    n_band = (oh * num_p[..., None]).sum((0, 1))            # (n_bands,)
    d_band = (oh * den_p[..., None]).sum((0, 1))
    den_tot = torch.clamp(den_p.sum(), min=eps)
    k_glob = torch.clamp(num_p.sum() / den_tot, 0.0, 1.0)
    k_band = torch.clamp(n_band / torch.clamp(d_band, min=eps), 0.0, 1.0)
    k_band = torch.where(d_band > gate * den_tot, k_band, k_glob)
    k_map = (oh * k_band).sum(-1)                           # (H, W)
    return x + k_map[..., None] * dbar, k_map


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fit_blend_prior(samples, n_buckets: int = 6,
                    lo: float = -6.0, hi: float = 0.0) -> np.ndarray:
    """Fit the noise-indexed blend prior k_prior(sigma_rel) on training
    scenes (a diagnostic: the JAX package measured it losing on held-out
    tiers, so AIAccelerator takes it only as an explicit blend_prior=).

    samples: iterable of (out_a, out_b, a, b, ref) arrays or tensors.
    Returns a (n_buckets, 2) table [log10 sigma_rel, k*]; buckets with less
    than 0.1% of the correction energy fill directionally: 0 below the
    lowest fitted bucket, nearest-neighbor above the highest, linear
    interpolation in interior gaps."""
    num = np.zeros(n_buckets)
    den = np.zeros(n_buckets)
    centers = np.linspace(lo, hi, n_buckets)
    for out_a, out_b, a, b, ref in samples:
        out_a, out_b, a, b, ref = (_numpy(v) for v in (out_a, out_b, a, b, ref))
        x = (a + b) * 0.5
        dbar = ((out_a - a) + (out_b - b)) * 0.5
        s2 = float(((a - b) ** 2).mean() / max(float((x * x).mean()), 1e-12))
        i = int(np.clip(round((np.log10(max(s2, 1e-30)) / 2 - lo)
                              / (hi - lo) * (n_buckets - 1)), 0,
                        n_buckets - 1))
        num[i] += float((dbar * (ref - x)).sum())
        den[i] += float((dbar * dbar).sum())
    fitted = den > 1e-3 * max(den.sum(), 1e-12)
    k = np.where(fitted, np.clip(num / np.maximum(den, 1e-12), 0.0, 1.0),
                 np.nan)
    if np.isnan(k).all():
        k = np.zeros(n_buckets)
    else:
        idx = np.where(~np.isnan(k))[0]
        lo_fit, hi_fit = idx[0], idx[-1]
        for j in range(n_buckets):
            if not np.isnan(k[j]):
                continue
            if j < lo_fit:
                k[j] = 0.0
            elif j > hi_fit:
                k[j] = k[hi_fit]
            else:
                below = idx[idx < j][-1]
                above = idx[idx > j][0]
                t = (j - below) / (above - below)
                k[j] = (1 - t) * k[below] + t * k[above]
    return np.stack([centers, k], axis=-1)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp): piecewise linear in xp (increasing), clamped
    to fp[0] below xp[0] and to fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True)[0], 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def blend_prior_lookup(table, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k_prior for a pair by linear interpolation of the table (an (n, 2)
    array, or a float32 tensor on the pair's device, which costs no copy)
    over log10 sigma_rel, sigma_rel^2 = mean|a-b|^2 / mean(x^2); a 0-d
    tensor on the pair's device, with no host read."""
    x = (a + b) * 0.5
    s2 = ((a - b) ** 2).mean() / torch.clamp((x * x).mean(), min=1e-12)
    logs = torch.log10(torch.clamp(s2, min=1e-30)) * 0.5
    t = torch.as_tensor(table, dtype=torch.float32, device=a.device)
    return _interp(logs, t[:, 0].contiguous(), t[:, 1].contiguous())


def evaluate(run_mono, input_pattern: str, output_folder: str,
             tile: int = 256, overlap: int = 32) -> list[str]:
    """Denoise every file matching the pattern; write *_eval.{exr,png}."""
    os.makedirs(output_folder, exist_ok=True)
    written = []
    for path in sorted(glob.glob(input_pattern)):
        img = read_image_linear(path)
        out = infer_large(run_mono, img, tile, overlap)
        stem, ext = os.path.basename(path).rsplit(".", 1)
        out_path = os.path.join(output_folder, f"{stem}_eval.{ext}")
        if ext.lower() == "exr":
            write_exr_rgb(out_path, out)
        else:
            write_png(out_path, np.clip(out, 0, 1))
        written.append(out_path)
    return written
