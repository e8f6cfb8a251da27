"""Training losses (counterpart of the JAX package's nn/loss.py; reference:
litbox_loss.py).

HdrLoss: adaptive-weighted L2 + Sobel gradient L1 + plain L1
(litbox_loss.py:8-75), production coefficients alpha=1.5, beta=0.4,
gamma=0.2, base_weight=0.5 (train_litbox_denoiser.py:44-47,179).
SSIM is provided for evaluation parity (litbox_loss.py:156-198).
KPCN's loss (`log1p_l1`) is the L1 in the log1p domain its kernel is
applied in.

Images are NHWC, as in the JAX package. The 3x3 Sobel filters and SSIM's
Gaussian window are grouped `F.conv2d` calls in float32 ('same' zero
padding, one filter per channel). The gradients follow jax's at ties: the
maxima that the JAX version takes with `jnp.maximum` against a constant are
`torch.maximum` against a tensor of it (the gradient splits evenly at a
tie), and |x| has the slope 1 at x = 0, as jnp.abs has (torch.abs has 0),
which matters wherever pred equals target, as in the exact zeros of MC
renders.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F



def _sobel(device) -> tuple[torch.Tensor, torch.Tensor]:
    """SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]] and its transpose
    SOBEL_Y, made on `device` (no copy from the host, so no host sync)."""
    r = torch.arange(-1.0, 2.0, device=device)
    sx = (2.0 - r.abs())[:, None] * r[None, :]
    return sx, sx.T


def _depthwise(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """'same' depthwise correlation of NHWC x with the (kh, kw) filter k."""
    c = x.shape[-1]
    weight = k.to(x.dtype).expand(c, 1, *k.shape)
    pad = (k.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=pad, groups=c)
    return y.permute(0, 2, 3, 1)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at x = 0."""
    return torch.where(x >= 0, x, -x)


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of value on x's device and dtype, filled there."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _max(x: torch.Tensor, value: float) -> torch.Tensor:
    """jnp.maximum(x, value): the gradient halves where x equals value."""
    return torch.maximum(x, _full(x, value))


@dataclasses.dataclass(frozen=True)
class HdrLossConfig:
    alpha: float = 1.5        # bright-pixel weight exponent
    beta: float = 0.4         # gradient term weight
    gamma: float = 0.2        # plain L1 weight
    base_weight: float = 0.5  # dark bias
    # Optional ceiling on the adaptive weight (None = reference behavior).
    weight_cap: float | None = None
    # Normalize the adaptive-L2 term by the batch-mean weight (no gradient
    # through the mean): the reference's relative bright-pixel emphasis in
    # MSE units.
    normalize_weights: bool = False
    # Weight of a relative-error (log-space) L1 term:
    #   mean |log2(relu(pred)+eps) - log2(target+eps)|.
    log_l1: float = 0.0
    log_eps: float = 1e-5
    # 'log1p' computes the adaptive-L2/gradient/L1 terms on log2(1 + x).
    compress: str = "none"
    # Weight of a bounded relative L2 term on the uncompressed values:
    #   mean(((pred - target) / (target + rel_eps))^2).
    rel_l2: float = 0.0
    rel_eps: float = 1.0


def hdr_loss(pred: torch.Tensor, target: torch.Tensor,
             cfg: HdrLossConfig = HdrLossConfig()) -> torch.Tensor:
    """The HDR loss of NHWC pred against target, a 0-d tensor."""
    raw_pred, raw_target = pred, target
    if cfg.compress == "log1p":
        pred = torch.log2(1.0 + _max(pred, -0.5))
        target = torch.log2(1.0 + _max(target, 0.0))
    weights = (target + cfg.base_weight) ** cfg.alpha
    if cfg.weight_cap is not None:
        weights = torch.minimum(weights, _full(weights, cfg.weight_cap))
    if cfg.normalize_weights:
        weights = weights / _max(weights.mean(), 1e-12).detach()
    adaptive_l2 = torch.mean(weights * (pred - target) ** 2)

    sx, sy = _sobel(pred.device)
    gradient = (torch.mean(_abs(_depthwise(pred, sx) - _depthwise(target, sx)))
                + torch.mean(_abs(_depthwise(pred, sy) - _depthwise(target, sy))))

    l1 = torch.mean(_abs(pred - target))
    loss = adaptive_l2 + cfg.beta * gradient + cfg.gamma * l1
    if cfg.rel_l2:
        rel = (raw_pred - raw_target) / (_max(raw_target, 0.0) + cfg.rel_eps)
        loss = loss + cfg.rel_l2 * torch.mean(rel * rel)
    if cfg.log_l1:
        rel = _abs(torch.log2(_max(raw_pred, 0.0) + cfg.log_eps)
                   - torch.log2(_max(raw_target, 0.0) + cfg.log_eps))
        loss = loss + cfg.log_l1 * torch.mean(rel)
    return loss


def log1p_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KPCN's loss, the mean of |pred - log1p(target)| (Bako et al. 2017,
    the specular branch's transform): pred is already in the log1p domain,
    target linear, both of one layout. |x| has jnp.abs's slope 1 at 0."""
    return torch.mean(_abs(pred - torch.log1p(target)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over NHWC batches (litbox_loss.py:156-198), in float32."""
    a, b = a.float(), b.float()
    w = _gaussian_window(window_size, 1.5, a.device)
    mu_a = _depthwise(a, w)
    mu_b = _depthwise(b, w)
    mu_a2, mu_b2, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    # Variances are non-negative by definition; E[x^2] - E[x]^2 can dip
    # below zero in float32.
    s_a = torch.clamp(_depthwise(a * a, w) - mu_a2, min=0.0)
    s_b = torch.clamp(_depthwise(b * b, w) - mu_b2, min=0.0)
    s_ab = _depthwise(a * b, w) - mu_ab
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    out = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / ((mu_a2 + mu_b2 + c1) * (s_a + s_b + c2))
    return out.mean()


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(peak ** 2 / torch.clamp(mse, min=1e-12))
