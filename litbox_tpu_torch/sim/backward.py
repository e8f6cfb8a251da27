"""Backward (camera-side) gather (counterpart of the JAX package's
sim/backward.py; reference: BackwardMonteCarlo.compute:18-124,
BackwardMonteCarlo.cs).

`backward_gather` is the faithful march: one ray per output pixel per frame
from a jittered pixel origin, in an importance-lobed direction toward the
frame center (the teardrop LUT), marched to the frame edge, gathering the
forward pass's HDR radiance at stratified intervals weighted by the
cumulative transmissibility and 1/r^2. The result composes with the direct
forward light and the local outscatter,

    out = (gathered * albedo * lobe_weight + direct) * (1 - T_local),

and is accumulated over frames, then divided by the frame count.

`backward_gather_rbt` evaluates the same gather integral exactly along one
direction bin of the RBT engine's rotated fields for every pixel at once;
`backward_bin_for_frame` is the frame ladder that averages the bins.
Neither reaches a Pallas kernel in the JAX package: the march is plain
array work and the RBT gather dense batched products, so plain PyTorch is
their port. The products run in float32 (torch's default matmul precision;
TF32 would round the attenuation weights to 10 bits).
"""

from __future__ import annotations

import math

import torch

from ..core.sampling import sample_bilinear_uv
from ..core.types import GBuffer
from ..ops.resample import gather_bilinear
from .materials import scatter_importance_lobed
from .oracle import _escape_distance, _nonzero_dir


def _pair(x: float, y: float, dev) -> torch.Tensor:
    """(x, y) filled on the device: a tensor built from host numbers would be
    a copy that waits for the stream."""
    return torch.stack([torch.full((), float(x), device=dev),
                        torch.full((), float(y), device=dev)])


def backward_gather(gbuffer: GBuffer, forward_hdr: torch.Tensor,
                    teardrop_lut: torch.Tensor, generator: torch.Generator,
                    interval: float, importance_target_uv=(0.5, 0.5),
                    max_steps: int = 0) -> torch.Tensor:
    """One backward-gather frame: returns the (H, W, 3) sample to accumulate.

    The JAX version's `lax.scan` over max_steps (the frame diagonal + 4 by
    default) is a loop of vectorized steps here; each step draws two
    uniforms a pixel, as the JAX step draws from two keys, and nothing is
    read on the host."""
    height, width = gbuffer.transmissibility.shape
    dev = gbuffer.transmissibility.device
    if max_steps <= 0:
        max_steps = int((height**2 + width**2) ** 0.5) + 4
    size = _pair(width, height, dev)
    pixel = 1.0 / size

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    base = torch.stack([xs, ys], -1).to(torch.float32).reshape(-1, 2)
    n = base.shape[0]
    origin = base + torch.rand((n, 2), generator=generator, device=dev)

    target = _pair(*importance_target_uv, dev) * size
    direction, lobe_w = scatter_importance_lobed(
        teardrop_lut, origin, target, torch.rand((n,), generator=generator, device=dev))

    d = _nonzero_dir(direction)
    origin_uv = origin / size
    dir_uv = d / size
    uesc = _escape_distance(origin_uv, dir_uv, pixel)

    trans = torch.ones((n,), device=dev)
    gathered = torch.zeros((n, 3), device=dev)
    u_target = torch.rand((n,), generator=generator, device=dev) * interval
    sample_idx = torch.zeros((n,), device=dev)
    for k in range(max_steps):
        u_next = float(k + 1)
        t = sample_bilinear_uv(gbuffer.transmissibility, origin_uv + dir_uv * float(k))
        active = u_next <= uesc
        trans = torch.where(active, trans * t, trans)

        # Post-propagate state: testUV and uHitCurrent sit at u = k+1
        # (SimulationCommon.cginc:426-431) when the gather loop runs
        # (BackwardMonteCarlo.compute:62-76).
        radiance = sample_bilinear_uv(forward_hdr, origin_uv + dir_uv * u_next)[..., :3]
        weighted = radiance * (trans * (interval / (1e-5 + u_next * u_next)))[:, None]
        for _ in range(2):
            fire = active & (u_next > u_target)
            gathered = gathered + torch.where(fire[:, None], weighted, 0.0)
            xi = torch.rand((n,), generator=generator, device=dev)
            sample_idx = torch.where(fire, sample_idx + 1.0, sample_idx)
            u_target = torch.where(fire, (sample_idx + xi) * interval, u_target)

    gathered = gathered.reshape(height, width, 3)
    lobe_w = lobe_w.reshape(height, width, 1)
    albedo = gbuffer.albedo[..., :3]
    outscatter = (1.0 - gbuffer.transmissibility)[..., None]
    direct = forward_hdr[..., :3]
    return (gathered * albedo * lobe_w + direct) * outscatter


# Coprime stride so the bin ladder covers direction space near-uniformly
# long before a full cycle completes (backward_bin_for_frame).
_BIN_STRIDE = 47


def backward_bin_for_frame(frame: int, n_bins: int) -> int:
    """Direction bin for backward frame f: a coprime-stride ladder that
    visits every bin exactly once per n_bins frames (after a full cycle the
    accumulated gather is the exact integral over the D-quantized direction
    fan).

    The stride is searched upward from _BIN_STRIDE until gcd(stride,
    n_bins) == 1 (a fixed +2 fallback is not coprime for e.g. n_bins = 329
    = 7*47, where gcd(49, 329) = 7 would visit only 1/7 of the fan)."""
    stride = _BIN_STRIDE
    while math.gcd(stride, n_bins) != 1:
        stride += 2
    return (frame * stride) % n_bins


def backward_gather_rbt(fields, gbuffer: GBuffer, forward_hdr: torch.Tensor,
                        bin_index: int, block: int = 128) -> torch.Tensor:
    """One backward frame on the rotated-bin transport engine: the exact
    gather integral along direction bin `bin_index` for every pixel.

    In bin b's rotated frame every ray is a +x row, so for all rows y

        out[y, x0] = sum_{x > x0} exp(C[y,x] - C[y,x0]) / (x - x0)^2 * L_rot[y, x],

    an upper-triangular Toeplitz (1/r^2) contraction with exponential
    attenuation. exp(C[x] - C[x0]) would overflow float32 if factored
    naively, so the sum is rebased per `block` columns: C[x] - C[x0] =
    (C[x] - C_j0) + (C_j0 - C[x0]) with C_j0 the start of x's block, each
    exponent clipped to [-60, 0]; pairs within a block use their exact
    difference. S must be a multiple of `block`.

    The work is two float32 products: a batched (block x block) product
    per row and block (the (S, S/block, block, block) pair tensor), and one
    (S, block) x (block, 3S) product for each later block.
    """
    height, width = gbuffer.transmissibility.shape
    s = fields.size
    nb = s // block
    if nb * block != s:
        raise ValueError(f"field size {s} must be a multiple of block {block}")
    dev = fields.trans.device

    cb = fields.cos[bin_index]
    sb = fields.sin[bin_index]
    c = fields.cum_log[bin_index]                               # (S, S)

    # Rotate the radiance field into the bin frame.
    xs = torch.arange(s, dtype=torch.float32, device=dev) + 0.5 - s / 2.0
    rx = xs[None, :]
    ry = xs[:, None]
    px = cb * rx - sb * ry + fields.center[0]
    py = sb * rx + cb * ry + fields.center[1]
    pts = torch.stack([px, py], -1).reshape(-1, 2)
    l_rot = gather_bilinear(forward_hdr[..., :3], pts).reshape(s, s, 3)

    cblk = c.reshape(s, nb, block)
    lblk = l_rot.reshape(s, nb, block, 3)
    c_j0 = cblk[:, :, 0]                                        # (S, nb)

    # Within-block pairs: exact exponent differences.
    ar = torch.arange(block, dtype=torch.float32, device=dev)
    du = ar[None, :] - ar[:, None]                              # b - a
    k_in = torch.where(du > 0, 1.0 / torch.clamp(du, min=1.0) ** 2, 0.0)
    pair = torch.exp(torch.clamp(cblk[:, :, None, :] - cblk[:, :, :, None],
                                 -60.0, 0.0)) * k_in            # (S, nb, bl, bl)
    out = torch.bmm(pair.reshape(s * nb, block, block),
                    lblk.reshape(s * nb, block, 3)).reshape(s, s, 3)
    del pair

    # Cross-block: rebased at each source block's start.
    x0s = torch.arange(s, dtype=torch.float32, device=dev)
    ej = torch.exp(torch.clamp(cblk - c_j0[:, :, None], -60.0, 0.0))[..., None] * lblk
    for j in range(1, nb):
        xj = j * block + ar
        dx = xj[None, :] - x0s[:, None]
        kj = torch.where(dx > 0, 1.0 / torch.clamp(dx, min=1.0) ** 2, 0.0)   # (S, block)
        # pj[y, x0, ch] = sum_b kj[x0, b] * ej[y, j, b, ch]
        pj = (kj @ ej[:, j].permute(1, 0, 2).reshape(block, s * 3)).reshape(s, s, 3)
        w = torch.exp(torch.clamp(c_j0[:, j:j + 1] - c, -60.0, 0.0))
        w = torch.where(x0s[None, :] < j * block, w, 0.0)        # later x0: within
        out = out + w[..., None] * pj.permute(1, 0, 2)

    # Sample the per-pixel result back in the target frame.
    ys, xs2 = torch.meshgrid(torch.arange(height, device=dev),
                             torch.arange(width, device=dev), indexing="ij")
    pix = torch.stack([xs2 + 0.5, ys + 0.5], -1).reshape(-1, 2).to(torch.float32)
    rel = pix - fields.center
    xr = cb * rel[:, 0] + sb * rel[:, 1] + s / 2.0
    yr = -sb * rel[:, 0] + cb * rel[:, 1] + s / 2.0
    gathered = gather_bilinear(out, torch.stack([xr, yr], -1)).reshape(height, width, 3)

    albedo = gbuffer.albedo[..., :3]
    outscatter = (1.0 - gbuffer.transmissibility)[..., None]
    direct = forward_hdr[..., :3]
    return (gathered * albedo + direct) * outscatter
