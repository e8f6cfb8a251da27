"""The shipped realtime 1080p frame: two tracers, a deferred scatter flush,
one grouped per-tracer resolve per frame, the pair-blended denoised display
at the profile's precision, a 4x bilinear upsample and the Uchimura tone map
(counterpart of the JAX package's runs/bench_1080p.py --pair-fast:
frame_step_pair_fast :370-413 with frame_deposits :356, resolve_group_pair
:302 and denoise_pair :465, on core/types.py::REALTIME_1080P).

One frame, in the JAX order:
  1. deposits of `photons` direct + `bounce_photons` bounce photons over two
     tracers (`rbt_frame_deposits(n_tracers=2)`, the stamp histogram and
     stratified bounce chains), written IN PLACE into slot r % FLUSH_K of a
     pending (FLUSH_K, M) index and (FLUSH_K, M, 3) value buffer;
  2. every FLUSH_K-th frame, one `_inject_flat` of the K pending streams into
     the tracer-major sources 3 x (2D, S, S);
  3. one grouped resolve: tracer r % 2, group (r // 2) % K of the profile's
     K resolve groups, into its slot of the (2, K, H, W, 3) partial cache;
  4. every CAL-th frame the exact pair display (`to_hdr` of both tracers,
     `denoise_pair_auto`), which refreshes k; on the other frames one UNet
     pass on the pair mean, x + k_prev * (net(x) - x);
  5. the display cast to the net's precision, upsampled to the profile's
     output size and tone-mapped.

The frame runs eagerly (no CUDA graph). The frame index is kept twice: `r`
on the device, as the JAX carry (it divides the HDR), and `frame` on the
host, which selects the slot, the group and the display branch without
reading the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.types import REALTIME_1080P, Realtime1080pProfile
from ..nn.unet import LitboxDenoiserNet, TransformConfig
from ..post.tonemap import UchimuraShape, tonemap_uchimura
from ..sim import rbt
from ..sim.oracle import to_hdr
from .pipeline import _weights_dtype, denoise_hdr, denoise_pair_auto

# runs/bench_1080p.py's defaults (:353-354): flush the pending deposits every
# FLUSH_K frames, refresh k with the exact pair display every CAL frames.
FLUSH_K = 8
CAL = 8

# The shipped display net (runs/denoiser_r5/model_best.npz.json).
SHIPPED_NET = dict(unet_size=4, initial_features=16, padding_mode="reflect",
                   global_residual=True, out_channels=3)
SHIPPED_TRANSFORM = TransformConfig(use_log_space=True, normalize_input=True)

# The trace options of the shipped frame (frame_deposits :356-362).
TRACE_OPTS = dict(max_bounces=2, mc_direct=True, analytic_direct=False,
                  enable_brdf=False, light_kinds=(1,), hist_direct=True,
                  n_tracers=2)


@dataclasses.dataclass
class PairFrameState:
    """Everything one frame reads and writes, updated in place."""

    src2: tuple               # 3 x (2D, S, S) tracer-major sources
    cache: torch.Tensor       # (2, K, H, W, 3) grouped resolve partials
    pend_flat: torch.Tensor   # (FLUSH_K, M) pending deposit cells
    pend_vals: torch.Tensor   # (FLUSH_K, M, 3) pending deposit values
    k_prev: torch.Tensor      # () the last calibrated blend factor
    r: torch.Tensor           # () int32 frame index on the device
    frame: int                # the same index on the host


def display_weights(model_variables: dict, prof: Realtime1080pProfile = REALTIME_1080P) -> dict:
    """The net's state_dict at the profile's display precision: every
    floating-point tensor in bf16 when `bf16_display` is set (the JAX frame
    casts its Flax variables so)."""
    if not prof.bf16_display:
        return dict(model_variables)
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in model_variables.items()}


def upsample(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(h, w, C) -> (height, width, C) bilinear, in x's dtype: the
    counterpart of jax.image.resize(x, (height, width, C), "bilinear") for
    an enlargement. Half-pixel centres; at the border jax renormalizes its
    triangle kernel over the taps inside the image, which for an
    enlargement is the clamp of the source coordinate that F.interpolate
    applies."""
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(height, width),
                        mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0)


def make_pair_frame_step(gbuffer, lights, field_textures, brdf_lut,
                         fields: rbt.RotatedFields, model_variables: dict,
                         prof: Realtime1080pProfile = REALTIME_1080P,
                         net: dict = SHIPPED_NET,
                         transform: TransformConfig = SHIPPED_TRANSFORM):
    """Build the shipped frame over explicit state.

    Returns (init_state, step):
      init_state() -> PairFrameState, zeroed, with k_prev = 0.5 and r = 0;
      step(state, generator, mark=None) -> (display (OUT_H, OUT_W, 3) in the
        net's dtype, k) runs one frame and advances the state in place.
        `mark(name)`, when given, is called after each stage ("deposits",
        "flush", "resolve", "display_cal" or "display_fast",
        "upsample_tonemap"), e.g. to record CUDA events.

    model_variables is the display net's state_dict (see `display_weights`),
    moved once to the fields' device; `net` is its architecture and
    `transform` its input transform (a checkpoint's saved config gives
    both). The net's module is built on the meta device and holds no
    weights.
    """
    height, width = gbuffer.transmissibility.shape
    dev = fields.trans.device
    groups = prof.resolve_groups
    with torch.device("meta"):
        model = LitboxDenoiserNet(**net)
    variables = {k: v.to(dev) for k, v in model_variables.items()}
    display_dtype = _weights_dtype(model, variables)

    def deposits(generator):
        return rbt.rbt_frame_deposits(
            fields, gbuffer, lights, field_textures, brdf_lut, generator,
            prof.photons, -1, bounce_photons=prof.bounce_photons, **TRACE_OPTS)

    def init_state() -> PairFrameState:
        # The stream's length M from one sizing frame (its values unused).
        flat, vals, _ = deposits(torch.Generator(device=dev).manual_seed(0))
        return PairFrameState(
            src2=rbt.zero_sources(fields, n_tracers=2),
            cache=torch.zeros((2, groups, height, width, 3), device=dev),
            # Unwritten slots are harmless: cell 0, value 0.
            pend_flat=torch.zeros((FLUSH_K,) + tuple(flat.shape), dtype=flat.dtype,
                                  device=dev),
            pend_vals=torch.zeros((FLUSH_K,) + tuple(vals.shape), device=dev),
            k_prev=torch.tensor(0.5, device=dev),
            r=torch.zeros((), dtype=torch.int32, device=dev), frame=0)

    def step(state: PairFrameState, generator: torch.Generator,
             mark: Callable[[str], None] | None = None):
        mark = mark or (lambda _: None)
        i = state.frame
        flat, vals, _ = deposits(generator)
        slot = i % FLUSH_K
        state.pend_flat[slot].copy_(flat)
        state.pend_vals[slot].copy_(vals)
        mark("deposits")
        if slot == FLUSH_K - 1:
            rbt._inject_flat(state.src2, state.pend_flat.view(-1),
                             state.pend_vals.view(-1, 3))
        mark("flush")
        t, g = i % 2, (i // 2) % groups
        state.cache[t, g] = rbt.resolve_raw(fields, state.src2, height, width,
                                            group=g, n_groups=groups, tracer=t)
        raw_a, raw_b = state.cache[0].sum(0), state.cache[1].sum(0)
        mark("resolve")
        iters = (state.r + 1).float()
        if i % CAL == 0:
            hdr_a = to_hdr(raw_a, iters, gbuffer, finalize_outscatter=True)
            hdr_b = to_hdr(raw_b, iters, gbuffer, finalize_outscatter=True)
            disp, k = denoise_pair_auto(model, variables, hdr_a, hdr_b, transform)
            mark("display_cal")
        else:
            hdr_x = to_hdr((raw_a + raw_b) * 0.5, iters, gbuffer,
                           finalize_outscatter=True)
            out_x = denoise_hdr(model, variables, hdr_x, transform)
            disp, k = hdr_x + state.k_prev * (out_x - hdr_x), state.k_prev
            mark("display_fast")
        pix = tonemap_uchimura(upsample(disp.to(display_dtype), prof.out_height,
                                        prof.out_width) * 0.5, UchimuraShape())
        mark("upsample_tonemap")
        state.k_prev = k
        state.r += 1
        state.frame += 1
        return pix, k

    return init_state, step
