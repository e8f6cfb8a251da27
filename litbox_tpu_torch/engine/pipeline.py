"""Realtime pipeline: trace -> resolve -> HDR -> denoise -> tone map
(counterpart of the JAX package's engine/pipeline.py, BASELINE config 5).

The JAX package jits the frame into one XLA program; here each stage runs
eagerly on the device its inputs lie on. `AIAccelerator` hosts the
denoiser on a `Simulation`; `denoise_pair_auto` is the body of its
dual-tracer display step.

The UNet runs at the precision of its weights: with bf16 weights (the
realtime profile's `bf16_display`) its input is cast to bf16 and its output
back to the input's dtype, as the JAX package's 1080p frame does around its
denoiser calls.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from ..nn.infer import (PRODUCTION_FLOOR_GATE, PRODUCTION_K_FLOOR, blend_pair_symmetric,
                        blend_prior_lookup)
from ..nn.unet import LitboxDenoiserNet, TransformConfig, post_transform, pre_transform
from ..post.tonemap import UchimuraShape, UE5Shape, tonemap_uchimura, tonemap_ue5
from ..sim import rbt
from ..sim.oracle import to_hdr


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_photons: int = 1_000_000
    max_bounces: int = 2
    tonemap: str = "ue5"  # 'ue5' | 'uchimura' | 'none'
    exposure: float = 0.0
    denoise: bool = True
    denoise_blend: float = 1.0  # residual-blend factor k (nn.infer.fit_blend)
    unet_size: int = 5
    initial_features: int = 32
    transform: TransformConfig = dataclasses.field(default_factory=TransformConfig)


def _pad32(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reflect-pad an NHWC batch to multiples of 32 in H and W."""
    ph = (32 - h % 32) % 32
    pw = (32 - w % 32) % 32
    if not (ph or pw):
        return x
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)


def _weights_dtype(model: LitboxDenoiserNet, model_variables) -> torch.dtype:
    weights = model.parameters() if model_variables is None else model_variables.values()
    return next(w.dtype for w in weights if w.is_floating_point())


def _run_net(model: LitboxDenoiserNet, model_variables, x: torch.Tensor,
             transform: TransformConfig) -> torch.Tensor:
    """pre_transform, the net with `model_variables` as its weights (the
    module's own when None; the counterpart of Flax's model.apply), then
    post_transform, all at the weights' dtype; the result is in x's dtype."""
    xin, stats = pre_transform(x.to(_weights_dtype(model, model_variables)), transform)
    with torch.no_grad():
        if model_variables is None:
            out = model(xin)
        else:
            out = torch.func.functional_call(model, dict(model_variables), (xin,),
                                             strict=True)
    return post_transform(out, stats, transform).to(x.dtype)


def denoise_hdr(model: LitboxDenoiserNet, model_variables,
                hdr: torch.Tensor, transform: TransformConfig,
                blend: float = 1.0) -> torch.Tensor:
    """Run the UNet over an (H, W, 3) HDR image: the mono net takes the
    channels as batch, the RGB net one image. Reflect-pads to multiples of
    32 (2^unet_size pool levels) so any sim size works, e.g. the 480x272
    quarter-1080p target. model_variables is a state_dict of the net on the
    image's device, or None for the module's own weights."""
    h, w = hdr.shape[:2]
    x = hdr[None] if model.out_channels == 3 else hdr.permute(2, 0, 1)[..., None]
    out = _run_net(model, model_variables, _pad32(x, h, w), transform)
    if model.out_channels == 3:
        out = out[0, :h, :w, :]
    else:
        out = out[:, :h, :w, 0].permute(1, 2, 0)
    if blend != 1.0:
        # Residual-blend shrinkage (nn.infer.fit_blend); k=1 is the net output.
        out = hdr + blend * (out - hdr)
    return out


def denoise_pair_hdr(model: LitboxDenoiserNet, model_variables,
                     a: torch.Tensor, b: torch.Tensor,
                     transform: TransformConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Denoise both tracers of the dual-tracer pair in one batched pass: mono
    nets see (6, H, W, 1), the RGB net (2, H, W, 3)."""
    h, w = a.shape[:2]
    if model.out_channels == 3:
        x = torch.stack([a, b])
    else:
        x = torch.cat([a.permute(2, 0, 1)[..., None], b.permute(2, 0, 1)[..., None]])
    out = _run_net(model, model_variables, _pad32(x, h, w), transform)
    if model.out_channels == 3:
        return out[0, :h, :w, :], out[1, :h, :w, :]
    out = out[:, :h, :w, 0]
    return out[:3].permute(1, 2, 0), out[3:].permute(1, 2, 0)


def denoise_pair_auto(model: LitboxDenoiserNet, model_variables,
                      a: torch.Tensor, b: torch.Tensor,
                      transform: TransformConfig,
                      blend_prior=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The dual-tracer display of the JAX package's AIAccelerator with
    blend='auto' (its run_auto): denoise both tracers' HDR images in one
    batched pass and show the k-blended pair mean, k from
    `blend_pair_symmetric` with the shipped floor and gate, raised to the
    prior's k (`blend_prior_lookup`) when a blend_prior table is given.
    Returns (display (H, W, 3), k as a 0-d tensor on the images' device)."""
    out_a, out_b = denoise_pair_hdr(model, model_variables, a, b, transform)
    disp, k = blend_pair_symmetric(out_a, out_b, a, b, k_floor=PRODUCTION_K_FLOOR,
                                   floor_gate=PRODUCTION_FLOOR_GATE)
    if blend_prior is not None:
        k = torch.maximum(k, blend_prior_lookup(blend_prior, a, b))
        x = (a + b) * 0.5
        dbar = ((out_a - a) + (out_b - b)) * 0.5
        disp = x + k * dbar
    return disp, k


class AIAccelerator:
    """In-engine denoiser: runs the UNet on the simulation's output after
    every step and exposes HDR + tone-mapped outputs (the enabled version of
    the reference's AIAccelerator, AIAccelerator.cs:57-84).

    model_variables is the net's state_dict (as `convert.unet_from_flax`
    gives it), moved once to the simulation's device; the module itself is
    built on the meta device. blend="auto" denoises both tracers' outputs
    in one batched pass and shows their k-blended mean (denoise_pair_auto,
    k from the pair with the shipped floor and gate; `last_blend` holds k);
    a float blend runs the net on the pair mean with that residual blend.
    blend_prior, a (n, 2) table from nn.infer.fit_blend_prior, raises the
    auto k to the prior's (a diagnostic the JAX package measured losing on
    held-out tiers; never loaded on its own, only given explicitly).
    """

    def __init__(self, simulation, model_variables: Mapping[str, torch.Tensor],
                 unet_size: int = 5, initial_features: int = 32,
                 transform: TransformConfig | None = None,
                 tonemap: str = "ue5", blend: float | str = 1.0,
                 blend_prior=None, out_channels: int = 1,
                 padding_mode: str = "reflect", global_residual: bool = False):
        self.simulation = simulation
        self.transform = transform or TransformConfig()
        self.tonemap = tonemap
        self.blend = blend
        self.blend_prior = (None if blend_prior is None else
                            torch.as_tensor(blend_prior, dtype=torch.float32,
                                            device=simulation.device))
        with torch.device("meta"):
            self.model = LitboxDenoiserNet(unet_size=unet_size,
                                           initial_features=initial_features,
                                           out_channels=out_channels,
                                           padding_mode=padding_mode,
                                           global_residual=global_residual)
        self.model_variables = {k: v.to(simulation.device)
                                for k, v in model_variables.items()}
        self.hdr_output: torch.Tensor | None = None
        self.tonemapped_output: torch.Tensor | None = None
        self.last_blend: torch.Tensor | None = None  # k of the last step (auto)
        simulation.on_step.append(self._on_step)

    def _on_step(self, _iteration=None):
        if self.blend == "auto":
            self.hdr_output, self.last_blend = denoise_pair_auto(
                self.model, self.model_variables,
                self.simulation.tracer_a.tracer_output,
                self.simulation.tracer_b.tracer_output, self.transform,
                blend_prior=self.blend_prior)
        else:
            self.hdr_output = denoise_hdr(
                self.model, self.model_variables,
                self.simulation.simulation_output_hdr, self.transform,
                blend=float(self.blend))
        if self.tonemap == "uchimura":
            self.tonemapped_output = tonemap_uchimura(self.hdr_output, UchimuraShape())
        else:
            self.tonemapped_output = tonemap_ue5(self.hdr_output, UE5Shape())

    @classmethod
    def from_checkpoint(cls, simulation, ckpt_path: str, **kwargs):
        """Build an AIAccelerator whose architecture and transform match the
        checkpoint's saved TrainConfig (nn.train.load_train_config), from a
        checkpoint of either package. It never loads a `*_blend_prior.npy`
        beside the weights: pass blend_prior=... explicitly."""
        from ..nn.train import Trainer, load_train_config

        cfg = load_train_config(ckpt_path)
        trainer = Trainer(cfg, device=simulation.device)
        trainer.load(ckpt_path)
        return cls(simulation, trainer.model.state_dict(),
                   unet_size=cfg.unet_size,
                   initial_features=cfg.initial_features,
                   transform=cfg.transform,
                   out_channels=3 if cfg.rgb else 1,
                   padding_mode=cfg.padding_mode,
                   global_residual=cfg.global_residual, **kwargs)

    def detach(self):
        if self._on_step in self.simulation.on_step:
            self.simulation.on_step.remove(self._on_step)


def make_frame_fn(cfg: PipelineConfig, gbuffer, lights, field_textures, brdf_lut,
                  fields: rbt.RotatedFields,
                  model_variables: Mapping[str, torch.Tensor] | None = None):
    """Build the frame function.

    Returns frame(src_accum, iterations, generator) -> (src_accum, display,
    hdr). src_accum threads frame to frame (temporal accumulation in rotated
    space) and is updated IN PLACE, the counterpart of the JAX version's
    donated buffer. model_variables is the mono UNet's state_dict (as
    `convert.unet_from_flax` gives it), moved once to the fields' device;
    the module itself holds no weights (it is built on the meta device).

    The stages are also exposed as `frame.stages`, a dict of
    trace(src_accum, generator), resolve_hdr(src_accum, iterations),
    denoise(hdr) and tonemap(x), which `frame` runs in that order.
    """
    height, width = gbuffer.transmissibility.shape
    model = variables = None
    if cfg.denoise and model_variables is not None:
        with torch.device("meta"):
            model = LitboxDenoiserNet(unet_size=cfg.unet_size,
                                      initial_features=cfg.initial_features)
        variables = {k: v.to(fields.trans.device) for k, v in model_variables.items()}

    def trace(src_accum, generator):
        src_accum, _ = rbt.rbt_trace_frame(
            fields, src_accum, gbuffer, lights, field_textures, brdf_lut,
            generator, cfg.n_photons, -1, max_bounces=cfg.max_bounces)
        return src_accum

    def resolve_hdr(src_accum, iterations):
        raw = rbt.resolve_raw(fields, src_accum, height, width)
        return to_hdr(raw, iterations, gbuffer, finalize_outscatter=True)

    def denoise(hdr):
        if model is None:
            return hdr
        # Channels as batch: (3, H, W, 1) through the mono UNet.
        return denoise_hdr(model, variables, hdr, cfg.transform,
                           blend=cfg.denoise_blend)

    def tonemap(x):
        x = x * (10.0 ** cfg.exposure)
        if cfg.tonemap == "ue5":
            return tonemap_ue5(x, UE5Shape(exposure=0.0))
        if cfg.tonemap == "uchimura":
            return tonemap_uchimura(x, UchimuraShape())
        return x

    def frame(src_accum, iterations, generator):
        src_accum = trace(src_accum, generator)
        hdr = resolve_hdr(src_accum, iterations)
        display = tonemap(denoise(hdr))
        return src_accum, display, hdr

    frame.stages = dict(trace=trace, resolve_hdr=resolve_hdr, denoise=denoise,
                        tonemap=tonemap)
    return frame
