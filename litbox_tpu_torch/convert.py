"""Carry state from the JAX package into the port.

`from_numpy` takes the JAX package's state as plain dicts of numpy arrays
(one key per dataclass field, as `{f: np.asarray(getattr(obj, f))}` gives
them) and builds the port's dataclasses of tensors on `device`. Tuples and
lists (the per-channel source buffers) become tuples of tensors, and a bare
array becomes a tensor. The port never sees a JAX type.

`unet_from_flax` turns the JAX package's Flax UNet variables
(`{"params", "batch_stats"}`, nested dicts of numpy arrays) into the
state_dict of the port's `nn.unet.LitboxDenoiserNet`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import GBuffer
from .scene.scene import Lights, Scene, Shapes
from .sim.rbt import RotatedFields

_LAYOUTS = {frozenset(f.name for f in dataclasses.fields(cls)): cls
            for cls in (GBuffer, Lights, Shapes, Scene, RotatedFields)}


def from_numpy(tree, device: str | torch.device = "cuda"):
    """Dict/tuple/array tree of numpy data -> the port's tensors on `device`.

    A dict must hold exactly the fields of GBuffer, Lights, Shapes, Scene or
    RotatedFields; its values are converted recursively."""
    if isinstance(tree, dict):
        cls = _LAYOUTS.get(frozenset(tree))
        if cls is None:
            raise ValueError(f"no port type has the fields {sorted(tree)}")
        return cls(**{k: from_numpy(v, device) for k, v in tree.items()})
    if isinstance(tree, (tuple, list)):
        return tuple(from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# Flax leaf name -> the port's, per collection. A conv kernel (kh, kw, I, O)
# becomes a torch weight (O, I, kh, kw).
_UNET_LEAVES = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
                ("batch_stats", "var"): "running_var"}


def unet_from_flax(variables: dict, **arch) -> dict:
    """Flax `{"params", "batch_stats"}` of the JAX package's
    LitboxDenoiserNet -> the port's state_dict (CPU tensors).

    Module paths carry over by name (Flax's `Conv_0` is the port's `conv`);
    conv kernels are transposed (kh, kw, I, O) -> (O, I, kh, kw) and
    BatchNorm scale/bias/mean/var become weight/bias/running_mean/
    running_var. `arch` (unet_size, initial_features, out_channels,
    global_residual, ...) builds the port's net to check that every tensor
    of it is given, with its shape."""
    from .nn.unet import LitboxDenoiserNet

    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})).items():
            name = _UNET_LEAVES[(collection, path[-1])]
            mods = ["conv" if p == "Conv_0" else p for p in path[:-1]]
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            state[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    with torch.device("meta"):
        expect = LitboxDenoiserNet(**arch).state_dict()
    for key, ref in expect.items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long)
        elif key not in state or tuple(state[key].shape) != tuple(ref.shape):
            raise ValueError(f"{key}: {tuple(ref.shape)} expected, got "
                             f"{tuple(state[key].shape) if key in state else 'nothing'}")
    extra = set(state) - set(expect)
    if extra:
        raise ValueError(f"Flax variables the port's net does not have: {sorted(extra)}")
    return state
