"""Carry state from the JAX package into the port.

`from_numpy` takes the JAX package's state as plain dicts of numpy arrays
(one key per dataclass field, as `{f: np.asarray(getattr(obj, f))}` gives
them) and builds the port's dataclasses of tensors on `device`. Tuples and
lists (the per-channel source buffers) become tuples of tensors, and a bare
array becomes a tensor. The port never sees a JAX type.
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
