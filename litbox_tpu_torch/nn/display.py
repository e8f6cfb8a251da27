"""Training progress display (counterpart of the JAX package's nn/display.py;
reference: litbox_display.py).

An input / output / target panel written to a PNG (or shown in a window
with `interactive`). matplotlib is imported inside `show`, so the module
imports where it is not installed; tensors on any device are read to the
host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class DenoiserDisplay:
    """Input / output / target panel writer (litbox_display.py:6-73)."""

    def __init__(self, out_path: str | None = None, interactive: bool = False):
        self.out_path = out_path
        self.interactive = interactive
        self._fig = None

    def show(self, inputs, outputs, targets):
        import matplotlib

        if not self.interactive:
            matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        def prep(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().float().cpu().numpy()
            x = np.asarray(x)
            if x.ndim == 4:
                x = x[0]
            if x.shape[-1] == 1:
                x = x[..., 0]
            return np.clip(x, 0, np.percentile(x, 99) + 1e-6)

        if self._fig is None:
            self._fig, self._axes = plt.subplots(1, 3, figsize=(9, 3))
            for ax, title in zip(self._axes, ("input", "output", "target")):
                ax.set_title(title)
                ax.axis("off")
        for ax, img in zip(self._axes, (inputs, outputs, targets)):
            for artist in list(ax.images):
                artist.remove()
            ax.imshow(prep(img), cmap="magma")
        if self.out_path:
            os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
            self._fig.savefig(self.out_path, dpi=80)
        if self.interactive:
            plt.pause(0.01)

    def shutdown(self):
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None
