"""Denoiser dataset (counterpart of the JAX package's nn/dataset.py;
reference: litbox_dataset.py).

Host-side numpy, as in the JAX package: for one np.random.Generator the
batches are the same as that package's, bit for bit.

Loads aligned 5-tuples (input_a, input_b, albedo, transmissibility,
reference), with random 256-crop, optional jittered-stride subsampling for
upsample training (with the transmissibility**upsample correction,
litbox_dataset.py:129-136), and random 90-degree rotations. The reference
file's known bugs (__len__ on a nonexistent attribute, the static-method
self confusion in jittered_subsample) are not replicated — SURVEY.md
section 2.6 calls for the intent, not the bugs.

`batches` draws each item's crop, offsets and quarter turns up front and
makes pixels only when read: a `Batch` makes an array whole on its first
read, or one channel of each item (`Batch.channel`, what the mono training
step sends), with the same bits either way.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import glob

import numpy as np

from ..core import spans
from ..io.images import read_image_linear

NAMES = ("input_a", "input_b", "albedo", "transmissibility", "reference")
_INDEX = {name: j for j, name in enumerate(NAMES)}
_SCALED = (0, 1, 4)  # input A, input B, reference: radiance


@dataclasses.dataclass
class DenoiserDataset:
    input_a_paths: list[str]
    input_b_paths: list[str]
    albedo_paths: list[str]
    transmissibility_paths: list[str]
    reference_paths: list[str] | None = None
    crop_size: int = 256
    upsample: int = 1
    # Per-item radiance scale (the factory's auto-exposure 10**exposure,
    # data/factory.py:175): applied to input_a/input_b/reference so the HDR
    # loss weighting sees comparable magnitudes across scenes whose light
    # intensities span orders of magnitude. Albedo/transmissibility are
    # unitless and stay unscaled.
    scales: list[float] | None = None
    # Decoded-image RAM cache: a 256^2 float32 RGB frame is 768 KB, so even
    # hundreds of scenes fit comfortably; epochs after the first do zero IO.
    cache_images: bool = True

    def __post_init__(self):
        self._cache: dict = {}
        n = len(self.input_a_paths)
        for name in ("input_b_paths", "albedo_paths", "transmissibility_paths"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"{name} length != input_a_paths length")
        if self.reference_paths is not None and len(self.reference_paths) != n:
            raise ValueError("reference_paths length != input_a_paths length")
        if self.scales is not None and len(self.scales) != n:
            raise ValueError("scales length != input_a_paths length")

    def __len__(self) -> int:
        return len(self.input_a_paths)

    @staticmethod
    def _read(path: str) -> np.ndarray:
        spans.count("data.exr_reads", 1)
        return read_image_linear(path)

    def _read_cached(self, path: str) -> np.ndarray:
        img = self._cache.get(path)
        if img is None:
            img = self._cache[path] = self._read(path)
        return img

    def _images(self, idx: int) -> tuple[list[np.ndarray], float]:
        """Item idx's images in `NAMES`' order, decoded (from the cache), the
        reference only where the dataset has one, and its radiance scale."""
        read = self._read_cached if self.cache_images else self._read
        images = [read(paths[idx]) for paths in (self.input_a_paths, self.input_b_paths,
                                                 self.albedo_paths, self.transmissibility_paths)]
        if len({x.shape[:2] for x in images}) != 1:
            raise ValueError(f"size mismatch among inputs at index {idx}")
        if self.reference_paths is not None:
            images.append(read(self.reference_paths[idx]))
            if images[-1].shape[:2] != images[0].shape[:2]:
                raise ValueError(f"reference size mismatch at index {idx}")
        return images, 1.0 if self.scales is None else float(self.scales[idx])

    def _draw(self, idx: int, rng: np.random.Generator) -> _Item:
        """Item idx's images and its draws from rng: the crop, the
        subsample offsets of the four inputs, then the quarter turns."""
        images, scale = self._images(idx)
        h, w = images[0].shape[:2]
        cs = self.crop_size
        if h < cs or w < cs:
            raise ValueError(f"imageset {idx} smaller than crop size {cs}")
        top = int(rng.integers(0, h - cs + 1))
        left = int(rng.integers(0, w - cs + 1))
        f = self.upsample
        offsets = tuple((int(rng.integers(0, f)), int(rng.integers(0, f)))
                        for _ in range(4)) if f > 1 else ()
        k = int(rng.integers(0, 4))
        return _Item(tuple(images), scale, top, left, offsets, k)

    def _shape(self, j: int) -> tuple[int, int]:
        """The (H, W) of image j of an item: the inputs subsampled."""
        n = self.crop_size // self.upsample if j < 4 else self.crop_size
        return n, n

    def _write(self, item: _Item, j: int, c: int | slice, out: np.ndarray) -> None:
        """Item's image j, channel c (or all three for a slice), into `out`
        of shape (*_shape(j)) or (*_shape(j), 3): the crop, the jittered-
        stride subsample of the four inputs (litbox_dataset.py:73-85), the
        radiance scale (input A, input B, reference) or the
        transmissibility**upsample correction (litbox_dataset.py:129-136),
        then the quarter turns. Each acts on each channel alone."""
        cs, f = self.crop_size, self.upsample
        x = item.images[j][item.top:item.top + cs, item.left:item.left + cs, c]
        if f > 1 and j < 4:
            oy, ox = item.offsets[j]
            x = x[oy::f, ox::f][:cs // f, :cs // f]
            if j == 3:
                out[...] = np.rot90(x ** f, item.k)
                return
        if j in _SCALED:
            np.multiply(np.rot90(x, item.k), item.scale, out=out)
        else:
            out[...] = np.rot90(x, item.k)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        if self.reference_paths is None:
            (a, b, albedo, trans), scale = self._images(idx)
            return a * scale, b * scale, albedo, trans, None
        item = self._draw(idx, rng)
        out = []
        for j in range(len(NAMES)):
            x = np.empty((*self._shape(j), 3), np.float32)
            self._write(item, j, slice(None), x)
            out.append(x)
        return tuple(out)

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = False):
        """Yield a `Batch` of each `batch_size` items in turn. Drawing its
        items is the span `data.batch`; its pixels are made when read."""
        if self.reference_paths is None:
            raise ValueError("batches need reference_paths")
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            with spans.span("data.batch"):
                batch = Batch(self, [self._draw(int(i), rng) for i in order[s:s + batch_size]])
            yield batch


@dataclasses.dataclass(frozen=True)
class _Item:
    """One item of a batch: its five decoded images (`NAMES`' order,
    unscaled), its radiance scale and its draws. `DenoiserDataset._write`
    makes its pixels."""

    images: tuple
    scale: float
    top: int
    left: int
    offsets: tuple  # (oy, ox) of each input when upsample > 1
    k: int


class Batch(collections.abc.Mapping):
    """A batch of `DenoiserDataset.batches`: a read-only mapping of `NAMES`
    to (N, H, W, 3) float32 arrays, each made whole on its first read (the
    span `data.batch`), and `channel`, which makes one channel of each item
    alone. `size` is N. The counter `data.batch_bytes` adds up the bytes of
    every array made."""

    def __init__(self, dataset: DenoiserDataset, items: list[_Item]):
        self._dataset = dataset
        self._items = items
        self._made: dict[str, np.ndarray] = {}

    @property
    def size(self) -> int:
        return len(self._items)

    def __getitem__(self, key: str) -> np.ndarray:
        x = self._made.get(key)
        if x is None:
            j = _INDEX[key]
            with spans.span("data.batch"):
                x = self._made[key] = self._make(j, [slice(None)] * self.size, 3)
        return x

    def __contains__(self, key) -> bool:
        return key in NAMES

    def __iter__(self):
        return iter(NAMES)

    def __len__(self) -> int:
        return len(NAMES)

    def channel(self, key: str, c: np.ndarray) -> np.ndarray:
        """(N, H, W, 1) float32: item i's channel c[i] of self[key], bit for
        bit, made from that channel alone."""
        return self._make(_INDEX[key], [int(ci) for ci in c], 1)

    def _make(self, j: int, channels: list, depth: int) -> np.ndarray:
        out = np.empty((self.size, *self._dataset._shape(j), depth), np.float32)
        for item, c, x in zip(self._items, channels, out):
            self._dataset._write(item, j, c, x if depth == 3 else x[..., 0])
        spans.count("data.batch_bytes", out.nbytes)
        return out


def build_curriculum(reference_glob: str, albedo_glob: str, trans_glob: str,
                     final_a_glob: str, final_b_glob: str,
                     easy: tuple[str, str] | None = None,
                     medium: tuple[str, str] | None = None,
                     crop_size: int = 256, upsample: int = 1) -> list[tuple[str, DenoiserDataset]]:
    """Curriculum stages Easy -> Medium -> Final (train_litbox_denoiser.py:142-164)."""
    refs = sorted(glob.glob(reference_glob))
    if not refs:
        raise ValueError(f"no reference files match {reference_glob}")
    albedo = sorted(glob.glob(albedo_glob))[: len(refs)]
    trans = sorted(glob.glob(trans_glob))[: len(refs)]
    if len(albedo) < len(refs) or len(trans) < len(refs):
        raise ValueError("fewer albedo/transmissibility files than references")

    stages = []
    for name, pair in (("Easy", easy), ("Medium", medium)):
        if pair is None:
            continue
        a = sorted(glob.glob(pair[0]))[: len(refs)]
        b = sorted(glob.glob(pair[1]))[: len(refs)]
        if len(a) < len(refs) or len(b) < len(refs):
            raise ValueError(f"fewer {name} inputs than references")
        stages.append((name, DenoiserDataset(a, b, albedo, trans, refs, crop_size, upsample)))

    a = sorted(glob.glob(final_a_glob))[: len(refs)]
    b = sorted(glob.glob(final_b_glob))[: len(refs)]
    if len(a) < len(refs) or len(b) < len(refs):
        raise ValueError("fewer final inputs than references")
    stages.append(("Final", DenoiserDataset(a, b, albedo, trans, refs, crop_size, upsample)))
    return stages
