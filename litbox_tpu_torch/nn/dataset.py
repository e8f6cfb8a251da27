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
"""

from __future__ import annotations

import dataclasses
import glob

import numpy as np

from ..core import spans
from ..io.images import read_image_linear


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

    @staticmethod
    def jittered_subsample(image: np.ndarray, factor: int, rng: np.random.Generator) -> np.ndarray:
        """Strided jittered subsample (litbox_dataset.py:73-85), HWC layout."""
        h, w = image.shape[:2]
        oy = int(rng.integers(0, factor))
        ox = int(rng.integers(0, factor))
        out = image[oy::factor, ox::factor]
        return out[: h // factor, : w // factor]

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        scale = 1.0 if self.scales is None else float(self.scales[idx])
        read = self._read_cached if self.cache_images else self._read
        a = read(self.input_a_paths[idx]) * scale
        b = read(self.input_b_paths[idx]) * scale
        albedo = read(self.albedo_paths[idx])
        trans = read(self.transmissibility_paths[idx])
        if not (a.shape[:2] == b.shape[:2] == albedo.shape[:2] == trans.shape[:2]):
            raise ValueError(f"size mismatch among inputs at index {idx}")

        if self.reference_paths is None:
            return a, b, albedo, trans, None

        ref = read(self.reference_paths[idx]) * scale
        if ref.shape[:2] != a.shape[:2]:
            raise ValueError(f"reference size mismatch at index {idx}")

        h, w = a.shape[:2]
        cs = self.crop_size
        if h < cs or w < cs:
            raise ValueError(f"imageset {idx} smaller than crop size {cs}")
        top = int(rng.integers(0, h - cs + 1))
        left = int(rng.integers(0, w - cs + 1))
        a, b, albedo, trans, ref = (x[top:top + cs, left:left + cs]
                                    for x in (a, b, albedo, trans, ref))

        if self.upsample > 1:
            a = self.jittered_subsample(a, self.upsample, rng)
            b = self.jittered_subsample(b, self.upsample, rng)
            albedo = self.jittered_subsample(albedo, self.upsample, rng)
            trans = self.jittered_subsample(trans, self.upsample, rng) ** self.upsample

        k = int(rng.integers(0, 4))
        a, b, albedo, trans, ref = (np.rot90(x, k).copy() for x in (a, b, albedo, trans, ref))
        return a, b, albedo, trans, ref

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = False):
        """Yield NHWC float32 batch dicts. Making each is the span
        `data.batch`; the counter `data.batch_bytes` adds up their bytes."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            with spans.span("data.batch"):
                items = [self.__getitem__(int(i), rng) for i in order[s:s + batch_size]]
                batch = {
                    "input_a": np.stack([it[0] for it in items]).astype(np.float32),
                    "input_b": np.stack([it[1] for it in items]).astype(np.float32),
                    "albedo": np.stack([it[2] for it in items]).astype(np.float32),
                    "transmissibility": np.stack([it[3] for it in items]).astype(np.float32),
                    "reference": np.stack([it[4] for it in items]).astype(np.float32),
                }
            spans.count("data.batch_bytes", sum(v.nbytes for v in batch.values()))
            yield batch


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
