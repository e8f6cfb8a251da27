"""litbox_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Without a CUDA device every test here skips.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX for the rest of the suite.)
"""

import numpy as np
import pytest
import torch

from litbox_tpu_torch.ops import attnscan, rotate
from litbox_tpu_torch.sim import rbt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, seed, shape, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("width,group,n_groups,tracers",
                         [(128, 0, 1, 1), (200, 1, 4, 2), (31, 3, 4, 1)])
def test_scan_kernel_matches_plain(dev, width, group, n_groups, tracers):
    d = 8
    t = _rand(dev, 0, (d, 16, width), 0.3, 1.0)
    srcs = [_rand(dev, 1 + c, (tracers * d, 16, width)) for c in range(3)]
    args = dict(group=group, n_groups=n_groups, src_offset=(tracers - 1) * d)
    before = attnscan.attenuation_scan_rows.launches
    got = attnscan.attenuation_scan_rows(t, *srcs, **args)
    torch.cuda.synchronize()
    assert attnscan.attenuation_scan_rows.launches == before + 1
    ref = attnscan.attenuation_scan_rows_plain(t, *srcs, **args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,width,row_div,elem_scale,bound",
                         [(64, 64, 1, 1, 0.4), (64, 192, 1, 3, 0.4),
                          (192, 64, 3, 1, 0.7), (48, 80, 1, 1, 3.0)])
def test_shear_kernel_matches_plain(dev, rows, width, row_div, elem_scale, bound):
    n_texels = width // elem_scale
    img = _rand(dev, 4, (12, rows, width))
    coef = _rand(dev, 5, (12,), -bound, bound)
    before = rotate.shear.launches
    got = rotate.shear(img, coef, row_div, elem_scale, n_texels)
    torch.cuda.synchronize()
    assert rotate.shear.launches == before + 1
    ref = rotate.shear_plain(img, coef, row_div, elem_scale, n_texels)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups,row_lo,row_hi", [(1, 0, 64), (3, 8, 40)])
def test_shear_reduce_kernel_matches_plain(dev, groups, row_lo, row_hi):
    img = _rand(dev, 6, (24, 64, 64))
    coef = _rand(dev, 7, (24,), -0.5, 0.5)
    before = rotate.shear_reduce.launches
    got = rotate.shear_reduce(img, coef, 1, 1, 64, row_lo, row_hi, groups)
    torch.cuda.synchronize()
    assert rotate.shear_reduce.launches == before + 1
    ref = rotate.shear_reduce_plain(img, coef, 1, 1, 64, row_lo, row_hi, groups)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_wrappers_raise_instead_of_falling_back(dev):
    img = _rand(dev, 8, (4, 16, 16))
    coef = torch.zeros(4, device=dev)
    with pytest.raises(ValueError):
        rotate.shear(img.transpose(1, 2), coef, 1, 1, 16)  # not contiguous
    with pytest.raises(TypeError):
        rotate.shear(img.double(), coef.double(), 1, 1, 16)
    with pytest.raises(ValueError):
        rotate.shear(img, coef.cpu(), 1, 1, 16)             # mixed devices


def test_resolve_on_card_matches_cpu(dev):
    """The whole resolve (scan + three shears) on the card against the same
    resolve on CPU copies, where the plain versions run."""
    d, s, w = 16, 128, 64
    ang = (torch.arange(d, dtype=torch.float32) + 0.25) * (2 * np.pi / d)
    fields = rbt.RotatedFields(
        cos=torch.cos(ang), sin=torch.sin(ang),
        trans=_rand("cpu", 9, (d, s, s), 0.8, 1.0),
        cum_log=torch.zeros(d, s, s), cum_coarse=torch.zeros(d, s, s // 16),
        center=torch.tensor([w / 2.0, w / 2.0]), phase=torch.tensor(0.25))
    src = tuple(_rand("cpu", 10 + c, (d, s, s)) for c in range(3))
    ref = rbt.resolve_raw(fields, src, w, w, traced_phase=True)
    on_card = rbt.RotatedFields(**{k: v.to(dev) for k, v in vars(fields).items()})
    got = rbt.resolve_raw(on_card, tuple(c.to(dev) for c in src), w, w,
                          traced_phase=True)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4 * float(ref.abs().max()),
                               rtol=1e-5)
