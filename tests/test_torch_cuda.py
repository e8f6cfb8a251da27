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
from litbox_tpu_torch.prof import microops, rotfused
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


def _unaligned(x):
    """x as a view one float into a buffer: not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


# (bins, rows, width, group, n_groups, tracers, t range, layout). Widths
# around the kernel's 4-column threads and 128-column warps (1, 31, 127,
# 128, 129, 200), the frame's (640, 1024) and one past a block's 1024-column
# span (2056: three spans); odd widths have rows that are not 16-byte
# aligned, and "unaligned" puts every plane one float off at width 128.
# Five rows leave a block of rows partly empty. Then group 15 of 16 of a
# two-tracer source, and the collimated one-bin (1, 1024, 1024) with t near
# 1 (carries that last across every warp) and near 0.3.
SCAN_EDGES = ([(3, 5, w, 0, 1, 1, (0.3, 1.0), "aligned")
               for w in (1, 31, 127, 128, 129, 200, 640, 1024, 2056)]
              + [(3, 5, 128, 0, 1, 1, (0.3, 1.0), "unaligned"),
                 (32, 4, 96, 15, 16, 2, (0.3, 1.0), "aligned"),
                 (1, 1024, 1024, 0, 1, 1, (0.99, 1.0), "aligned"),
                 (1, 1024, 1024, 0, 1, 1, (0.3, 0.31), "aligned")])


@pytest.mark.parametrize("d,rows,width,group,n_groups,tracers,t_range,layout", SCAN_EDGES)
def test_scan_kernel_edges(dev, d, rows, width, group, n_groups, tracers, t_range, layout):
    """K1 at its edges against its plain version, within 1e-5 of the
    largest magnitude."""
    t = _rand(dev, 60, (d, rows, width), *t_range)
    srcs = [_rand(dev, 61 + c, (tracers * d, rows, width)) for c in range(3)]
    if layout == "unaligned":
        t, srcs = _unaligned(t), [_unaligned(x) for x in srcs]
    args = dict(group=group, n_groups=n_groups, src_offset=(tracers - 1) * d)
    before = attnscan.attenuation_scan_rows.launches
    got = attnscan.attenuation_scan_rows(t, *srcs, **args)
    torch.cuda.synchronize()
    assert attnscan.attenuation_scan_rows.launches == before + 1
    ref = attnscan.attenuation_scan_rows_plain(t, *srcs, **args)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (d // n_groups, rows, width)
        torch.testing.assert_close(g, r, atol=1e-5 * scale, rtol=0)


def _images(dev, seed, n, rows, width, layout):
    """(n, rows, width) contiguous images: "aligned" from torch; "slice" as
    img[1:] of n + 1 images (one float off 16-byte alignment when
    rows * width is odd); "offset" a view one float into a buffer (16-byte
    rows, an unaligned base)."""
    if layout == "slice":
        return _rand(dev, seed, (n + 1, rows, width))[1:]
    img = _rand(dev, seed, (n, rows, width))
    if layout == "offset":
        buf = torch.empty(img.numel() + 1, device=dev)
        img = buf[1:].view(n, rows, width).copy_(img)
    return img


# (n, rows, width, row_div, elem_scale, bound, layout): after the first four,
# odd widths (n_texels 37, planar and interleaved with elem_scale 3), an
# unaligned base (odd width, and 16-byte rows), rows that leave the last
# block of 4 row warps ragged, shifts past the whole row, and 1920-float
# rows (three warps a row).
SHEAR_KERNEL_CASES = [
    (12, 64, 64, 1, 1, 0.4, "aligned"), (12, 64, 192, 1, 3, 0.4, "aligned"),
    (12, 192, 64, 3, 1, 0.7, "aligned"), (12, 48, 80, 1, 1, 3.0, "aligned"),
    (5, 9, 37, 1, 1, 0.7, "aligned"), (5, 9, 111, 1, 3, 0.7, "aligned"),
    (7, 9, 37, 1, 1, 0.7, "slice"), (6, 50, 64, 1, 1, 0.4, "offset"),
    (3, 13, 640, 1, 1, 0.7, "aligned"), (4, 16, 64, 1, 1, 40.0, "aligned"),
    (2, 8, 1920, 1, 3, 0.4, "aligned")]


@pytest.mark.parametrize("n,rows,width,row_div,elem_scale,bound,layout",
                         SHEAR_KERNEL_CASES)
def test_shear_kernel_matches_plain(dev, n, rows, width, row_div, elem_scale, bound,
                                    layout):
    n_texels = width // elem_scale
    img = _images(dev, 4, n, rows, width, layout)
    coef = _rand(dev, 5, (n,), -bound, bound)
    before = rotate.shear.launches
    got = rotate.shear(img, coef, row_div, elem_scale, n_texels)
    torch.cuda.synchronize()
    assert rotate.shear.launches == before + 1
    ref = rotate.shear_plain(img, coef, row_div, elem_scale, n_texels)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


# (n, width, elem_scale, bound, groups, row_lo, row_hi, layout) over 64 rows:
# after the first two, odd widths, one image a group (n_per 1) and 128,
# row_lo not a multiple of 8, unaligned bases, shifts past the row, and an
# empty batch (every group sums to zero).
SHEAR_REDUCE_KERNEL_CASES = [
    (24, 64, 1, 0.5, 1, 0, 64, "aligned"), (24, 64, 1, 0.5, 3, 8, 40, "aligned"),
    (24, 37, 1, 0.5, 3, 5, 30, "aligned"), (24, 111, 3, 0.5, 2, 3, 17, "aligned"),
    (12, 64, 1, 0.5, 12, 0, 64, "aligned"), (128, 64, 1, 0.5, 1, 13, 51, "aligned"),
    (12, 37, 1, 0.5, 3, 1, 63, "offset"), (9, 64, 1, 0.5, 3, 7, 20, "offset"),
    (6, 640, 1, 0.7, 2, 11, 53, "aligned"), (8, 64, 1, 40.0, 2, 0, 64, "aligned"),
    (0, 64, 1, 0.5, 3, 0, 64, "aligned")]


@pytest.mark.parametrize("n,width,elem_scale,bound,groups,row_lo,row_hi,layout",
                         SHEAR_REDUCE_KERNEL_CASES)
def test_shear_reduce_kernel_matches_plain(dev, n, width, elem_scale, bound, groups,
                                           row_lo, row_hi, layout):
    n_texels = width // elem_scale
    img = _images(dev, 6, n, 64, width, layout)
    coef = _rand(dev, 7, (n,), -bound, bound)
    args = (1, elem_scale, n_texels, 0.5, row_lo, row_hi, groups)
    before = rotate.shear_reduce.launches
    got = rotate.shear_reduce(img, coef, *args)
    torch.cuda.synchronize()
    assert rotate.shear_reduce.launches == before + 1
    ref = rotate.shear_reduce_plain(img, coef, *args)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,rows,width,groups,row_lo,row_hi",
                         [(24, 64, 64, 3, 8, 40), (12, 30, 37, 2, 3, 29)])
def test_shear_reduce_equals_in_order_sum_of_shear(dev, n, rows, width, groups,
                                                   row_lo, row_hi):
    """K3 adds each image's taps, rounded as K2 rounds its outputs, in image
    order: it equals the in-order sum of K2's outputs bit for bit."""
    img = _rand(dev, 12, (n, rows, width))
    coef = _rand(dev, 13, (n,), -0.6, 0.6)
    got = rotate.shear_reduce(img, coef, 1, 1, width, 0.5, row_lo, row_hi, groups)
    each = rotate.shear(img, coef, 1, 1, width)[:, row_lo:row_hi]
    each = each.reshape(groups, n // groups, row_hi - row_lo, width)
    ref = each[:, 0].clone()
    for k in range(1, n // groups):
        ref = ref + each[:, k]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("s,d,delta", [(128, 8, 0.0), (96, 12, -0.2), (64, 16, 0.3)])
def test_rotate_planar_sum_fused_kernel_matches_plain(dev, s, d, delta):
    """K4 against its plain version, bins over all four quadrants (5 runs),
    with a float and a tensor delta."""
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    chans = tuple(_rand(dev, 11 + c, (d, s, s)) for c in range(3))
    for dl in (delta, torch.tensor(delta, device=dev)):
        before = rotate.rotate_planar_sum_fused.launches
        got = rotate.rotate_planar_sum_fused(chans, base, dl)
        torch.cuda.synchronize()
        assert rotate.rotate_planar_sum_fused.launches == before + 1
        ref = rotate.rotate_planar_sum_fused_plain(chans, base, dl)
        assert got.shape == ref.shape == (3, s, s)
        torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()),
                                   rtol=0)


# rotate_bins on the card: 5 bins over all quadrants at S=128 and the
# resolve's S=384, and one bin at a directional light's S=1024 (the exact
# collimated field at 256x256), with and without the fused reduce.
ROTATE_BINS_CASES = [(5, 128, None), (5, 384, (64, 320)), (1, 1024, (384, 640)),
                     (1, 1024, None)]


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("d,s,reduce_rows", ROTATE_BINS_CASES)
def test_rotate_bins_kernels_match_plain(dev, monkeypatch, uniform, d, s, reduce_rows):
    """rotate_bins and rotate_bins_uniform through K2 and K3 (interleaved:
    elem_scale 3 and row_div 3) against the same composition through the
    plain shears on the card, 1e-5 of the maximum."""
    angles = (0.3, -2.0, 2.9, 4.4, -0.785398)[:d] if d > 1 else (2.2,)
    img = _rand(dev, 40, (d, s, s, 3))

    def run():
        if uniform:
            return rotate.rotate_bins_uniform(img, angles, reduce_rows)
        return rotate.rotate_bins(img, torch.tensor(angles, device=dev), reduce_rows)

    before = (rotate.shear.launches, rotate.shear_reduce.launches)
    got = run()
    torch.cuda.synchronize()
    fused = reduce_rows is not None
    assert (rotate.shear.launches - before[0],
            rotate.shear_reduce.launches - before[1]) == ((2, 1) if fused else (3, 0))
    monkeypatch.setattr(rotate, "shear", rotate.shear_plain)
    monkeypatch.setattr(rotate, "shear_reduce", rotate.shear_reduce_plain)
    ref = run()
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


# K4's edges. Bin sets: "bins" -i 2pi/d for i < d (5 runs over four
# quadrants), "quarter_turns" -i pi/2 for i < 8 (8 runs of one image, the
# most the kernel takes). S = 100 leaves partial 32x32 tiles, S = 97 rows that
# are not 16-byte aligned (4-byte copies). A delta of 1.2 rad puts residuals
# past the stages' reach, so those images take the kernel's general path.
K4_EDGES = [(100, "bins", 8, 0.2), (97, "bins", 8, -0.3), (128, "bins", 1, 0.4),
            (64, "quarter_turns", 8, 0.1), (100, "bins", 8, 1.2), (97, "bins", 4, 1.2),
            (640, "bins", 16, 1.2), (640, "bins", 16, 0.02)]


@pytest.mark.parametrize("s,bins,d,delta", K4_EDGES)
def test_rotate_planar_sum_fused_kernel_edges(dev, s, bins, d, delta):
    """K4 at its edges (one image, 8 runs, odd and partial-tile S, windows
    that do not fit a stage) against its plain version at 2e-5 of the
    largest magnitude, with a tensor delta; two calls give equal bits."""
    step = 2 * np.pi / d if bins == "bins" else np.pi / 2
    base = tuple(-i * step for i in range(d))
    chans = tuple(_rand(dev, 30 + c, (d, s, s)) for c in range(3))
    dl = torch.tensor(delta, device=dev)
    before = rotate.rotate_planar_sum_fused.launches
    got = rotate.rotate_planar_sum_fused(chans, base, dl)
    again = rotate.rotate_planar_sum_fused(chans, base, dl)
    torch.cuda.synchronize()
    assert rotate.rotate_planar_sum_fused.launches == before + 2
    assert torch.equal(got, again)
    ref = rotate.rotate_planar_sum_fused_plain(chans, base, dl)
    assert got.shape == ref.shape == (3, s, s)
    torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("n,s,spread", [(1, 97, 0.8), (13, 97, 0.8), (1, 1024, 0.8),
                                        (13, 1024, 0.8), (13, 640, 0.8), (13, 128, 3.0)])
def test_shear3_accum_kernel_edges(dev, n, s, spread):
    """V4 at its edges: one image and 13 (not a multiple of the ring or of the
    four warps a row), rows that are not 16-byte aligned (97), the largest S
    (1024), and residuals up to 3 rad (shifts past the row). Held to its
    plain version at 2e-5 of the largest magnitude; two calls give equal
    bits (the warps' partials are added in a fixed order)."""
    img = _rand(dev, 25, (n, s, s))
    resid = _rand(dev, 26, (n,), -spread, spread)
    alpha, beta = -torch.tan(resid / 2), torch.sin(resid)
    before = rotfused.shear3_accum.launches
    got = rotfused.shear3_accum(img, alpha, beta)
    again = rotfused.shear3_accum(img, alpha, beta)
    torch.cuda.synchronize()
    assert rotfused.shear3_accum.launches == before + 2
    assert torch.equal(got, again)
    ref = rotfused.shear3_accum_plain(img, alpha, beta)
    torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("n,s,spread", [(1, 97, 0.8), (13, 97, 0.8), (1, 1024, 0.8),
                                        (13, 1024, 0.8), (37, 640, 0.8), (24, 640, 0.8),
                                        (13, 128, 3.0)])
def test_shear1_accum_kernel_edges(dev, n, s, spread):
    """V3 on V4's kernel at its edges: one image, N not a multiple of the
    warps a row (13, 37), rows that are not 16-byte aligned (97), the
    largest S, the group shape, and shifts past the row. Held to its plain
    version at 2e-5 of the largest magnitude; two calls give equal bits."""
    img = _rand(dev, 35, (n, s, s))
    alpha = -torch.tan(_rand(dev, 36, (n,), -spread, spread) / 2)
    before = rotfused.shear1_accum.launches
    got = rotfused.shear1_accum(img, alpha)
    again = rotfused.shear1_accum(img, alpha)
    torch.cuda.synchronize()
    assert rotfused.shear1_accum.launches == before + 2
    assert torch.equal(got, again)
    ref = rotfused.shear1_accum_plain(img, alpha)
    torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("delta", [0.0, 1.2])
def test_rotate_planar_sum_fused_counts(dev, delta):
    """K4's counting launch gives the plain launch's bits and counts every
    (channel, image, tile) window once. At delta 0 every window of the bins'
    residuals is staged; at 1.2 rad some take the tap path. Its copies read
    some bytes, and a counts tensor of the wrong type raises."""
    s, d = 640, 16
    base = tuple(-i * 2 * np.pi / d for i in range(d))
    chans = tuple(_rand(dev, 40 + c, (d, s, s)) for c in range(3))
    dl = torch.tensor(delta, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    got = rotate.rotate_planar_sum_fused(chans, base, dl, counts)
    assert torch.equal(got, rotate.rotate_planar_sum_fused(chans, base, dl))
    windows, staged, texels, copied = counts.tolist()
    assert windows == 3 * d * (s // 32) ** 2
    assert texels == staged * 32 * 32
    assert copied > 0
    if delta == 0.0:
        assert staged == windows
    else:
        assert 0 < staged < windows
    with pytest.raises(ValueError):
        rotate.rotate_planar_sum_fused(chans, base, dl, counts.float())


@pytest.mark.parametrize("spread", [0.0, 0.8])
def test_shear3_accum_counts(dev, spread):
    """V4's counting launch gives the plain launch's bits, and its copies
    read each image row at most once: exactly once with no shift."""
    n, s = 13, 640
    img = _rand(dev, 27, (n, s, s))
    resid = _rand(dev, 28, (n,), -spread, spread) if spread else torch.zeros(n, device=dev)
    alpha, beta = -torch.tan(resid / 2), torch.sin(resid)
    counts = torch.zeros(1, dtype=torch.int64, device=dev)
    got = rotfused.shear3_accum(img, alpha, beta, counts)
    assert torch.equal(got, rotfused.shear3_accum(img, alpha, beta))
    if spread:
        assert 0 < counts.item() <= 4 * img.numel()
    else:
        assert counts.item() == 4 * img.numel()


# (N, S): S not a multiple of the 32-wide tiles (100), one image, 13 images
# (not a multiple of V2's 6-stage ring) and an odd S (97: rows that are not
# 16-byte aligned, V2's 4-byte copies). V1 takes S*S divisible by 4 only.
SPLIT_SHAPES = [(6, 128), (9, 100), (24, 640), (1, 640), (13, 128), (5, 97)]


@pytest.mark.parametrize("name", ["copy_accum", "transpose2_accum",
                                  "shear1_accum", "shear3_accum"])
@pytest.mark.parametrize("n,s", SPLIT_SHAPES)
def test_rotfused_split_kernel_matches_plain(dev, name, n, s):
    """The four variants of the K4 cost split against their plain versions.
    The kernels sum the images in order, the plain versions in PyTorch's
    order: held to 2e-5 of the largest magnitude. At odd S, V1 raises."""
    img = _rand(dev, 20, (n, s, s))
    resid = _rand(dev, 21, (n,), -np.pi / 4, np.pi / 4)
    coefs = {"shear1_accum": (-torch.tan(resid / 2),),
             "shear3_accum": (-torch.tan(resid / 2), torch.sin(resid))}.get(name, ())
    fn = getattr(rotfused, name)
    before = fn.launches
    if name == "copy_accum" and s * s % 4:
        with pytest.raises(ValueError):
            fn(img)
        assert fn.launches == before
        return
    got = fn(img, *coefs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = getattr(rotfused, name + "_plain")(img, *coefs)
    assert got.shape == ref.shape == (s, s)
    torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("n,s", SPLIT_SHAPES)
def test_transpose2_accum_equals_copy_accum(dev, n, s):
    """V2 adds the images in V1's order, so the two agree bit for bit at every
    shape V1 takes (S*S divisible by 4), also when V2 reads the images from
    a view that is not 16-byte aligned (its 4-byte copies). At odd S, which
    V1 does not take, V2 is held to its plain version instead."""
    img = _rand(dev, 24, (n, s, s))
    if s * s % 4 == 0:
        assert torch.equal(rotfused.transpose2_accum(img), rotfused.copy_accum(img))
        # The same images one float past a 16-byte boundary: 4-byte copies.
        flat = torch.empty(n * s * s + 1, device=dev)
        shifted = flat[1:].view(n, s, s)
        shifted.copy_(img)
        assert torch.equal(rotfused.transpose2_accum(shifted), rotfused.copy_accum(img))
    else:
        got = rotfused.transpose2_accum(img)
        ref = rotfused.transpose2_accum_plain(img)
        torch.testing.assert_close(got, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("name", ["transpose", "transpose2", "roll_rows",
                                  "roll_cols", "flip2"])
@pytest.mark.parametrize("n,s", [(6, 128), (9, 100), (24, 640), (1, 640), (3, 97)])
def test_microops_kernel_matches_plain(dev, name, n, s):
    """The five data-movement kernels (runs/prof_microops.py's) against their
    plain versions, bit for bit: S = 100 leaves partial 32-wide tiles, S = 97
    rows that are not 16-byte aligned (transpose2's 4-byte path), and the
    roll shifts run from -3S to 3S (negative and >= S among them).
    transpose2 is also held to 2 * x, bit for bit."""
    x = _rand(dev, 22, (n, s, s))
    shifts = np.random.default_rng(23).integers(-3 * s, 3 * s, n).astype(np.int32)
    args = (torch.from_numpy(shifts).to(dev),) if name.startswith("roll") else ()
    fn = getattr(microops, name)
    before = fn.launches
    got = fn(x, *args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = getattr(microops, name + "_plain")(x, *args)
    assert got.shape == ref.shape == (n, s, s)
    assert torch.equal(got, ref)
    if name == "transpose2":
        assert torch.equal(got, torch.mul(x, 2.0))


def test_wrappers_raise_instead_of_falling_back(dev):
    img = _rand(dev, 8, (4, 16, 16))
    coef = torch.zeros(4, device=dev)
    with pytest.raises(ValueError):
        rotate.shear(img.transpose(1, 2), coef, 1, 1, 16)  # not contiguous
    with pytest.raises(TypeError):
        rotate.shear(img.double(), coef.double(), 1, 1, 16)
    with pytest.raises(ValueError):
        rotate.shear(img, coef.cpu(), 1, 1, 16)             # mixed devices
    with pytest.raises(ValueError):                         # not contiguous
        rotate.rotate_planar_sum_fused((img.transpose(1, 2),) * 3, (0.0,) * 4, 0.0)
    shifts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                         # not contiguous
        microops.transpose(img.transpose(1, 2))
    with pytest.raises(TypeError):
        microops.flip2(img.double())
    with pytest.raises(ValueError):                         # shifts on the CPU
        microops.roll_rows(img, shifts.cpu())
    with pytest.raises(TypeError):
        microops.roll_cols(img, shifts.long())
    with pytest.raises(ValueError):
        microops.roll_rows(img, shifts[:3])
    # V2 takes contiguous float32 (N, S, S) images on one device, any S.
    with pytest.raises(ValueError):                         # not contiguous
        rotfused.transpose2_accum(img.transpose(1, 2))
    with pytest.raises(TypeError):
        rotfused.transpose2_accum(img.double())
    with pytest.raises(ValueError):                         # not square
        rotfused.transpose2_accum(img[:, :8].contiguous())
    with pytest.raises(ValueError):                         # not (N, S, S)
        rotfused.transpose2_accum(img[0])
    big = torch.zeros((1, 1025, 1025), device=dev)
    with pytest.raises(ValueError):                         # V4 stages S <= 1024
        rotfused.shear3_accum(big, coef[:1], coef[:1])
    with pytest.raises(ValueError):                         # and so does V3
        rotfused.shear1_accum(big, coef[:1])


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


def _fields_on(dev, d, s, w, phase, seed):
    """Rotated fields of d bins at size s for a w x w frame, with a jitter
    phase and a random cumulative log-transmissibility, on `dev`."""
    ang = (torch.arange(d, dtype=torch.float32) + phase) * (2 * np.pi / d)
    trans = _rand("cpu", seed, (d, s, s), 0.8, 1.0)
    cum_log = torch.cumsum(torch.log(trans), -1)
    fields = rbt.RotatedFields(
        cos=torch.cos(ang), sin=torch.sin(ang), trans=trans, cum_log=cum_log,
        cum_coarse=cum_log[..., 15::16].contiguous(),
        center=torch.tensor([w / 2.0, w / 2.0]), phase=torch.tensor(float(phase)))
    return rbt.RotatedFields(**{k: v.to(dev) for k, v in vars(fields).items()})


# The cascade's rotations (sim/dom.py): rotate_back(traced_phase=True) of a
# (D, S, S, 3) interaction map and _forward_rotate of a (W, W, 3) map into
# the D bin frames, at S=128 and at the 256^2 frame's S=384.
DOM_CASES = [(16, 128, 64, 0.0), (8, 128, 48, 0.3), (8, 384, 256, 0.0)]


@pytest.mark.parametrize("d,s,w,phase", DOM_CASES)
def test_dom_rotations_kernels_match_plain(dev, monkeypatch, d, s, w, phase):
    """The cascade's rotate-back (K2 twice, K3) and forward rotation (K2
    three times) on interleaved rows against the same compositions through
    the plain shears on the card, 1e-5 of the maximum."""
    from litbox_tpu_torch.sim.dom import _forward_rotate

    fields = _fields_on(dev, d, s, w, phase, 41)
    dep = _rand(dev, 42, (d, s, s, 3))
    world = _rand(dev, 43, (w, w, 3))
    before = (rotate.shear.launches, rotate.shear_reduce.launches)
    back = rbt.rotate_back(fields, dep, w, w, traced_phase=True)
    fwd = _forward_rotate(fields, world, w, w)
    torch.cuda.synchronize()
    assert (rotate.shear.launches - before[0],
            rotate.shear_reduce.launches - before[1]) == (5, 1)
    monkeypatch.setattr(rotate, "shear", rotate.shear_plain)
    monkeypatch.setattr(rotate, "shear_reduce", rotate.shear_reduce_plain)
    for got, ref in ((back, rbt.rotate_back(fields, dep, w, w, traced_phase=True)),
                     (fwd, _forward_rotate(fields, world, w, w))):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


def test_dom_sources_on_card_match_cpu(dev):
    """Two waves of dom_bounce_sources on the card (K1, K2, K3) against the
    same call on CPU copies (the plain versions), 1e-4 of the maximum."""
    from litbox_tpu_torch.core.types import GBuffer
    from litbox_tpu_torch.sim.dom import dom_bounce_sources

    d, s, w = 8, 128, 64
    fields = _fields_on("cpu", d, s, w, 0.0, 44)
    gb = GBuffer(albedo=_rand("cpu", 45, (w, w, 4)),
                 transmissibility=_rand("cpu", 46, (w, w), 0.5, 1.0),
                 normal=torch.zeros((w, w, 4)))
    src = tuple(_rand("cpu", 47 + c, (d, s, s)) for c in range(3))
    ref = dom_bounce_sources(fields, gb, src, n_waves=2)
    got = dom_bounce_sources(
        rbt.RotatedFields(**{k: v.to(dev) for k, v in vars(fields).items()}),
        GBuffer(**{k: v.to(dev) for k, v in vars(gb).items()}),
        tuple(c.to(dev) for c in src), n_waves=2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("s,w,block", [(128, 64, 32), (384, 256, 128)])
def test_backward_gather_rbt_on_card_matches_cpu(dev, s, w, block):
    """backward_gather_rbt's float32 products on the card (TF32 off) against
    the same call on CPU copies, 1e-4 of the maximum."""
    from litbox_tpu_torch.core.types import GBuffer
    from litbox_tpu_torch.sim.backward import backward_gather_rbt

    assert not torch.backends.cuda.matmul.allow_tf32
    fields = _fields_on("cpu", 8, s, w, 0.0, 50)
    gb = GBuffer(albedo=_rand("cpu", 51, (w, w, 4)),
                 transmissibility=_rand("cpu", 52, (w, w), 0.5, 1.0),
                 normal=torch.zeros((w, w, 4)))
    hdr = _rand("cpu", 53, (w, w, 3), 0.0, 2.0)
    ref = backward_gather_rbt(fields, gb, hdr, 5, block=block)
    got = backward_gather_rbt(
        rbt.RotatedFields(**{k: v.to(dev) for k, v in vars(fields).items()}),
        GBuffer(**{k: v.to(dev) for k, v in vars(gb).items()}), hdr.to(dev), 5, block=block)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4 * float(ref.abs().max()), rtol=0)


def _train_cfg(**kw):
    from litbox_tpu_torch.nn.loss import HdrLossConfig
    from litbox_tpu_torch.nn.train import TrainConfig
    from litbox_tpu_torch.nn.unet import TransformConfig

    # runs/train_denoiser_r5.py's recipe at a small width
    return TrainConfig(unet_size=2, initial_features=8, crop_size=32, batch_size=4,
                       rgb=True, global_residual=True, pair_composition=True,
                       lr_decay_steps=20, warmup_steps=2, lr_min=1e-6,
                       loss=HdrLossConfig(normalize_weights=True, log_l1=0.25, rel_l2=1.0,
                                          compress="log1p"),
                       transform=TransformConfig(use_log_space=True, normalize_input=True),
                       **kw)


def _stage(seed, n=3, h=48, w=40):
    rng = np.random.default_rng(seed)
    ref = rng.exponential(0.5, (n, h, w, 3)).astype(np.float32)
    a = (ref * rng.exponential(1.0, ref.shape)).astype(np.float32)
    b = (ref * rng.exponential(1.0, ref.shape)).astype(np.float32)
    a[rng.uniform(size=a.shape) < 0.1] = 0.0
    return a, b, ref


def test_sample_batch_pair_on_card_matches_cpu(dev):
    """The samplers on the card from the same draws as on the CPU: the
    same batches bit for bit."""
    from litbox_tpu_torch.nn import device_data as dd

    data = _stage(60)
    d = dd.draw(torch.Generator().manual_seed(1), data[0].shape, 32, 16, 0.15)
    d_card = dd.Draws(**{k: v.to(dev) for k, v in vars(d).items()})
    cpu = [torch.from_numpy(x) for x in data]
    card = [x.to(dev) for x in cpu]
    for rgb in (True, False):
        for fn in (dd.sample_batch_pair_from, dd.sample_batch_from):
            for g, r in zip(fn(*card, d_card, 16, rgb), fn(*cpu, d, 16, rgb)):
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), r)


def test_trainer_step_on_card_matches_cpu(dev, monkeypatch):
    """One pair step of the same weights and batch on the card (float32
    convolutions: TF32 off) and on the CPU: the loss, every gradient and
    the new running statistics within 1e-3 of the largest magnitude of
    their tree (the card and the CPU sum in other orders), then the updated
    parameters likewise. conv_out starts from small random weights: at
    the identity init the pair's corrections are rounding noise, and the
    display's k, their ratio, would differ between any two devices."""
    from litbox_tpu_torch.nn.train import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = _train_cfg()
    card, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    assert card.device.type == "cuda"
    with torch.no_grad():
        w = card.model.conv_out.weight
        w.copy_(_rand(dev, 63, tuple(w.shape), -0.01, 0.01))
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    a, b, ref = (torch.from_numpy(x[:, :32, :32]) for x in _stage(61))
    lc = card.train_batch_pair_async(a.to(dev), b.to(dev), ref.to(dev))
    lh = cpu.train_batch_pair_async(a, b, ref)
    assert abs(float(lc) - float(lh)) <= 1e-3 * abs(float(lh))

    def check(got: dict, want: dict):
        scale = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            err = float((got[k].cpu() - v).abs().max())
            assert err <= 1e-3 * scale, (k, err, scale)

    check({k: p.grad for k, p in card.params.items()}, {k: p.grad for k, p in cpu.params.items()})
    check(card.model.state_dict(), cpu.model.state_dict())


def test_pair_training_is_sync_free(dev, monkeypatch):
    """Sampling on the card and train_batch_pair_async never make the host
    wait (torch's sync debug mode raises on a sync), and the losses are
    finite when read afterwards."""
    from litbox_tpu_torch.nn.device_data import DeviceStages
    from litbox_tpu_torch.nn.train import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    stages = DeviceStages({"Final": _stage(62)})
    tr = Trainer(_train_cfg())
    gen = torch.Generator(device=dev).manual_seed(3)
    tr.train_batch_pair_async(*stages.sample_pair("Final", gen, 4, 32, True, 0.15))
    torch.cuda.synchronize()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            losses.append(tr.train_batch_pair_async(
                *stages.sample_pair("Final", gen, 4, 32, True, identity_p=0.15)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert int(tr.optimizer.state["count"]) == 6 == tr.global_step


@pytest.mark.parametrize("seed,version,size", [(11, 2, 256), (7, 1, 512)])
def test_substrate_on_card_matches_cpu(dev, seed, version, size):
    """A substrate generated on the card against the same params on the
    CPU: to 1e-5, away from texels whose shape test flips between the two
    (at most 2, each within 1e-5 of a shape's edge in local coordinates)."""
    from litbox_tpu_torch.data import substrate

    p = substrate.generate_random_params(seed, version, size)
    got = substrate.generate_texture(p, dev)
    assert got.device.type == "cuda"
    want = substrate.generate_texture(p, "cpu")
    _, _, xy = substrate._grid(size, "cpu")
    flips = substrate._inside(p, xy.to(dev)).cpu() != substrate._inside(p, xy)
    assert int(flips.sum()) <= 2
    keep = torch.ones((size, size), dtype=torch.bool)
    for fy, fx in torch.nonzero(flips).tolist():
        ys, xs = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
        keep &= torch.hypot((ys - fy).float(), (xs - fx).float()) > p.edge_blur + 2
    torch.testing.assert_close(got.cpu()[keep], want[keep], atol=1e-5, rtol=0)


def test_relight_and_analysis_on_card_match_cpu(dev):
    """relight_layer and analysis_b on the card against the same calls on
    CPU copies, to 1e-6 of each output's maximum."""
    from litbox_tpu_torch.diag.analysis import analysis_a, analysis_b
    from litbox_tpu_torch.post.cloud_relight import relight_layer

    hdr = _rand(dev, 70, (128, 128, 3), 0.0, 4.0)
    trans = _rand(dev, 71, (128, 128), 0.2, 1.0)
    albedo = _rand(dev, 72, (128, 128, 4))
    hdr_b = _rand(dev, 73, (128, 128, 3), 0.0, 4.0)
    for fn, args in ((lambda h, t: relight_layer(h, t, 1.5, 3.0), (hdr, trans)),
                     (lambda a, b, al: analysis_b(analysis_a(a, b), al, a, analysis_a(a, b)),
                      (hdr, hdr_b, albedo))):
        got = fn(*args)
        want = fn(*(x.cpu() for x in args))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


def test_kernel_wrappers_refuse_another_card(dev):
    """The kernel library launches on the current device, so K1's wrapper
    raises for tensors on another card and runs there once that card is
    current (as a rank of a multi-card world sets it)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    t = _rand(other, 90, (8, 16, 128), 0.3, 1.0)
    srcs = [_rand(other, 91 + c, (8, 16, 128)) for c in range(3)]
    with pytest.raises(ValueError, match="current device"):
        attnscan.attenuation_scan_rows(t, *srcs)
    with torch.cuda.device(other):
        got = attnscan.attenuation_scan_rows(t, *srcs)
        torch.cuda.synchronize()
    for g, r in zip(got, attnscan.attenuation_scan_rows_plain(t, *srcs)):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def _bin_resolve(fields, src, w):
    """sharded_rbt_resolve_bins of one ensemble row over the whole world."""
    from litbox_tpu_torch.parallel import make_mesh, sharded_rbt_resolve_bins

    return sharded_rbt_resolve_bins(make_mesh(), fields, src, w, w)[0].cpu()


def test_bin_resolve_world1_nccl_matches_cpu(dev):
    """A world of one rank with NCCL: sharded_rbt_resolve_bins of a 256²
    frame (S=384, D=128: K1, then rotate_bins' K2 and K3) equals the same
    function in a gloo world on CPU copies (the plain versions), within
    1e-5 of the maximum."""
    from litbox_tpu_torch.parallel import world

    d, s, w = 128, 384, 256
    fields = _fields_on("cpu", d, s, w, 0.0, 80)
    src = tuple(_rand("cpu", 81 + c, (d, s, s)) for c in range(3))
    ref = world.run(_bin_resolve, 1, fields, src, w, device="cpu", inline_rank0=True)[0]
    on_card = rbt.RotatedFields(**{k: v.to(dev) for k, v in vars(fields).items()})
    got = world.run(_bin_resolve, 1, on_card, tuple(c.to(dev) for c in src), w,
                    device="cuda", inline_rank0=True)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
