"""The port's IO (litbox_tpu_torch.io, litbox_tpu_torch.native) against the
JAX package's: EXR files written by either read back bit for bit through the
other, for every compression the writer has (none, ZIPS, ZIP) in half and
float, and a hand-encoded RLE file; the native decoder equals the Python
codec bit for bit; PNG reads dispatch as the JAX package's do."""

import struct

import numpy as np
import pytest

from litbox_tpu import io as jio
from litbox_tpu.io import exr as jexr
from litbox_tpu_torch import io as tio
from litbox_tpu_torch import native
from litbox_tpu_torch.io import exr as texr


def _rgb(seed, shape=(37, 53, 3)):
    return np.random.default_rng(seed).uniform(0, 50, shape).astype(np.float32)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_exr_round_trips_across_packages(tmp_path, compression, half):
    rgb = _rgb(0)
    ours, theirs = str(tmp_path / "ours.exr"), str(tmp_path / "theirs.exr")
    tio.write_exr_rgb(ours, rgb, compression=compression, half=half)
    jio.write_exr_rgb(theirs, rgb, compression=compression, half=half)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    expect = rgb.astype(np.float16).astype(np.float32) if half else rgb
    for path in (ours, theirs):
        np.testing.assert_array_equal(jio.read_exr_rgb(path), expect)
        np.testing.assert_array_equal(tio.read_exr_rgb(path), expect)
        np.testing.assert_array_equal(tio.read_image_linear(path), expect)


def test_exr_named_channels_and_multiblock(tmp_path):
    rng = np.random.default_rng(1)
    chans = {"Z": rng.normal(size=(70, 41)).astype(np.float32),
             "A": rng.normal(size=(70, 41)).astype(np.float32)}
    path = str(tmp_path / "t.exr")
    tio.write_exr(path, chans)  # 70 rows: five ZIP blocks, the last partial
    back, ref = tio.read_exr(path), jio.read_exr(path)
    assert sorted(back) == ["A", "Z"]
    for k, v in chans.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(ref[k], v)


def _rle_encode(raw: bytes) -> bytes:
    """OpenEXR's RLE of one block: the ZIP predictor and interleave, then
    runs (count >= 0: count + 1 copies of a byte) and literals (count < 0)."""
    data = np.frombuffer(raw, np.uint8)
    half = (data.size + 1) // 2
    reordered = np.concatenate([data[0::2], data[1::2]])
    assert reordered[:half].size == half
    d = reordered.astype(np.int64)
    d[1:] = d[1:] - reordered[:-1].astype(np.int64) + 128
    d = d.astype(np.uint8).tobytes()
    out, i = bytearray(), 0
    while i < len(d):
        run = 1
        while i + run < len(d) and run < 128 and d[i + run] == d[i]:
            run += 1
        if run >= 3:
            out += struct.pack("b", run - 1) + d[i:i + 1]
            i += run
        else:
            n = min(127, len(d) - i)
            out += struct.pack("b", -n) + d[i:i + n]
            i += n
    return bytes(out)


def _rle_file(path, rgb):
    """Rewrite an uncompressed EXR of `rgb` as RLE (compression 1)."""
    texr.write_exr_rgb(path, rgb, compression="none")
    buf = bytearray(open(path, "rb").read())
    at = buf.index(b"compression\x00compression\x00") + len("compression\x00compression\x00") + 4
    buf[at] = 1
    h = rgb.shape[0]
    offsets_at = len(buf) - sum(8 + rgb.shape[1] * 12 for _ in range(h)) - 8 * h
    offsets = struct.unpack_from(f"<{h}Q", buf, offsets_at)
    blocks = []
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        blocks.append((y, _rle_encode(bytes(buf[off + 8:off + 8 + size]))))
    head = bytes(buf[:offsets_at])
    pos = len(head) + 8 * h
    table, body = [], b""
    for y, enc in blocks:
        table.append(pos + len(body))
        body += struct.pack("<ii", y, len(enc)) + enc
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{h}Q", *table) + body)


def test_rle_reads_in_both_packages_and_falls_back_from_native(tmp_path):
    rgb = np.round(_rgb(2, (9, 20, 3)))  # repeated bytes make real runs
    rgb[:, :7] = 1.0
    path = str(tmp_path / "rle.exr")
    _rle_file(path, rgb)
    np.testing.assert_array_equal(jexr.read_exr_rgb(path), rgb)
    np.testing.assert_array_equal(texr.read_exr_rgb(path), rgb)
    assert native.read_exr_rgb_native(path) is None  # the decoder takes no RLE
    np.testing.assert_array_equal(tio.read_image_linear(path), rgb)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_native_matches_python_codec(tmp_path, compression, half):
    path = str(tmp_path / "t.exr")
    tio.write_exr_rgb(path, _rgb(3), compression=compression, half=half)
    out = native.read_exr_rgb_native(path)
    assert out is not None
    np.testing.assert_array_equal(out, texr.read_exr_rgb(path))


def test_native_batch_decode(tmp_path):
    rng = np.random.default_rng(4)
    paths, imgs = [], []
    for i in range(6):
        img = rng.uniform(0, 4, (24, 32, 3)).astype(np.float32)
        paths.append(str(tmp_path / f"b{i}.exr"))
        tio.write_exr_rgb(paths[-1], img, half=bool(i % 2))
        imgs.append(texr.read_exr_rgb(paths[-1]))
    out = native.read_exr_rgb_batch_native(paths, 24, 32)
    np.testing.assert_array_equal(out, np.stack(imgs))
    assert native.read_exr_rgb_batch_native([], 24, 32) is None


def test_native_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.exr")
    with open(p, "wb") as f:
        f.write(b"version https://git-lfs...")
    assert native.read_exr_rgb_native(p) is None
    assert native.read_exr_rgb_batch_native([p], 4, 4) is None
    with pytest.raises(ValueError, match="not an EXR"):
        tio.read_image_linear(p)


def test_native_builds_outside_the_package_and_raises_on_failure(tmp_path, monkeypatch):
    assert native.build() == native.library_path()
    assert native.library_path().parent.parent == native.SOURCE.parent.parent / "_build"
    bad = tmp_path / "exr_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_png_dispatch_matches_jax(tmp_path):
    rgb = np.random.default_rng(5).uniform(0, 1, (20, 24, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "o.png"), str(tmp_path / "t.png")
    tio.write_png(ours, rgb)
    jio.write_png(theirs, rgb)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tio.read_image_linear(ours), jio.read_image_linear(ours))
    np.testing.assert_allclose(tio.read_png_linear(ours), rgb, atol=0.02)
