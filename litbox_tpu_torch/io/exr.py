"""Minimal self-contained OpenEXR codec (scanline, NONE/RLE/ZIPS/ZIP compression).

A copy of the JAX package's io/exr.py (numpy, struct and zlib only), kept
here so that the port imports nothing of that package. Files written by
either copy read back bit for bit through the other.

Replaces the reference's EXR IO (`Assets/Scripts/Util/TextureExtensions.cs:283-308`
on the engine side and the `OpenEXR`/`Imath` python bindings used by
`litbox_dataset.py:40-58` / `train_litbox_denoiser.py:343-353`). The
environment has no OpenEXR bindings, so this implements the subset of the
format both sides use: single-part scanline images, FLOAT or HALF channels,
ZIP/ZIPS/NONE compression, increasing-y line order.

Format reference: OpenEXR file layout (openexr.com documentation). The ZIP
pixel pre-conditioning (delta predictor + two-half byte interleave) matches
OpenEXR's ImfZip.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x01312F76
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_TYPE_IDS = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
_COMPRESSION_NONE, _COMPRESSION_RLE, _COMPRESSION_ZIPS, _COMPRESSION_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMPRESSION_NONE: 1, _COMPRESSION_RLE: 1, _COMPRESSION_ZIPS: 1, _COMPRESSION_ZIP: 16}


def _read_cstring(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _zip_decode(data: bytes, raw_size: int) -> bytes:
    raw = np.frombuffer(zlib.decompress(data), dtype=np.uint8)
    if raw.size != raw_size:
        raise ValueError(f"EXR ZIP block decoded to {raw.size} bytes, expected {raw_size}")
    # Undo delta predictor: d[t] = d[t-1] + d[t] - 128 (mod 256).
    steps = raw.astype(np.int64)
    steps[1:] -= 128
    undeltad = np.cumsum(steps).astype(np.uint8)
    # Undo two-half interleave: output alternates bytes from each half.
    half = (raw.size + 1) // 2
    out = np.empty(raw.size, dtype=np.uint8)
    out[0::2] = undeltad[:half]
    out[1::2] = undeltad[half:]
    return out.tobytes()


def _zip_encode(raw: bytes) -> bytes:
    data = np.frombuffer(raw, dtype=np.uint8)
    half = (data.size + 1) // 2
    reordered = np.empty(data.size, dtype=np.uint8)
    reordered[:half] = data[0::2]
    reordered[half:] = data[1::2]
    # Delta predictor (inverse of the cumsum in _zip_decode).
    deltad = reordered.astype(np.int64)
    deltad[1:] = deltad[1:] - reordered[:-1].astype(np.int64) + 128
    return zlib.compress(deltad.astype(np.uint8).tobytes())


def _rle_decode(data: bytes, raw_size: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i : i - count]
            i += -count
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    if len(out) != raw_size:
        raise ValueError("EXR RLE block has wrong decoded size")
    # RLE uses the same predictor+interleave post-processing as ZIP.
    raw = np.frombuffer(bytes(out), dtype=np.uint8)
    steps = raw.astype(np.int64)
    steps[1:] -= 128
    undeltad = np.cumsum(steps).astype(np.uint8)
    half = (raw.size + 1) // 2
    final = np.empty(raw.size, dtype=np.uint8)
    final[0::2] = undeltad[:half]
    final[1::2] = undeltad[half:]
    return final.tobytes()


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Read a scanline EXR file into {channel_name: (H, W) float32 array}."""
    with open(path, "rb") as f:
        buf = f.read()

    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: deep/multipart EXR not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    compression = _COMPRESSION_NONE
    data_window = (0, 0, 0, 0)
    while True:
        name, pos = _read_cstring(buf, pos)
        if not name:
            break
        _attr_type, pos = _read_cstring(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_cstring(payload, cpos)
                (ptype,) = struct.unpack_from("<i", payload, cpos)
                cpos += 16  # pixel type + pLinear/reserved + x/y sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")

    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = -(-height // lines_per_block)

    offsets = struct.unpack_from(f"<{num_blocks}Q", buf, pos)
    dtypes = [np.dtype(_PIXEL_TYPES[ptype]) for _, ptype in channels]
    line_bytes = sum(width * dt.itemsize for dt in dtypes)
    out = {cname: np.empty((height, width), dtype=dt) for (cname, _), dt in zip(channels, dtypes)}

    for offset in offsets:
        y, size = struct.unpack_from("<ii", buf, offset)
        payload = buf[offset + 8 : offset + 8 + size]
        y0 = y - ymin
        n_lines = min(lines_per_block, height - y0)
        raw_size = line_bytes * n_lines
        if compression in (_COMPRESSION_ZIP, _COMPRESSION_ZIPS):
            raw = payload if size == raw_size else _zip_decode(payload, raw_size)
        elif compression == _COMPRESSION_RLE:
            raw = payload if size == raw_size else _rle_decode(payload, raw_size)
        else:
            raw = payload
        rpos = 0
        for line in range(n_lines):
            for (cname, _), dt in zip(channels, dtypes):
                nbytes = width * dt.itemsize
                out[cname][y0 + line] = np.frombuffer(raw, dtype=dt, count=width, offset=rpos)
                rpos += nbytes

    return {k: v.astype(np.float32) for k, v in out.items()}


def read_exr_rgb(path: str) -> np.ndarray:
    """Read an EXR as an (H, W, 3) float32 RGB array (reference reads R,G,B)."""
    data = read_exr(path)
    try:
        return np.stack([data["R"], data["G"], data["B"]], axis=-1)
    except KeyError as e:
        raise ValueError(f"{path}: missing RGB channel {e}; has {sorted(data)}") from e


def write_exr(path: str, channels: dict[str, np.ndarray], compression: str = "zip",
              half: bool = False) -> None:
    """Write a scanline EXR. `channels` maps name -> (H, W) array."""
    comp_id = {"none": _COMPRESSION_NONE, "zips": _COMPRESSION_ZIPS, "zip": _COMPRESSION_ZIP}[compression]
    names = sorted(channels)  # EXR requires alphabetical channel order
    dtype = np.float16 if half else np.float32
    planes = {n: np.ascontiguousarray(channels[n], dtype=dtype) for n in names}
    height, width = next(iter(planes.values())).shape
    for n, p in planes.items():
        if p.shape != (height, width):
            raise ValueError(f"channel {n} shape {p.shape} != {(height, width)}")

    chlist = b""
    for n in names:
        chlist += n.encode("latin-1") + b"\x00"
        chlist += struct.pack("<i", _PIXEL_TYPE_IDS[np.dtype(dtype)]) + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"

    def attr(name: str, attr_type: str, payload: bytes) -> bytes:
        return (name.encode() + b"\x00" + attr_type.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([comp_id]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    lines_per_block = _LINES_PER_BLOCK[comp_id]
    num_blocks = -(-height // lines_per_block)
    blocks = []
    for b in range(num_blocks):
        y0 = b * lines_per_block
        n_lines = min(lines_per_block, height - y0)
        raw = b"".join(
            planes[n][y0 + line].tobytes() for line in range(n_lines) for n in names
        )
        if comp_id in (_COMPRESSION_ZIP, _COMPRESSION_ZIPS):
            enc = _zip_encode(raw)
            if len(enc) >= len(raw):
                enc = raw
        else:
            enc = raw
        blocks.append((y0, enc))

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * num_blocks)
        offsets = []
        for y0, enc in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(enc)))
            f.write(enc)
        f.seek(offset_table_pos)
        f.write(struct.pack(f"<{num_blocks}Q", *offsets))


def write_exr_rgb(path: str, rgb: np.ndarray, compression: str = "zip", half: bool = False) -> None:
    rgb = np.asarray(rgb)
    write_exr(path, {"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]},
              compression=compression, half=half)
