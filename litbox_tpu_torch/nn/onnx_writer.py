"""Minimal hand-rolled ONNX exporter for the Litbox denoiser UNet.

The reference ships its denoiser as ONNX (train_litbox_denoiser.py:276-281,
`torch.onnx.export(..., denoiser.onnx)`); this image has neither the `onnx`
package nor onnxruntime, so this module emits the ONNX protobuf DIRECTLY in
the protobuf wire format. The UNet needs only 9 ops — Conv,
BatchNormalization, Relu, MaxPool, Concat, DepthToSpace (PixelShuffle in
CRD mode), Pad (reflect padding), Add, Sigmoid — all stable since opset 13.

Wire encoding background: a protobuf message is a sequence of
(field_number << 3 | wire_type) varint keys followed by the payload;
wire_type 0 = varint, 2 = length-delimited (strings, bytes, submessages,
packed repeated numerics). Field numbers below are from onnx.proto
(onnx/onnx.proto3, IR version 8 / opset 13).

A copy of the JAX package's nn/onnx_writer.py (numpy and struct only), so
that the port imports nothing of that package; the producer name stays
"litbox_tpu", so both packages emit the same bytes for the same weights
(tests/test_torch_export.py). The JAX package's tests/test_onnx_export.py
re-decodes and executes the emitted file against its network.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------- encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _packed_i64(field: int, values) -> bytes:
    return _f_bytes(field, b"".join(_varint(int(v)) for v in values))


# ------------------------------------------------------------ onnx pieces

FLOAT = 1   # TensorProto.DataType
INT64 = 7

ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_INTS = 1, 2, 3, 7


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.asarray(arr)
    dtype = INT64 if arr.dtype == np.int64 else FLOAT
    raw = arr.astype("<i8" if dtype == INT64 else "<f4").tobytes()
    msg = b"".join(_f_varint(1, d) for d in arr.shape)
    msg += _f_varint(2, dtype) + _f_str(8, name) + _f_bytes(9, raw)
    return msg


def _attr(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, ints=8, type=20."""
    msg = _f_str(1, name)
    if isinstance(value, float):
        msg += _key(2, 5) + struct.pack("<f", value) + _f_varint(20, ATTR_FLOAT)
    elif isinstance(value, int):
        msg += _f_varint(3, value) + _f_varint(20, ATTR_INT)
    elif isinstance(value, str):
        msg += _f_bytes(4, value.encode()) + _f_varint(20, ATTR_STRING)
    elif isinstance(value, (list, tuple)):
        msg += _packed_i64(8, value) + _f_varint(20, ATTR_INTS)
    else:
        raise TypeError(type(value))
    return msg


def _node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b"".join(_f_str(1, i) for i in inputs)
    msg += b"".join(_f_str(2, o) for o in outputs)
    msg += _f_str(3, name or outputs[0]) + _f_str(4, op_type)
    msg += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return msg


def _value_info(name: str, dims) -> bytes:
    """ValueInfoProto{name=1, type=2}; dims entries: int (fixed) or str
    (dim_param, symbolic)."""
    shape = b"".join(
        _f_bytes(1, _f_varint(1, d) if isinstance(d, int) else _f_str(2, d))
        for d in dims)
    tensor_type = _f_varint(1, FLOAT) + _f_bytes(2, shape)
    return _f_str(1, name) + _f_bytes(2, _f_bytes(1, tensor_type))


def _model(graph: bytes, opset: int = 13) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset_id = _f_str(1, "") + _f_varint(2, opset)
    return (_f_varint(1, 8)                       # IR version 8
            + _f_str(2, "litbox_tpu")
            + _f_bytes(7, graph)
            + _f_bytes(8, opset_id))


# ------------------------------------------------------------- the graph

def write_onnx_unet(state: dict, path: str, unet_size: int = 5,
                    padding_mode: str = "reflect", use_sigmoid: bool = False,
                    in_channels: int = 1, global_residual: bool = False) -> str:
    """Emit the LitboxDenoiserNet graph as an ONNX file.

    `state` is the reference-layout torch state_dict from
    nn.export.export_torch_state (numpy arrays, NCHW conv weights), so the
    graph structure mirrors litbox_model.py exactly: conv_in -> unet_size
    encoders+pools -> 2-block bottleneck -> unet_size [conv+PixelShuffle,
    concat, 2 skip ResBlocks] -> conv_out. Input/output are NCHW with
    symbolic batch/height/width dims (the reference exports dynamic batch,
    train_litbox_denoiser.py:280).
    """
    nodes: list[bytes] = []
    inits: list[bytes] = []
    uid = [0]

    def fresh(tag: str) -> str:
        uid[0] += 1
        return f"{tag}_{uid[0]}"

    def init(name: str, arr) -> str:
        inits.append(_tensor(name, np.asarray(arr)))
        return name

    def pad_reflect(x: str) -> str:
        out = fresh("pad")
        pads = init(out + "_pads",
                    np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64))
        nodes.append(_node("Pad", [x, pads], [out], mode="reflect"))
        return out

    def conv(x: str, prefix: str, kernel: int, padded: bool) -> str:
        w = init(prefix + ".weight", state[prefix + ".weight"])
        b = init(prefix + ".bias", state[prefix + ".bias"])
        out = fresh("conv")
        p = 0 if padded or kernel == 1 else 1
        nodes.append(_node("Conv", [x, w, b], [out],
                           kernel_shape=[kernel, kernel],
                           pads=[p, p, p, p], strides=[1, 1]))
        return out

    def conv3(x: str, prefix: str, pm: str) -> str:
        if pm == "reflect":
            return conv(pad_reflect(x), prefix, 3, padded=True)
        return conv(x, prefix, 3, padded=False)

    def bn(x: str, prefix: str) -> str:
        names = [init(prefix + s, state[prefix + s])
                 for s in (".weight", ".bias", ".running_mean", ".running_var")]
        out = fresh("bn")
        nodes.append(_node("BatchNormalization", [x] + names, [out],
                           epsilon=1e-5))
        return out

    def relu(x: str) -> str:
        out = fresh("relu")
        nodes.append(_node("Relu", [x], [out]))
        return out

    def resblock(x: str, prefix: str, pm: str, has_shortcut: bool) -> str:
        y = relu(bn(conv3(x, prefix + ".primary.0", pm), prefix + ".primary.1"))
        y = bn(conv3(y, prefix + ".primary.3", pm), prefix + ".primary.4")
        sc = conv(x, prefix + ".shortcut", 1, padded=True) if has_shortcut else x
        out = fresh("add")
        nodes.append(_node("Add", [y, sc], [out]))
        return relu(out)

    pm = padding_mode
    y = relu(conv3("input", "conv_in.0", pm))
    y = resblock(y, "conv_in.2", pm, has_shortcut=False)

    skips = []
    for i in range(unet_size):
        y = resblock(y, f"unet_encoders.{i}", pm, has_shortcut=True)
        skips.append(y)
        out = fresh("pool")
        nodes.append(_node("MaxPool", [y], [out],
                           kernel_shape=[2, 2], strides=[2, 2]))
        y = out

    y = resblock(y, "bottleneck.0", pm, has_shortcut=True)
    y = resblock(y, "bottleneck.1", pm, has_shortcut=False)

    for i in range(unet_size):
        # Decoder conv uses the reference's default (zero) padding
        # (litbox_model.py:293), then PixelShuffle == DepthToSpace mode=CRD.
        y = conv(y, f"unet_decoders.{i}.0", 3, padded=False)
        out = fresh("shuffle")
        nodes.append(_node("DepthToSpace", [y], [out], blocksize=2, mode="CRD"))
        cat = fresh("concat")
        nodes.append(_node("Concat", [out, skips[unet_size - 1 - i]], [cat],
                           axis=1))
        y = resblock(cat, f"unet_skipconns.{i}.0", pm, has_shortcut=True)
        y = resblock(y, f"unet_skipconns.{i}.1", pm, has_shortcut=False)

    y = conv(y, "conv_out", 3, padded=False)
    if global_residual:
        out = fresh("res_add")
        nodes.append(_node("Add", [y, "input"], [out]))
        y = out
    if use_sigmoid:
        out = fresh("sigmoid")
        nodes.append(_node("Sigmoid", [y], [out]))
        y = out
    nodes.append(_node("Identity", [y], ["output"]))

    out_channels = state["conv_out.weight"].shape[0]
    graph = b"".join(_f_bytes(1, n) for n in nodes)
    graph += _f_str(2, "litbox_denoiser")
    graph += b"".join(_f_bytes(5, t) for t in inits)
    graph += _f_bytes(11, _value_info(
        "input", ["batch", in_channels, "height", "width"]))
    graph += _f_bytes(12, _value_info(
        "output", ["batch", out_channels, "height", "width"]))

    with open(path, "wb") as f:
        f.write(_model(graph))
    return path
