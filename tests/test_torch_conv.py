"""ops.conv, the training step's convolutions.

On the CPU: CPU tensors take nn.Conv2d's own path bit for bit, also inside
a training step's step_convolutions; what the kernels cannot take raises
before the library is built; the counters advance once a call the kernels
serve; the plain
versions of the kernels' products (tap by tap; the data gradient's
transposed weight with its taps reversed) equal PyTorch's convolution and its
autograd; the launch plans. The kernel path's autograd plumbing runs with
its launches replaced by those plain versions.

On the card (`-m cuda`; this file imports neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_conv.py

every distinct convolution of the two training cells' nets and of the
parallel step's net (chip_smoke.py) against float64 on the CPU, within twice the distance of PyTorch's own float32 path, two
calls equal bit for bit, and the net's paddings (reflect, zeros,
padding=1) through the kernels; KPCN's three 5x5 layers at the
kpcn-21-train cell's 64 patches of 65^2 the same way, against float64 on
the card.
"""

import pytest
import torch
import torch.nn.functional as F

from litbox_tpu_torch.core import spans
from litbox_tpu_torch.nn import kpcn
from litbox_tpu_torch.nn.unet import Conv3x3, LitboxDenoiserNet, StepConv2d, conv_shapes
from litbox_tpu_torch.ops import conv, cuda_lib
from litbox_tpu_torch.ops.conv import step_convolutions

# The nets of the benchmark's two training cells, unet5-train (TrainConfig())
# and unet4-rgb-pair-train (the round-5 recipe, 2 x 16 items through the
# net), and the sharded step of chip_smoke.py's parallel phase at one rank
# (build_sharded_train_step's defaults at crop 64; each slice the whole layer).
NETS = {"unet5": (4, 256, dict(unet_size=5, initial_features=32)),
        "pair": (32, 192, dict(unet_size=4, initial_features=16, global_residual=True,
                               out_channels=3)),
        "par": (4, 64, dict(unet_size=5, initial_features=32))}
LAYERS = [(net, shape) for net, (b, crop, args) in NETS.items()
          for shape in conv_shapes(b, crop, crop, **args)]
# KPCN's trunk at the kpcn-21-train cell's batch: 22 -> 100, 100 -> 100 and
# 100 -> 441 channels, 5x5 with padding 2, on 64 patches of 65^2.
KPCN_LAYERS = [("kpcn", shape) for shape in kpcn.conv_shapes(64, 65, 65)]


def _rand(shape, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype=dtype, device=device)


def _small_net(**kw):
    torch.manual_seed(0)
    return LitboxDenoiserNet(unet_size=2, initial_features=4, **kw)


def _run(net, x):
    out = net(x, train=True)
    out.square().mean().backward()
    return out.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("global_residual", [False, True])
def test_cpu_tensors_take_nn_conv2d_path_bit_for_bit(monkeypatch, global_residual):
    """Inside a training step's step_convolutions of a card a CPU net's
    convolutions go to conv2d, once a StepConv2d, which gives CPU tensors
    F.conv2d: the output and every gradient equal nn.Conv2d's own run's
    (no conv2d call) bit for bit, and nothing counts, as no kernel served
    them."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    calls, real = [], conv.conv2d

    def conv2d(*args):
        calls.append(args[1])
        return real(*args)

    monkeypatch.setattr(conv, "conv2d", conv2d)
    x = _rand((2, 16, 16, 3), 1)
    runs, n_calls = [], []
    for in_step in (False, True):
        net = _small_net(global_residual=global_residual, out_channels=3)
        calls.clear()
        if in_step:
            with step_convolutions("cuda"):
                runs.append(_run(net, x))
        else:
            runs.append(_run(net, x))
        n_calls.append(len(calls))
        layers = [m for m in net.modules() if isinstance(m, StepConv2d)]
    (out0, g0), (out1, g1) = runs
    assert torch.equal(out0, out1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert rec.counters() == {}
    assert n_calls == [0, len(layers)]
    assert {id(w) for w in calls} == {id(m.weight) for m in layers}


@pytest.mark.parametrize("layer", [
    torch.nn.Conv2d(4, 8, 3),
    torch.nn.Conv2d(4, 8, 3, padding=1, padding_mode="reflect"),
    torch.nn.Conv2d(4, 8, 3, stride=2, padding="valid", bias=False),
    torch.nn.Conv2d(4, 8, 3, groups=2, dilation=2, padding="same"),
])
def test_convolve_outside_a_step_is_nn_conv2d(layer):
    """Outside a step, convolve with the layer's own weight and bias is
    nn.Conv2d's forward bit for bit, whatever the layer's geometry."""
    x = _rand((2, 4, 12, 12), 14)
    assert torch.equal(conv.convolve(layer, x, layer.weight, layer.bias),
                       torch.nn.Conv2d.forward(layer, x))


def test_conv2d_on_cpu_tensors_is_f_conv2d():
    x, w, b = _rand((2, 5, 9, 9), 2), _rand((7, 5, 3, 3), 3), _rand((7,), 4)
    before = conv.conv2d.launches
    assert torch.equal(conv.conv2d(x, w, b, 1), F.conv2d(x, w, b, padding=1))
    assert conv.conv2d.launches == before


def test_cpu_step_convolutions_route_nothing(monkeypatch):
    """On the CPU a Trainer's step_convolutions changes nothing: the net's
    convolutions take nn.Conv2d's own path, and nothing counts."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    net = _small_net()
    with step_convolutions("cpu"):
        _run(net, _rand((1, 8, 8, 1), 5))
    assert rec.counters() == {}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_build():
    raise AssertionError("the kernel library was built")


@pytest.mark.parametrize("args,error,match", [
    ((_meta((2, 4, 8, 8), torch.float64), _meta((8, 4, 3, 3)), None, 1), TypeError, "float32"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 7, 7)), None, 2), ValueError, "1x1 and 3x3"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 3, 1)), None, 0), ValueError, "1x1 and 3x3"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 3, 3)), None, 3), ValueError, "padding 3"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 1, 1)), None, 1), ValueError, "padding 1"),
    ((_meta((2, 5, 8, 8)), _meta((8, 4, 3, 3)), None, 1), ValueError, "5 channels"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 3, 3)), _meta((4,)), 1), ValueError, "bias"),
    ((_meta((4, 8, 8)), _meta((8, 4, 3, 3)), None, 1), ValueError, "4-d"),
    ((_meta((2, 4, 2, 2)), _meta((8, 4, 3, 3)), None, 0), ValueError, "empty"),
    ((_meta((1, 1, 1 << 16, 1 << 15)), _meta((8, 1, 1, 1)), None, 0), ValueError, "32-bit"),
    ((_meta((2, 4, 8, 8)), _meta((8, 4, 3, 3)), _meta((8,)), 1), ValueError, "expected CUDA"),
])
def test_kernel_inputs_it_cannot_take_raise_before_the_build(monkeypatch, args, error, match):
    """Meta tensors stand in for CUDA ones: neither lies on the CPU, so they
    reach the wrapper's checks, which raise before the library is built."""
    monkeypatch.setattr(cuda_lib, "library", _no_build)
    before = conv.conv2d.launches
    with pytest.raises(error, match=match):
        conv.conv2d(*args)
    assert conv.conv2d.launches == before


def _plain_launches(monkeypatch):
    """The kernel path with its launches replaced by the plain versions of
    the kernels' products, reading the same arguments."""
    def forward(inp, weight, bias, out, pad, data_grad, tile, splits):
        assert 0 <= tile < len(conv.FORWARD_TILES) and splits >= 1
        out.copy_(conv.forward_plain(inp, weight, bias, pad, data_grad))

    def weight_grad(x, gy, gw, gb, tile, splits):
        assert 0 <= tile < len(conv.WEIGHT_GRAD_TILES) and splits >= 1
        w, b = conv.weight_grad_plain(x, gy, gw.shape[2], 0)
        gw.copy_(w)
        if gb is not None:
            gb.copy_(b)

    monkeypatch.setattr(conv, "_launch_forward", forward)
    monkeypatch.setattr(conv, "_launch_weight_grad", weight_grad)


@pytest.mark.parametrize("k,pad,bias,input_grad", [(3, 0, True, True), (3, 1, True, True),
                                                   (1, 0, True, True), (3, 0, False, False)])
def test_counters_advance_once_a_call_on_each_path(monkeypatch, k, pad, bias, input_grad):
    """The kernel path counts each direction it launches on conv2d.launches
    (the forward, the data gradient where the input needs one, the weight
    gradient); its gradients are autograd's. convolve outside a step counts
    nothing; inside, a CPU tensor takes F.conv2d and counts nothing, a
    float32 one off the CPU (stood in for here by patching the placement
    checks) counts one train.conv_kernel a call, whatever the directions
    it launches, and a float64 one off the CPU raises and counts
    nothing."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    _plain_launches(monkeypatch)
    x = _rand((2, 6, 10, 10), 6).requires_grad_(input_grad)
    w = _rand((5, 6, k, k), 7).requires_grad_()
    b = _rand((5,), 8).requires_grad_() if bias else None
    before = conv.conv2d.launches
    y = conv._Conv2d.apply(x, w, b, pad)
    assert conv.conv2d.launches == before + 1
    gy = _rand(y.shape, 9)
    y.backward(gy)
    n_back = 2 if input_grad else 1
    assert conv.conv2d.launches == before + 1 + n_back and rec.counters() == {}

    leaves = [t for t in (x, w, b) if t is not None and t.requires_grad]
    ref = [t.detach().double().requires_grad_() for t in leaves]
    args = {id(t): r for t, r in zip(leaves, ref)}
    yr = F.conv2d(args.get(id(x), x.double()), args[id(w)],
                  None if b is None else args[id(b)], padding=pad)
    torch.testing.assert_close(y.double(), yr.detach(), rtol=1e-5, atol=1e-5)
    yr.backward(gy.double())
    for t, r in zip(leaves, ref):
        torch.testing.assert_close(t.grad.double(), r.grad, rtol=1e-5, atol=1e-4)

    layer = torch.nn.Conv2d(6, 5, k, padding=pad, bias=bias)
    conv.convolve(layer, x.detach(), layer.weight, layer.bias)
    assert rec.counters() == {}
    with step_convolutions("cuda"):
        conv.convolve(layer, x.detach(), layer.weight, layer.bias)
        double = torch.nn.Conv2d(6, 5, k).double()
        conv.convolve(double, x.detach().double(), double.weight, double.bias)
    assert rec.counters() == {}
    monkeypatch.setattr(cuda_lib, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(cuda_lib, "require_cuda_float32", lambda *args: None)
    before = conv.conv2d.launches
    with step_convolutions("cuda"):
        conv.convolve(layer, x.detach().requires_grad_(input_grad), layer.weight,
                      layer.bias).sum().backward()
        with pytest.raises(TypeError, match="float32"):
            conv.convolve(double, x.detach().double(), double.weight, double.bias)
    assert rec.counters() == {"train.conv_kernel": 1}
    assert conv.conv2d.launches == before + 1 + n_back


@pytest.mark.parametrize("n,cin,cout,h,k,pad", [(2, 3, 16, 11, 3, 0), (1, 5, 3, 9, 3, 1),
                                                (2, 8, 6, 7, 1, 0), (1, 4, 1, 6, 3, 1)])
def test_plain_products_are_the_convolution_and_its_gradients(n, cin, cout, h, k, pad):
    """The products the kernels compute: the forward tap by tap, the
    transposed weight with its taps reversed of the data gradient (the
    gradient of the tensor the convolution saw), the gathered taps of the
    weight gradient and the bias's sum, against PyTorch in float64."""
    x = _rand((n, cin, h, h), 10, torch.float64).requires_grad_()
    w = _rand((cout, cin, k, k), 11, torch.float64).requires_grad_()
    b = _rand((cout,), 12, torch.float64).requires_grad_()
    y = F.conv2d(x, w, b, padding=pad)
    gy = _rand(y.shape, 13, torch.float64)
    y.backward(gy)
    torch.testing.assert_close(conv.forward_plain(x.detach(), w.detach(), b.detach(), pad),
                               y.detach())
    torch.testing.assert_close(conv.data_grad_plain(gy, w.detach(), pad), x.grad)
    gw, gb = conv.weight_grad_plain(x.detach(), gy, k, pad)
    torch.testing.assert_close(gw, w.grad)
    torch.testing.assert_close(gb, b.grad)


def test_plans_split_only_small_grids_with_no_empty_split():
    """Every distinct convolution of the nets: the forward's and the data
    gradient's tiles follow the output channels, and a sum is split only
    where the tiles are fewer than two waves of the card, into no more
    blocks than two waves and splits of MIN_SPLIT_STEPS steps or more, none
    of them empty; a weight gradient's split adds at most MAX_SPLIT_FLUSHES
    sums of its tile into its total, and where that asks for more splits
    than two waves (KPCN's 100 -> 441 layer alone), it takes no more than
    twice the splits it asks for."""
    assert len(LAYERS) == 102
    for net, (n, cin, cout, h, w, k, pad) in LAYERS + KPCN_LAYERS:
        ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
        for pixels, ch, cin_ in ((n * ho * wo, cout, cin), (n * h * w, cin, cout)):
            tile, splits = conv.plan_forward(pixels, ch, cin_, k)
            bm, bn, bk = conv.FORWARD_TILES[tile]
            assert bn >= min(ch, 128) or bn == 128
            tiles = -(-pixels // bm) * -(-ch // bn)
            steps = k * k * -(-cin_ // bk)
            per = -(-steps // splits)
            assert splits == 1 or tiles * (splits - 1) < 2 * conv.CARD_BLOCKS
            assert (splits - 1) * per < steps and per >= min(steps, conv.MIN_SPLIT_STEPS)
        tile, splits = conv.plan_weight_grad(n, ho * wo, cout, cin * k * k)
        bm, bn, bk = conv.WEIGHT_GRAD_TILES[tile]
        steps = n * -(-(ho * wo) // bk)
        per = -(-steps // splits)
        tiles = -(-(cin * k * k) // bm) * -(-cout // bn)
        flush = conv.flush_steps(tile, -(-(ho * wo) // bk))
        least = -(-steps // (conv.MAX_SPLIT_FLUSHES * flush))
        if (net, cout) == ("kpcn", 441):
            assert tiles * (least - 1) >= 2 * conv.CARD_BLOCKS and splits <= 2 * least
        else:
            assert splits == 1 or tiles * (splits - 1) < 2 * conv.CARD_BLOCKS
        assert (splits - 1) * per < steps and -(-per // flush) <= conv.MAX_SPLIT_FLUSHES


def test_every_layer_of_the_nets_is_one_the_kernels_take():
    """conv_shapes lists each distinct convolution of a net once: stride 1,
    1x1 or 3x3, padding below the kernel (Conv3x3 pads before, conv_out of
    global_residual with padding=1)."""
    pads = {(k, pad) for _, (n, cin, cout, h, w, k, pad) in LAYERS}
    assert pads == {(1, 0), (3, 0), (3, 1)}
    assert {(s[5], s[6]) for _, s in KPCN_LAYERS} == {(5, 2)}
    assert len({s for _, s in LAYERS}) == len(LAYERS)
    net = _small_net()
    assert all(isinstance(m.conv, StepConv2d) for m in net.modules() if isinstance(m, Conv3x3))


def test_takes_only_cuda_float32_layers(monkeypatch):
    """Inside a step, a float32 tensor off the CPU goes to the kernels'
    wrapper (a meta tensor reaches its placement check, which raises before
    the library is built); a float64 one off the CPU raises, as the kernels
    take float32 only; a CPU one takes F.conv2d. None of them counts."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    monkeypatch.setattr(cuda_lib, "library", _no_build)
    layer = torch.nn.Conv2d(4, 8, 3, padding=1)
    with step_convolutions("cuda"):
        with pytest.raises(ValueError, match="expected CUDA"):
            conv.convolve(layer, _meta((1, 4, 8, 8)), layer.weight, layer.bias)
        double = layer.double()
        with pytest.raises(TypeError, match="float32"):
            conv.convolve(double, _meta((1, 4, 8, 8), torch.float64), double.weight,
                          double.bias)
        layer = layer.float()
        assert conv.convolve(layer, torch.zeros(1, 4, 8, 8), layer.weight,
                             layer.bias).shape == (1, 8, 8, 8)
    assert rec.counters() == {}


@pytest.mark.parametrize("layer,match", [
    (torch.nn.Conv2d(4, 8, 3, stride=2), "stride 1"),
    (torch.nn.Conv2d(4, 8, 3, dilation=2), "stride 1"),
    (torch.nn.Conv2d(4, 8, 3, groups=2), "stride 1"),
    (torch.nn.Conv2d(4, 8, 3, padding=1, padding_mode="reflect"), "stride 1"),
    (torch.nn.Conv2d(4, 8, 3, padding=(1, 0)), "stride 1"),
    (torch.nn.Conv2d(4, 8, 3, padding="same"), "stride 1"),
    (torch.nn.Conv2d(4, 8, 7, padding=3), "1x1 and 3x3"),
])
def test_routed_float32_layers_the_kernels_cannot_take_raise(monkeypatch, layer, match):
    """Inside a step, a float32 convolution off the CPU that the kernels
    cannot take raises before the library is built, and counts nothing: it
    does not fall back to PyTorch's path."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    monkeypatch.setattr(cuda_lib, "library", _no_build)
    with step_convolutions("cuda"), pytest.raises(ValueError, match=match):
        conv.convolve(layer, _meta((2, 4, 12, 12)), layer.weight, layer.bias)
    assert rec.counters() == {}


# ----- on the card -----


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _directions(fn, x, w, b, pad, gy):
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b, padding=pad)
    return [y.detach(), *torch.autograd.grad(y, (x, w, b), gy)]


def _distance(got, want):
    return [float((g.double().cpu() - r).abs().max() / r.abs().max()) for g, r in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("net,shape", LAYERS, ids=[f"{n}-{'x'.join(map(str, s))}"
                                                   for n, s in LAYERS])
def test_kernels_match_float64_at_every_layer(dev, net, shape):
    """The forward, the data gradient, the weight gradient and the bias
    gradient of one of the nets' convolutions: within twice the distance
    of PyTorch's own float32 path (cuDNN off) from float64 on the CPU, of
    each output's largest magnitude; two calls equal bit for bit."""
    _hold_to_float64(shape, dev, "cpu")


def _hold_to_float64(shape, dev, f64_device):
    """One layer's four outputs through the kernels: within twice the
    distance of PyTorch's float32 path (cuDNN off) from float64 computed on
    `f64_device`, and two calls equal bit for bit."""
    n, cin, cout, h, w, k, pad = shape
    x = _rand((n, cin, h, w), 20)
    wt = _rand((cout, cin, k, k), 21) / (cin * k * k) ** 0.5
    b = _rand((cout,), 22)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    gy = _rand((n, cout, ho, wo), 23)
    want = [t.cpu() for t in _directions(F.conv2d, *(t.to(f64_device, torch.float64)
                                                      for t in (x, wt, b)), pad,
                                         gy.to(f64_device, torch.float64))]
    card = [t.to(dev) for t in (x, wt, b)]
    with torch.backends.cudnn.flags(enabled=False):
        torch_path = _directions(F.conv2d, *card, pad, gy.to(dev))
    before = conv.conv2d.launches
    kern = _directions(conv.conv2d, *card, pad, gy.to(dev))
    again = _directions(conv.conv2d, *card, pad, gy.to(dev))
    torch.cuda.synchronize()
    assert conv.conv2d.launches == before + 6
    assert all(torch.equal(a, c) for a, c in zip(kern, again))
    got, limit = _distance(kern, want), _distance(torch_path, want)
    assert all(g <= 2 * t for g, t in zip(got, limit)), (got, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for _, s in KPCN_LAYERS],
                         ids=["x".join(map(str, s)) for _, s in KPCN_LAYERS])
def test_kpcn_layers_match_float64(dev, shape):
    """KPCN's 5x5 layers at the cell's shapes, each direction as the
    nets' layers are held; float64 on the card (cuDNN's float64 path: a
    CPU would take minutes a layer)."""
    _hold_to_float64(shape, dev, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode,global_residual", [("reflect", False), ("zeros", True)])
def test_net_gradients_through_the_kernels(dev, padding_mode, global_residual):
    """A net's training step on the card through the kernels (reflect or
    zero padding by Conv3x3, padding=1 by conv_out): every convolution on
    the kernels, one train.conv_kernel a call, the gradients within 1e-5 of
    the largest from float64 on the CPU, and with zero padding two steps
    from the same weights equal bit for bit (with reflect padding,
    PyTorch's ReflectionPad2d backward adds its gradients with atomics, in
    no fixed order)."""
    torch.manual_seed(3)
    net = LitboxDenoiserNet(unet_size=2, initial_features=8, padding_mode=padding_mode,
                            global_residual=global_residual, out_channels=3)
    x = _rand((4, 32, 32, 3), 30)

    def grads(model, device, dtype):
        model = model.to(device=device, dtype=dtype)
        for p in model.parameters():
            p.grad = None
        with step_convolutions(device):
            model(x.to(device=device, dtype=dtype), train=True).square().mean().backward()
        return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}

    import copy
    rec = spans.Recorder()
    count, spans.count = spans.count, rec.count
    try:
        card = grads(copy.deepcopy(net), dev, torch.float32)
        card2 = grads(copy.deepcopy(net), dev, torch.float32)
    finally:
        spans.count = count
    ref = grads(copy.deepcopy(net), "cpu", torch.float64)
    calls = sum(isinstance(m, StepConv2d) for m in net.modules())
    assert rec.counters() == {"train.conv_kernel": 2 * calls}
    if padding_mode == "zeros":
        assert all(torch.equal(card[k], card2[k]) for k in card)
    scale = max(float(g.abs().max()) for g in ref.values())
    err = max(float((card[k] - g).abs().max()) for k, g in ref.items())
    assert err <= 1e-5 * scale, (err, scale)
