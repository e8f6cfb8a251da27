"""The port's training data (litbox_tpu_torch.nn.dataset and
nn.device_data) against the JAX package's, bit for bit: DenoiserDataset
batches and build_curriculum for one numpy seed (with the channel take
of a batch, Batch.channel, against its whole arrays), stack_stage, and the
on-device samplers fed the same explicit draws as the JAX package's
composition (dynamic_slice, where, rot90, the channel take,
litbox_tpu/nn/device_data.py:67-86, 118-136)."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.io import write_exr_rgb as jwrite_exr_rgb
from litbox_tpu.io import write_png as jwrite_png
from litbox_tpu.nn import dataset as jdataset
from litbox_tpu.nn import device_data as jdd
from litbox_tpu_torch.core import spans
from litbox_tpu_torch.nn import dataset as tdataset
from litbox_tpu_torch.nn import device_data as tdd
from litbox_tpu_torch.nn.train import Trainer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Files written by the JAX package, with PNG albedo as its tests use."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    for i in range(5):
        ref = rng.uniform(0, 2, (48, 40, 3)).astype(np.float32)
        jwrite_exr_rgb(str(root / f"output_{i:03d}.exr"), ref)
        for t in "ab":
            jwrite_exr_rgb(str(root / f"input_{t}_{i:03d}.exr"),
                           np.abs(ref + rng.normal(0, 0.3, ref.shape)).astype(np.float32))
            jwrite_exr_rgb(str(root / f"easy_{t}_{i:03d}.exr"), ref * 1.01, half=True)
        jwrite_png(str(root / f"albedo_{i:03d}.png"), rng.uniform(0, 1, (48, 40, 3)))
        jwrite_exr_rgb(str(root / f"trans_{i:03d}.exr"), rng.uniform(0.5, 1, (48, 40, 3)),
                       compression="zips")
    return root


def _globs(root):
    return [str(root / f"{p}_*") for p in ("output", "albedo", "trans", "input_a", "input_b")]


@pytest.mark.parametrize("upsample,shuffle,scales", [(1, True, None), (2, False, None),
                                                      (1, True, (0.5, 2.0, 1.0, 3.0, 0.1))])
def test_dataset_batches_match_jax(corpus, upsample, shuffle, scales):
    ref, alb, trans, a, b = (sorted(glob.glob(g)) for g in _globs(corpus))
    args = (a, b, alb, trans, ref)
    jds = jdataset.DenoiserDataset(*args, crop_size=24, upsample=upsample, scales=scales)
    tds = tdataset.DenoiserDataset(*args, crop_size=24, upsample=upsample, scales=scales)
    assert len(tds) == len(jds) == 5
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):  # the second epoch reads the decoded-image cache
        jb = list(jds.batches(2, jr, shuffle=shuffle))
        tb = list(tds.batches(2, tr, shuffle=shuffle))
        assert len(tb) == len(jb) == 2
        for x, y in zip(tb, jb):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    item = tds.__getitem__(1, np.random.default_rng(3))
    assert item[0].shape == (24 // upsample, 24 // upsample, 3) and item[4].shape == (24, 24, 3)


LAZY = pytest.mark.parametrize("upsample,scales,shuffle", [
    (u, sc, sh) for u in (1, 2) for sc in (None, (0.5, 2.0, 1.0, 3.0, 0.1)) for sh in (True, False)])


def _port_dataset(corpus, upsample, scales):
    ref, alb, trans, a, b = (sorted(glob.glob(g)) for g in _globs(corpus))
    return tdataset.DenoiserDataset(a, b, alb, trans, ref, crop_size=24, upsample=upsample,
                                    scales=scales)


@LAZY
def test_channel_take_is_the_full_arrays_channel(corpus, upsample, scales, shuffle):
    """select_random_channel's inputs and targets are the bits of
    full[idx, :, :, c][..., None] of the same batch's whole arrays, read
    afterwards, and it leaves the rng where drawing c from it does."""
    tds = _port_dataset(corpus, upsample, scales)
    r, replay = np.random.default_rng(2 ** 31 + 5), np.random.default_rng(2 ** 31 + 5)
    for _ in range(2):
        for batch, twin in zip(tds.batches(2, r, shuffle=shuffle),
                               tds.batches(2, replay, shuffle=shuffle)):
            x, y = Trainer.select_random_channel(batch, r, "cpu")
            c = replay.integers(0, 3, 2)
            assert r.bit_generator.state == replay.bit_generator.state
            for got, key in ((x, "input_a"), (y, "reference")):
                want = twin[key][np.arange(2), :, :, c][..., None]
                assert got.dtype == torch.float32 and got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want)
                np.testing.assert_array_equal(got.numpy(), batch[key][np.arange(2), :, :, c][..., None])


@LAZY
def test_channels_then_full_arrays_match_jax(corpus, upsample, scales, shuffle):
    """Taking channels first does not change the whole arrays a batch makes
    afterwards: they are still the JAX package's batches, bit for bit, read
    by key or through the mapping's items()."""
    ref, alb, trans, a, b = (sorted(glob.glob(g)) for g in _globs(corpus))
    jds = jdataset.DenoiserDataset(a, b, alb, trans, ref, crop_size=24, upsample=upsample,
                                   scales=scales)
    tds = _port_dataset(corpus, upsample, scales)
    jr, tr, cr = np.random.default_rng(11), np.random.default_rng(11), np.random.default_rng(12)
    for x, y in zip(tds.batches(2, tr, shuffle=shuffle), jds.batches(2, jr, shuffle=shuffle)):
        c = cr.integers(0, 3, 2)
        for key in tdataset.NAMES:
            np.testing.assert_array_equal(x.channel(key, c)[..., 0], y[key][np.arange(2), :, :, c])
        assert sorted(x) == sorted(y) and len(x) == len(y) and "albedo" in x
        whole = dict(x.items())
        assert list(whole) == list(tdataset.NAMES)
        for key in y:
            assert whole[key].shape == y[key].shape and whole[key] is x[key]
            np.testing.assert_array_equal(whole[key], y[key])


@LAZY
def test_channel_take_makes_only_what_it_sends(corpus, upsample, scales, shuffle):
    """A batch read only through select_random_channel makes no whole
    array: data.batch_bytes counts the bytes sent, train.h2d_bytes."""
    tds = _port_dataset(corpus, upsample, scales)
    rng = np.random.default_rng(3)
    spans.reset()
    try:
        sent = 0
        for batch in tds.batches(2, rng, shuffle=shuffle):
            x, y = Trainer.select_random_channel(batch, rng, "cpu")
            sent += x.nbytes + y.nbytes
        made = spans.counters()
        assert made["data.batch_bytes"] == made["train.h2d_bytes"] == sent
        assert spans.totals()["data.batch"][0] == len(tds) // 2
        whole = sum(batch[k].nbytes for k in ("input_a", "reference"))
        assert spans.counters()["data.batch_bytes"] == sent + whole
    finally:
        spans.reset()


def test_curriculum_matches_jax(corpus):
    ref, alb, trans, a, b = _globs(corpus)
    easy = (str(corpus / "easy_a_*"), str(corpus / "easy_b_*"))
    kw = dict(easy=easy, crop_size=16)
    jst = jdataset.build_curriculum(ref, alb, trans, a, b, **kw)
    tst = tdataset.build_curriculum(ref, alb, trans, a, b, **kw)
    assert [n for n, _ in tst] == [n for n, _ in jst] == ["Easy", "Final"]
    for (_, t), (_, j) in zip(tst, jst):
        assert t.input_a_paths == j.input_a_paths and t.reference_paths == j.reference_paths
        tb = next(t.batches(3, np.random.default_rng(1), shuffle=True))
        jb = next(j.batches(3, np.random.default_rng(1), shuffle=True))
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])
    with pytest.raises(ValueError, match="no reference files"):
        tdataset.build_curriculum(str(corpus / "nothing_*"), alb, trans, a, b)


def test_stack_stage_matches_jax(corpus):
    ref, _, _, a, b = (sorted(glob.glob(g)) for g in _globs(corpus))
    scales = [1.0, 0.5, 2.0, 1.5, 0.25]
    for x, y in zip(tdd.stack_stage(a, b, ref, scales), jdd.stack_stage(a, b, ref, scales)):
        assert x.dtype == np.float32 and x.shape == (5, 48, 40, 3)
        np.testing.assert_array_equal(x, y)


def _stage(seed, n=4, h=20, w=18):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    return a, a + 100.0, a + 10_000.0


def _jax_one(data_a, data_b, data_ref, d, crop, pair):
    """The JAX package's per-item composition with the port's draws."""
    data_a, data_b, data_ref = (jnp.asarray(x) for x in (data_a, data_b, data_ref))

    def one(i, t, l, r_k, sw, flag):
        a = jax.lax.dynamic_slice(data_a[i], (t, l, 0), (crop, crop, 3))
        b = jax.lax.dynamic_slice(data_b[i], (t, l, 0), (crop, crop, 3))
        ref = jax.lax.dynamic_slice(data_ref[i], (t, l, 0), (crop, crop, 3))
        rot4 = lambda x: jax.lax.switch(  # noqa: E731
            r_k, [lambda v: v, lambda v: jnp.rot90(v, 1),
                  lambda v: jnp.rot90(v, 2), lambda v: jnp.rot90(v, 3)], x)
        if pair:
            a, b = jnp.where(sw, b, a), jnp.where(sw, a, b)
            return rot4(jnp.where(flag, ref, a)), rot4(jnp.where(flag, ref, b)), rot4(ref)
        inp = jnp.where(sw, b, a)
        other = jnp.where(sw, a, b)
        return rot4(inp), rot4(jnp.where(flag, other, ref))

    return jax.vmap(one)(*(jnp.asarray(getattr(d, k).numpy()) for k in
                           ("idx", "top", "left", "rot", "swap", "flag")))


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("rgb", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_samplers_match_jax_composition(pair, rgb, p):
    a, b, ref = _stage(1)
    crop, batch = 8, 16
    gen = torch.Generator().manual_seed(int(p * 10) + 2 * pair + rgb)
    d = tdd.draw(gen, a.shape, batch, crop, p)
    assert set(d.rot.tolist()) == {0, 1, 2, 3}
    tdata = [torch.from_numpy(x) for x in (a, b, ref)]
    fn = tdd.sample_batch_pair_from if pair else tdd.sample_batch_from
    got = fn(*tdata, d, crop, rgb)
    want = _jax_one(a, b, ref, d, crop, pair)
    if not rgb:
        take = jax.vmap(lambda x, c: x[..., c])
        chan = jnp.asarray(d.chan.numpy())
        want = tuple(take(x, chan)[..., None] for x in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (batch, crop, crop, 3 if rgb else 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_draws_and_device_stages():
    a, b, ref = _stage(2, n=3, h=16, w=24)
    stages = tdd.DeviceStages({"Final": (a, b, ref)}, device="cpu")
    gen = torch.Generator().manual_seed(0)
    inp, tgt = stages.sample("Final", gen, 64, 8, True, n2n_p=1.0)
    np.testing.assert_allclose((tgt - inp).abs().numpy(), 100.0, atol=1e-4)
    x, y, r = stages.sample_pair("Final", gen, 64, 8, False, identity_p=0.0)
    assert x.shape == (64, 8, 8, 1)
    d = torch.abs(r - x)
    assert bool(((d - 10_000).abs() < 1).logical_or((d - 9_900).abs() < 1).all())
    x, y, r = stages.sample_pair("Final", gen, 64, 8, True, identity_p=1.0)
    assert torch.equal(x, r) and torch.equal(y, r)
    d = tdd.draw(torch.Generator().manual_seed(5), a.shape, 4000, 8, 0.15)
    assert int(d.top.max()) == 16 - 8 and int(d.left.max()) == 24 - 8
    assert int(d.idx.max()) == 2 and int(d.chan.max()) == 2
    assert 0.13 < float(d.flag.float().mean()) < 0.17
    assert 0.47 < float(d.swap.float().mean()) < 0.53
