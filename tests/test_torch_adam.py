"""ops.adam's wrapper on the CPU: CPU tensors take the plain chain, and what
the kernel cannot take raises before anything is launched. The chain itself
is held to optax in test_torch_train.py; the kernel to the chain on the
card in test_torch_cuda.py.

Meta tensors stand in for CUDA ones: neither on the CPU, so they reach the
kernel's checks, which raise before the library is built or loaded.
"""

import pytest
import torch

from litbox_tpu_torch.core import spans
from litbox_tpu_torch.nn.train import Optimizer, TrainConfig
from litbox_tpu_torch.ops import adam

SHAPES = [(32, 4, 3, 3), (32,), (1,), (1, 32, 3, 3)]


def _set(device, seed=0, shapes=SHAPES):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device) for s in shapes]


@pytest.mark.parametrize("clip,schedule", [(1.0, False), (0.0, False), (1.0, True)])
def test_cpu_tensors_take_the_plain_chain(clip, schedule):
    """adam_update on CPU tensors is adam_update_plain, bit for bit, with no
    launch and no table; count and the schedule's count advance by one."""
    runs = []
    for fn in (adam.adam_update, adam.adam_update_plain):
        params, mu, nu = _set("cpu", 1), [torch.zeros(s) for s in SHAPES], _set("cpu", 2)
        nu = [x.abs() for x in nu]
        count = torch.tensor(3, dtype=torch.int32)
        sched = torch.tensor(3, dtype=torch.int32) if schedule else None
        lr = torch.tensor(2e-3) if schedule else 2e-3
        tables = adam.Tables()
        before = adam.adam_update.launches
        for step in range(2):
            grads = [3 * x for x in _set("cpu", 10 + step)]
            extra = (tables,) if fn is adam.adam_update else ()
            fn(params, grads, mu, nu, count, lr, clip, 0.01, sched, *extra)
        assert adam.adam_update.launches == before and tables.table is None
        assert int(count) == 5 and (sched is None or int(sched) == 5)
        runs.append((params, mu, nu))
    for got, want in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _meta_call(**changes):
    params = [torch.empty(s, device="meta") for s in SHAPES]
    args = dict(params=params, grads=[torch.empty_like(p) for p in params],
                mu=[torch.empty_like(p) for p in params],
                nu=[torch.empty_like(p) for p in params],
                count=torch.zeros((), dtype=torch.int32, device="meta"), lr=1e-3,
                grad_clip=1.0, weight_decay=0.01, schedule_count=None, tables=adam.Tables())
    args.update(changes)
    adam.adam_update(**args)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("changes,error,match", [
    (dict(grads=[_meta(s, torch.float64) for s in SHAPES]), TypeError, "float32 gradients"),
    (dict(grads=[_meta((3, 3, 4, 32)).permute(3, 2, 0, 1)] + [_meta(s) for s in SHAPES[1:]]),
     ValueError, "contiguous: False"),
    (dict(grads=[_meta(s) for s in SHAPES[1:]] + [_meta(SHAPES[0])]), ValueError,
     r"gradient of \(32,\)"),
    (dict(grads=[_meta(s) for s in SHAPES[:3]]), ValueError, "3 grads"),
    (dict(grads=[torch.empty(s) for s in SHAPES]), ValueError, "on cpu"),
    (dict(count=torch.zeros((), dtype=torch.int64, device="meta")), TypeError, "int32"),
    (dict(lr=torch.zeros((), dtype=torch.float64, device="meta")), TypeError, "lr must"),
    (dict(lr=torch.zeros(())), ValueError, "scalar on cpu"),
    (dict(tables=None), ValueError, "Tables"),
    (dict(mu=[_meta(s) for s in SHAPES[1:]] + [_meta(SHAPES[0])]), ValueError, "moments"),
    (dict(), ValueError, "expected CUDA"),
])
def test_kernel_inputs_it_cannot_take_raise(changes, error, match):
    before = adam.adam_update.launches
    with pytest.raises(error, match=match):
        _meta_call(**changes)
    assert adam.adam_update.launches == before


def test_more_tensors_than_a_launch_carries_raise():
    shapes = [(2,)] * (adam.MAX_TENSORS + 1)
    params = [_meta(s) for s in shapes]
    with pytest.raises(ValueError, match="1 to"):
        _meta_call(params=params, grads=[_meta(s) for s in shapes],
                   mu=[_meta(s) for s in shapes], nu=[_meta(s) for s in shapes])


def test_optimizer_counts_no_launch_on_the_cpu(monkeypatch):
    """Optimizer.step records its kernel launches in the counter
    train.optimizer_launches: none on the CPU."""
    params = dict(zip("abcd", _set("cpu")))
    opt = Optimizer(params, TrainConfig(learn_rate=1e-3))
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "count", rec.count)
    opt.step({k: torch.ones_like(v) for k, v in params.items()})
    assert rec.counters() == {"train.optimizer_launches": 0}
    assert int(opt.state["count"]) == 1
