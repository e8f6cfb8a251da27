"""litbox_tpu_torch/core/spans.py: nesting, self time, step records, the
profiler flag, the bounded ring, the counters and spans of the training
path, the frame's and the Simulation's spans, and the benchmark's readers
of them (litbench/metrics/*.train.py) on a recorder filled by a CPU run.

This file imports neither JAX nor the JAX package. Its `cuda` tests run on
a card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import inspect
import os
import time

import numpy as np
import pytest
import torch

from litbench import core as bench_core
from litbox_tpu_torch.core import luts, spans
from litbox_tpu_torch.core.types import Realtime1080pProfile
from litbox_tpu_torch.engine import Mode, Simulation, realtime
from litbox_tpu_torch.io.exr import write_exr_rgb
from litbox_tpu_torch.nn.dataset import DenoiserDataset
from litbox_tpu_torch.nn.device_data import DeviceStages
from litbox_tpu_torch.nn.train import TrainConfig, Trainer
from litbox_tpu_torch.nn.unet import LitboxDenoiserNet, TransformConfig
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("batch_ms.train", "gap_ms.train", "issue_ms.train", "wait_ms.train",
           "batch_use.train")
TRAIN_SPANS = {"data.batch", "data.channel", "train.h2d", "train.forward", "train.backward",
               "train.optimizer", "train.loss_read", "train.step"}
TINY = dict(unet_size=2, initial_features=4, crop_size=16, batch_size=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def clock(monkeypatch):
    """A host clock that advances 10 ns a read."""
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(spans, "_now", lambda: next(ticks))


def test_nesting_parents_and_self_time(clock):
    rec = spans.Recorder()
    with rec.step("train.step") as step:
        with rec.span("train.forward") as fwd:
            with rec.span("inner") as inner:
                pass
        with rec.span("train.backward") as bwd:
            pass
    assert (step.parent, fwd.parent, inner.parent, bwd.parent) == (
        None, "train.step", "train.forward", "train.step")
    # Reads: step 0, forward 10, inner 20-30, forward ends 40, backward 50-60, step 70.
    assert (step.start_ns, step.end_ns, fwd.start_ns, fwd.end_ns) == (0, 70, 10, 40)
    totals = rec.totals()
    assert totals["inner"] == (1, 10, 10)
    assert totals["train.forward"] == (1, 30, 20)
    assert totals["train.backward"] == (1, 10, 10)
    assert totals["train.step"] == (1, 70, 30)
    assert step.device_start_ns is None and step.device_end_ns is None


def test_step_records_hold_the_batch_that_fed_the_step():
    rec = spans.Recorder()
    for i in range(3):
        with rec.span("data.batch"):
            rec.count("data.batch_bytes", 100 + i)
        with rec.step("train.step"):
            # A step span inside a step closes no record of its own.
            with rec.step("sim.step"):
                pass
    with rec.span("data.batch"):
        pass
    records = rec.step_records()
    assert [r.step for r in records] == [0, 1, 2]
    assert all(r.kind == "train.step" and not r.profiled for r in records)
    for i, r in enumerate(records):
        assert [s.name for s in r.spans] == ["data.batch", "sim.step", "train.step"]
        assert {s.step for s in r.spans} == {i}
        assert r.counts == {"data.batch_bytes": 100 + i}
        assert r.find("data.batch") is r.spans[0] and r.find("absent") is None
    assert rec.counters() == {"data.batch_bytes": 303}
    # The batch made after the last step waits for the next one.
    assert [(s.name, s.step) for s in rec.timeline()[-1:]] == [("data.batch", 3)]


def test_the_profiler_flag():
    rec = spans.Recorder()
    with rec.step("train.step"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.step("train.step"):
            pass
    with rec.step("train.step"):
        pass
    assert [r.profiled for r in rec.step_records()] == [False, True, False]


def test_the_record_ring_and_pending_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(spans, "RING", 8)
    monkeypatch.setattr(spans, "PENDING_MAX", 16)
    rec = spans.Recorder()
    for _ in range(20):
        with rec.step("frame.step"):
            with rec.span("frame.deposits"):
                pass
    assert [r.step for r in rec.step_records()] == list(range(12, 20))
    assert rec.totals()["frame.deposits"][0] == 20
    for _ in range(40):
        with rec.span("data.batch"):
            pass
    assert len(rec.timeline()) == 8 * 2 + 16
    assert rec.totals()["data.batch"][0] == 40


def _corpus(root, scenes: int, size: int = 24) -> DenoiserDataset:
    rng = np.random.default_rng(0)
    names = ("input_a", "input_b", "albedo", "transmissibility", "reference")
    paths = {k: [] for k in names}
    for k in names:
        for i in range(scenes):
            p = os.path.join(root, f"{k}_{i}.exr")
            write_exr_rgb(p, rng.uniform(0.1, 2.0, (size, size, 3)).astype(np.float32),
                          compression="none")
            paths[k].append(p)
    return DenoiserDataset(*(paths[k] for k in names), crop_size=TINY["crop_size"])


def test_trainer_step_spans_and_counters(tmp_path):
    dataset = _corpus(str(tmp_path), scenes=2)
    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    rng = np.random.default_rng(1)
    spans.reset()
    batch = next(dataset.batches(2, rng))
    x, y = Trainer.select_random_channel(batch, rng, "cpu")
    trainer.train_batch(x, y)
    (r,) = spans.step_records()
    assert {s.name for s in r.spans} == TRAIN_SPANS
    parents = {s.name: s.parent for s in r.spans}
    assert parents["train.forward"] == parents["train.backward"] == "train.step"
    assert parents["train.optimizer"] == parents["train.loss_read"] == "train.step"
    assert parents["data.batch"] is None and parents["train.h2d"] is None
    assert r.counts["train.h2d_bytes"] == x.nbytes + y.nbytes
    assert r.counts["data.exr_reads"] == 2 * 5
    # The mono step makes and copies one channel of input A and of the
    # reference, and the batch makes nothing else.
    assert r.counts["data.batch_bytes"] == r.counts["train.h2d_bytes"]
    assert x.shape == (2, TINY["crop_size"], TINY["crop_size"], 1)
    # The async step has the same spans but no loss read.
    trainer.train_batch_async(x, y)
    assert {s.name for s in spans.step_records()[-1].spans} == {
        "train.forward", "train.backward", "train.optimizer", "train.step"}


def test_pair_step_spans_and_counters():
    """The round-5 pair step: DeviceStages.sample_pair records data.sample
    and the bytes it returns, Trainer.pair_loss records train.compose inside
    train.forward; a mono step records neither. sample_ms.pair reads the
    window's data.sample."""
    trainer = Trainer(TrainConfig(**TINY, rgb=True, global_residual=True,
                                  pair_composition=True), device="cpu")
    rng = np.random.default_rng(4)
    stages = DeviceStages({"Final": tuple(rng.uniform(0.1, 2.0, (3, 24, 24, 3)).astype(np.float32)
                                          for _ in range(3))}, device="cpu")
    gen = torch.Generator().manual_seed(5)
    crop = TINY["crop_size"]
    spans.reset()
    batches = []
    for _ in range(3):
        batches.append(stages.sample_pair("Final", gen, 2, crop, True, identity_p=0.5))
        trainer.train_batch_pair_async(*batches[-1])
    records = spans.step_records()
    assert len(records) == 3
    r = records[-1]
    assert {s.name for s in r.spans} == {"data.sample", "train.forward", "train.compose",
                                         "train.backward", "train.optimizer", "train.step"}
    parents = {s.name: s.parent for s in r.spans}
    assert parents["train.compose"] == "train.forward" and parents["data.sample"] is None
    compose, forward = r.find("train.compose"), r.find("train.forward")
    assert forward.start_ns <= compose.start_ns <= compose.end_ns <= forward.end_ns
    assert r.counts["data.sample_bytes"] == sum(x.nbytes for x in batches[-1])
    assert r.counts["data.sample_bytes"] == 3 * 2 * crop ** 2 * 3 * 4
    x, y = stages.sample("Final", gen, 2, crop, False)
    assert spans.counters()["data.sample_bytes"] == 3 * r.counts["data.sample_bytes"] + 2 * x.nbytes
    assert _reader("sample_ms.pair").read({"steps": 2}) == pytest.approx(float(np.median(
        [q.host_ms("data.sample") for q in records[-2:]])))
    assert _reader("sample_ms.pair").read({}) is None
    mono = Trainer(TrainConfig(**TINY), device="cpu")
    spans.reset()
    mono.train_batch_async(x, y)
    assert {s.name for s in spans.step_records()[-1].spans} == {
        "train.forward", "train.backward", "train.optimizer", "train.step"}


def test_level1_makes_no_device_call(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a device call at level 1")

    dataset = _corpus(str(tmp_path), scenes=2)
    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rng = np.random.default_rng(2)
    trainer.train_batch(*Trainer.select_random_channel(next(dataset.batches(2, rng)), rng, "cpu"))
    assert len(spans.timeline()) == len(TRAIN_SPANS)


@pytest.mark.parametrize("rgb", [False, True])
def test_fit_records_the_steps_spans(tmp_path, rgb):
    dataset = _corpus(str(tmp_path), scenes=4)
    trainer = Trainer(TrainConfig(**TINY, rgb=rgb, epochs=1), device="cpu")
    spans.reset()
    trainer.fit([("Final", dataset)], log_every=1e9, max_steps=2)
    records = spans.step_records()
    assert len(records) == 2
    for r in records:
        want = TRAIN_SPANS - ({"data.channel"} if rgb else set())
        assert {s.name for s in r.spans} == want
        # The batch makes what the step sends: input A and the reference,
        # whole (RGB) or one channel of each (mono).
        assert r.counts["train.h2d_bytes"] == r.counts["data.batch_bytes"] == (
            2 * 2 * TINY["crop_size"] ** 2 * (3 if rgb else 1) * 4)
    assert spans.counters()["data.exr_reads"] == 4 * 5


def test_only_step_spans_close_records():
    """A record closes where its caller opened a span with step(name),
    whatever the name; span(name) closes none, even under a step's name."""
    rec = spans.Recorder()
    with rec.span("train.step"):
        pass
    assert rec.step_records() == []
    with rec.step("any.step"):
        pass
    (r,) = rec.step_records()
    assert r.kind == "any.step"
    assert [s.name for s in r.spans] == ["train.step", "any.step"]


def test_level2_puts_the_edges_on_the_host_clock(monkeypatch):
    """Level 2 on stand-in CUDA events: the anchor's device time is its host
    time, each edge lies after it by the events' elapsed time, the events go
    back to the pool, and after disable() a span records none."""

    class Event:
        made = 0

        def __init__(self, enable_timing=False):
            Event.made += 1

        def record(self, stream=None):
            self.t = next(device)

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e-6

    host = iter([1000, 2000, 3000, 5000, 6000, 7000, 8000])
    device = iter([50, 1500, 4000, 4100, 4200])
    monkeypatch.setattr(spans, "_now", lambda: next(host))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    rec = spans.Recorder()
    rec.enable()  # anchor: device 50 at host 1000
    with rec.span("work") as work:  # host 2000-3000, device 1500-4000
        pass
    (got,) = rec.timeline()
    assert got is work and (work.start_ns, work.end_ns) == (2000, 3000)
    assert work.device_start_ns == pytest.approx(2450)
    assert work.device_end_ns == pytest.approx(4950)
    assert Event.made == 3 and len(rec._pool) == 2
    with rec.span("again"):  # host 5000-6000, its events from the pool
        pass
    assert Event.made == 3
    rec.disable()
    with rec.span("off") as off:  # host 7000-8000
        pass
    timeline = rec.timeline()
    assert timeline[1].device_end_ns == pytest.approx(1000 + 4200 - 50)
    assert off.device_start_ns is None and Event.made == 3


def test_enable_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        spans.enable()


def _reader(name: str):
    return bench_core.load_module(os.path.join(ROOT, "litbench", "metrics", name + ".py"),
                                  "litbench_metric_" + name.replace(".", "_"))


def test_readers_on_a_cpu_run(tmp_path):
    """The harness's loop (litbench/traffic/train_steps.py) at a tiny size:
    set-up steps, the window's steps, then a profiled step; the readers see
    the window's."""
    dataset = _corpus(str(tmp_path), scenes=4)
    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    rng = np.random.default_rng(3)

    def feed():
        while True:
            yield from dataset.batches(2, rng, shuffle=True)

    batches = feed()

    def one_step():
        trainer.train_batch(*Trainer.select_random_channel(next(batches), rng, "cpu"))

    for _ in range(2):
        one_step()
    window = 5
    for _ in range(window):
        one_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        one_step()
    records = [r for r in spans.step_records() if not r.profiled][-window:]
    assert len(records) == window and spans.step_records()[-1].profiled
    got = {name: _reader(name).read({"steps": window}) for name in READERS}
    median = lambda xs: float(np.median(xs))  # noqa: E731
    assert got["batch_ms.train"] == pytest.approx(median(
        [r.host_ms("data.batch", "data.channel", "train.h2d") for r in records]))
    assert got["issue_ms.train"] == pytest.approx(median(
        [r.host_ms("train.forward", "train.backward", "train.optimizer") for r in records]))
    assert got["wait_ms.train"] == pytest.approx(median(
        [r.host_ms("train.loss_read") for r in records]))
    gaps = [(b.find("train.h2d").start_ns - a.find("train.loss_read").end_ns) * 1e-6
            for a, b in zip(records, records[1:])]
    assert got["gap_ms.train"] == pytest.approx(median(gaps))
    assert got["gap_ms.train"] > 0
    assert got["batch_use.train"] == pytest.approx(100)
    for name in READERS:
        assert _reader(name).read({}) is None


NET = dict(unet_size=2, initial_features=4, padding_mode="reflect", global_residual=True,
           out_channels=3)


def test_realtime_step_runs_without_mark():
    """The shipped frame at a cut profile (40x24, 16 bins, 2 groups) on the
    CPU: step(state, generator) takes no `mark` and records a frame.step
    with its stage spans, the calibration display on frame 0."""
    prof = Realtime1080pProfile(
        sim_width=40, sim_height=24, out_width=160, out_height=96, photons=1024,
        bounce_photons=256, n_bins=16, resolve_groups=2, bf16_display=False)
    h, w = prof.sim_height, prof.sim_width
    b = SceneBuilder(texture_size=16)
    b.add_point_light((w * 0.5, h * 0.55), radius=4.0, intensity=2.0, bounces=2)
    b.add_rect((w / 2, h / 2), (w / 2, h / 2), log_density=-1.0)
    scene = b.build(max_lights=2, max_shapes=2, device="cpu")
    gb = rasterize(scene, h, w)
    fields = rbt.precompute_rotated_fields(gb, n_bins=prof.n_bins)
    torch.manual_seed(0)
    weights = LitboxDenoiserNet(**NET).state_dict()
    init_state, step = realtime.make_pair_frame_step(
        gb, scene.lights, scene.field_textures, torch.from_numpy(luts.brdf_lut((16, 5, 3))),
        fields, weights, prof=prof, net=NET,
        transform=TransformConfig(use_log_space=True, normalize_input=True))
    assert list(inspect.signature(step).parameters) == ["state", "generator"]
    state = init_state()
    gen = torch.Generator().manual_seed(7)
    spans.reset()
    for _ in range(2):
        pix, k = step(state, gen)
    assert pix.shape == (prof.out_height, prof.out_width, 3) and 0 <= float(k) <= 1
    stages = ["frame.deposits", "frame.flush", "frame.resolve"]
    tail = ["frame.upsample_tonemap", "frame.step"]
    records = spans.step_records()
    assert [[s.name for s in r.spans] for r in records] == [
        stages + ["frame.display_cal"] + tail, stages + ["frame.display_fast"] + tail]
    assert {s.parent for r in records for s in r.spans[:-1]} == {"frame.step"}


def test_simulation_spans():
    b = SceneBuilder()
    b.add_point_light((16, 16), radius=1.5, intensity=1.5, bounces=2)
    b.add_rect((16, 16), (32, 32), log_density=-1.2)
    sim = Simulation(width=32, height=32, mode=Mode.REFERENCE, rays_per_frame=512,
                     measurement_interval=2, device="cpu")
    sim.set_scene(b.build(max_lights=1, max_shapes=1, device="cpu"))
    spans.reset()
    for _ in range(2):
        sim.step()
        sim.update_performance_metrics()
    records = spans.step_records()
    assert [r.kind for r in records] == ["sim.step", "sim.step"]
    assert [[s.name for s in r.spans] for r in records] == [
        ["sim.trace", "sim.step"], ["sim.trace", "sim.measure", "sim.step"]]
    assert sim.photons_per_second > 0


# ----- on the card -----


@pytest.mark.cuda
def test_level2_stages_sum_to_the_event_timed_step(card):
    """Under enable(), the card's times of train.forward, train.backward and
    train.optimizer sum to within 5% of the step timed by events around
    it."""
    trainer = Trainer(TrainConfig(crop_size=128), device=card)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.1, 2, (4, 128, 128, 1)).astype(np.float32), device=card)
    y = torch.as_tensor(rng.uniform(0.1, 2, (4, 128, 128, 1)).astype(np.float32), device=card)
    trainer.train_batch(x, y)
    spans.enable()
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_batch_async(x, y)
        end.record()
        spans.timeline()
        r = spans.step_records()[-1]
        parts = {s.name: s.device_end_ns - s.device_start_ns for s in r.spans}
        stages_ms = 1e-6 * (parts["train.forward"] + parts["train.backward"]
                            + parts["train.optimizer"])
        assert stages_ms == pytest.approx(start.elapsed_time(end), rel=0.05)
    spans.disable()


@pytest.mark.cuda
def test_level2_edges_follow_the_host(card):
    """The card idles while the host sleeps in a span between two launches:
    it reaches each edge at or after the host records it, and the sleep's
    edges about the sleep apart."""
    x = torch.ones(1 << 20, device=card)
    spans.enable()
    with spans.step("train.step"):
        with spans.span("work"):
            x.mul_(1.0001)
        with spans.span("host.sleep") as sleep:
            time.sleep(0.02)
        with spans.span("work"):
            x.mul_(1.0001)
    timeline = spans.timeline()
    spans.disable()
    assert all(s.device_start_ns >= s.start_ns - 50_000 for s in timeline)
    assert all(s.device_end_ns >= s.end_ns - 50_000 for s in timeline)
    assert 18 <= (sleep.device_end_ns - sleep.device_start_ns) * 1e-6 <= 25


@pytest.mark.cuda
def test_perf_counters_read_completed_events_without_a_synchronize(card, monkeypatch):
    b = SceneBuilder()
    b.add_point_light((32, 32), radius=1.5, intensity=1.5, bounces=2)
    b.add_rect((32, 32), (64, 64), log_density=-1.2)
    sim = Simulation(width=64, height=64, mode=Mode.REFERENCE, rays_per_frame=4096,
                     measurement_interval=0, device=card)
    sim.set_scene(b.build(max_lights=1, max_shapes=1, device=card))
    sim.step()
    sync = torch.cuda.synchronize
    sync()
    refuse = lambda *a, **k: (_ for _ in ()).throw(AssertionError("synchronize"))  # noqa: E731
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    sim.update_performance_metrics()
    for _ in range(4):
        sim.step()
    sync()
    sim.update_performance_metrics()
    sync()
    sim.update_performance_metrics()
    assert sim.photons_per_second > 0
    photons = sum(t.forward_photon_count for t in sim._tracers)
    assert photons == 2 * 5 * 4096
