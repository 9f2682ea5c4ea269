"""The port's span recorder (``ufm_torch/utils/profiling.py``) on the CPU.

- Outside a profile a span is one shared no-op context: nothing recorded,
  nothing allocated, no CUDA event made, over many predict calls and train
  steps.
- Inside one: nested spans with their parents and call ids, on the profiled
  thread only; a span's times fall inside the profiler's own event for it (one
  clock); an eager predict call and a train step record their stages in order.
- Device times (CUDA events stood in for by a fake): read when the spans are
  read, never before they are complete; a captured graph's stage events are
  recorded during its capture, profile or not, and a traced replay's stages
  are read before the next replay, skipped when incomplete, dropped when the
  graph was replayed over.
"""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch
from ufm_torch.utils import profiling

PREDICT = ["predict.call", "predict.prepare", "predict.pre", "net.encoder", "net.info_sharing", "net.heads",
           "predict.post", "predict.outputs"]
STEP = ["train.step", "train.forward", "net.encoder", "net.info_sharing", "net.heads", "train.loss",
        "train.backward", "train.optimizer"]


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


class FakeEvent:
    """A CUDA timing event: ``done`` says whether the device reached it."""

    made = []
    clock = 0.0  # ms: one a record

    def __init__(self, enable_timing=False, external=False):
        self.external, self.recorded, self.done, self.at = external, 0, False, 0.0
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.recorded += 1
        self.at = FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.at - self.at


@pytest.fixture
def fake_events(monkeypatch):
    FakeEvent.made, FakeEvent.clock = [], 0.0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return FakeEvent


@pytest.fixture(scope="module")
def tiny():
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    step = make_train_step(model.net, make_optimizer(model.net))
    batch = synthetic_batch(1, 28, 28, device="cpu")
    src = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    return model, step, batch, src


def test_outside_a_profile_a_span_is_one_shared_noop(fake_events):
    rec = profiling.Recorder()
    cuda = torch.device("cuda")
    first = rec.span("a")
    assert first is rec.span("b", call=True, device=cuda) is profiling.span("c")
    with rec.span("warm"):
        pass
    tracemalloc.start()
    try:
        for _ in range(2000):
            with rec.span("train.forward", device=cuda):
                pass
        kept = tracemalloc.take_snapshot().filter_traces([tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert kept.statistics("filename") == []
    assert rec.spans() == [] and fake_events.made == []


def test_nothing_is_recorded_over_many_calls_and_steps_outside_a_profile(tiny, fake_events):
    model, step, batch, src = tiny
    profiling.clear()
    for _ in range(3):
        model.predict_correspondences_batched(src, src)
        step(batch)
    assert profiling.spans() == [] and fake_events.made == []


def test_spans_nest_with_parents_and_call_ids():
    rec = profiling.Recorder()

    def other_thread():
        with rec.span("thread.root"):
            with rec.span("thread.child"):
                pass

    with _profile():
        with rec.span("outer", call=True):
            with rec.span("inner"):
                with rec.span("leaf"):
                    pass
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=30)
            with rec.span("second", call=True):  # a call inside another opens its own
                pass
        with rec.span("top"):  # a top span opens a call
            pass
    assert not t.is_alive()
    got = {sp.name: sp for sp in rec.spans()}
    assert got["outer"].parent is None
    assert got["inner"].parent == got["outer"].id and got["leaf"].parent == got["inner"].id
    assert got["inner"].call == got["leaf"].call == got["outer"].call
    assert got["second"].parent == got["outer"].id and got["second"].call != got["outer"].call
    assert "thread.root" not in got and "thread.child" not in got  # the profile runs on this thread only
    assert len({got[n].call for n in ("outer", "second", "top")}) == 3
    assert all(sp.start_ns <= sp.end_ns and sp.device_ms is None for sp in got.values())
    assert rec.spans()[0].name == "outer"  # in the order they opened
    rec.clear()
    assert rec.spans() == []


def test_a_spans_times_lie_inside_the_profilers_event():
    rec = profiling.Recorder()
    with _profile() as prof:
        with rec.span("clock.check", call=True):
            time.sleep(0.002)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (evt,) = [e for e in prof.events() if e.name == "clock.check"]
    (sp,) = rec.spans()
    assert start_ns + evt.time_range.start * 1e3 <= sp.start_ns
    assert sp.end_ns <= start_ns + evt.time_range.end * 1e3
    assert 2.0 <= sp.host_ms <= (evt.time_range.end - evt.time_range.start) / 1e3


def test_an_eager_predict_call_and_a_train_step_record_their_spans_in_order(tiny):
    model, step, batch, src = tiny
    profiling.clear()
    with _profile():
        model.predict_correspondences_batched(src, src)
        step(batch)
    spans = profiling.spans()
    profiling.clear()
    assert [sp.name for sp in spans] == PREDICT + STEP
    by_id = {sp.id: sp for sp in spans}
    call, train = spans[0], spans[len(PREDICT)]
    assert call.parent is None and train.parent is None and call.call != train.call
    assert all(sp.call == call.call for sp in spans[:len(PREDICT)])
    assert all(sp.call == train.call for sp in spans[len(PREDICT):])
    parents = {sp.name: by_id[sp.parent].name for sp in spans[len(PREDICT):] if sp.parent is not None}
    assert parents == {"train.forward": "train.step", "net.encoder": "train.forward", "net.info_sharing": "train.forward",
                       "net.heads": "train.forward", "train.loss": "train.step", "train.backward": "train.step",
                       "train.optimizer": "train.step"}
    assert all(sp.device_ms is None for sp in spans)  # CPU tensors: nothing to time on a device


def test_device_times_are_read_when_the_spans_are_read(fake_events):
    rec = profiling.Recorder()
    cuda = torch.device("cuda")
    with _profile():
        with rec.span("train.step", call=True):
            with rec.span("train.forward", device=cuda):
                pass
            with rec.span("train.backward", device=cuda):
                pass
    assert len(fake_events.made) == 4 and all(e.recorded == 1 for e in fake_events.made)
    fwd_start, fwd_end, bwd_start, bwd_end = fake_events.made
    fwd_start.done = fwd_end.done = True
    got = {sp.name: sp.device_ms for sp in rec.spans()}
    assert got == {"train.step": None, "train.forward": fwd_end.at - fwd_start.at, "train.backward": None}
    bwd_start.done = bwd_end.done = True  # read at the next read, not waited for before
    assert {sp.name: sp.device_ms for sp in rec.spans()}["train.backward"] == bwd_end.at - bwd_start.at


def _replay(rec, graph):
    with rec.span("predict.call", call=True):
        with rec.span("predict.launch", graph=graph):
            graph.replays += 1


def test_captured_stage_events_are_read_per_traced_replay(fake_events):
    rec = profiling.Recorder()
    with rec.capturing() as graph:  # outside a profile: events only
        with rec.span("predict.pre"):
            pass
        with rec.span("net.encoder"):
            pass
    assert rec.spans() == [] and not rec._sinks
    assert [name for name, _, _ in graph.stages] == ["predict.pre", "net.encoder"]
    assert all(e.external and e.recorded == 1 for e in fake_events.made)
    with rec.span("net.encoder"):  # after the capture: no event
        pass
    assert len(fake_events.made) == 4

    def complete(done):
        for _, start, end in graph.stages:
            start.done = end.done = done

    with _profile():
        _replay(rec, graph)  # call A
        complete(True)  # the device reached A's events
        _replay(rec, graph)  # call B: A read first
        complete(False)  # B's replay still queued
        _replay(rec, graph)  # call C: B skipped, never waited for
    graph.replays += 1  # an untraced replay overwrote C's events
    complete(True)
    spans = rec.spans()
    launches = [sp for sp in spans if sp.name == "predict.launch"]
    stages = [sp for sp in spans if sp.start_ns is None]
    assert len(launches) == 3 and [(sp.name, sp.parent) for sp in stages] == [
        ("predict.pre", launches[0].id), ("net.encoder", launches[0].id)]
    assert all(sp.call == launches[0].call and sp.device_ms == 1.0 for sp in stages)

    with _profile():
        _replay(rec, graph)  # call D: complete when read
    stages = [sp for sp in rec.spans() if sp.start_ns is None]
    assert len(stages) == 4 and stages[-1].call == [sp for sp in rec.spans() if sp.name == "predict.call"][-1].call
