"""The per-layer metrics that read the program's spans (``benchmark/spans.py``),
on a synthetic traced stretch and span list: host ms by span, device ms by
call, and the idle share inside ``predict.*`` spans on the trace's clock, by
the spans' own events where the profile kept them and else by aligning each
``predict.launch`` to its ``cudaGraphLaunch``. A run without a trace, or a
program without the recorder, reads nothing."""

from __future__ import annotations

import types

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the repo on the path)

from benchmark import run as bench_run
from benchmark.harness.trace import Trace
from ufm_torch.utils import profiling

BASE = 1_700_000_000_000_000_000  # Unix ns
OFFSET_US = 40.0  # trace µs = (ns - BASE) / 1e3 + OFFSET_US


def _ns(trace_us: float) -> int:
    return BASE + round((trace_us - OFFSET_US) * 1e3)


def _host(name, ident, parent, call, a_us, b_us):
    return profiling.Span(name, ident, parent, call, 1, _ns(a_us), _ns(b_us))


def _stage(name, ident, parent, call, ms):
    return profiling.Span(name, ident, parent, call, 1, device_ms=ms)


def _predict_spans():
    # two calls; trace µs: call 1 spans 250-600, its launch 260-290; call 2 950-990, launch 955-985
    return [
        _host("predict.call", 0, None, 0, 250, 600), _host("predict.prepare", 1, 0, 0, 250, 255),
        _host("predict.staging", 2, 0, 0, 255, 260), _host("predict.launch", 3, 0, 0, 260, 290),
        _host("predict.outputs", 4, 0, 0, 290, 300),
        _host("predict.call", 5, None, 1, 950, 990), _host("predict.prepare", 6, 5, 1, 950, 952),
        _host("predict.staging", 7, 5, 1, 952, 955), _host("predict.launch", 8, 5, 1, 955, 985),
        _host("predict.outputs", 9, 5, 1, 985, 990),
        _stage("predict.pre", 10, 3, 0, 0.2), _stage("net.encoder", 11, 3, 0, 5.0),
        _stage("net.info_sharing", 12, 3, 0, 2.0), _stage("net.heads", 13, 3, 0, 3.0),
        _stage("net.refine", 14, 3, 0, 1.5), _stage("predict.post", 15, 3, 0, 0.3),
        _stage("predict.pre", 16, 8, 1, 0.4), _stage("net.encoder", 17, 8, 1, 7.0),
        _stage("net.info_sharing", 18, 8, 1, 2.5), _stage("net.heads", 19, 8, 1, 3.5),
        _stage("net.refine", 20, 8, 1, 1.0),  # no predict.post reading: the call has no pre + post
    ]


def _stretch(host_extra=()):
    # device busy (µs) 100-200, 300-400, 1000-1100: gaps 200-300 and 400-1000 (700 µs)
    dev = [(100.0, 200.0, "h2d"), (300.0, 400.0, "kernel"), (1000.0, 1100.0, "kernel")]
    host = [(265.0, 285.0, "cudaGraphLaunch"), (960.0, 980.0, "cudaGraphLaunch"), (400.0, 999.0, "cudaDeviceSynchronize")]
    return Trace(dev, host + list(host_extra), window_s=1.1e-3, units=2)


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))

    return use


def _read(name, **run):
    return bench_run.metric_reader(name)(types.SimpleNamespace(**{"stretch": _stretch(), **run}))


# idle inside predict.* spans: 250-300 of the first gap, 400-600 and 950-990 of the second
NAMED_SHARE = 100.0 * (50 + 200 + 40) / 700


def test_predict_readers(recorded):
    recorded(_predict_spans())
    assert _read("call_span_ms.infer") == pytest.approx((0.35 + 0.04) / 2)
    assert _read("prepare_ms.infer") == pytest.approx((0.005 + 0.002) / 2)
    assert _read("staging_ms.infer") == pytest.approx((0.005 + 0.003) / 2)
    assert _read("launch_ms.infer") == pytest.approx(0.03)
    assert _read("encoder_ms.infer") == pytest.approx(6.0)
    assert _read("info_sharing_ms.infer") == pytest.approx(2.25)
    assert _read("heads_ms.infer") == pytest.approx(3.25)
    assert _read("refine_ms.infer") == pytest.approx(1.25)
    assert _read("prepost_ms.infer") == pytest.approx(0.5)  # call 1 alone
    assert _read("idle_named_share.infer") == pytest.approx(NAMED_SHARE)


def test_idle_share_from_the_spans_own_events(recorded):
    """Where the profile kept the spans' record_function events, they are
    the intervals (here placed where the alignment would put them)."""
    recorded(_predict_spans())
    kept = [(250.0, 600.0, "predict.call"), (950.0, 990.0, "predict.call"), (260.0, 290.0, "predict.launch")]
    run = types.SimpleNamespace(stretch=_stretch(kept))
    assert bench_run.metric_reader("idle_named_share.infer")(run) == pytest.approx(NAMED_SHARE)


def test_idle_share_needs_one_graph_launch_a_launch_span(recorded):
    spans = _predict_spans()
    recorded([sp for sp in spans if sp.id != 8])  # call 2 without its launch span
    assert _read("idle_named_share.infer") is None
    bad = _predict_spans()
    bad[3] = _host("predict.launch", 3, 0, 0, 270, 280)  # cannot hold its cudaGraphLaunch (265-285)
    recorded(bad)
    assert _read("idle_named_share.infer") is None


def test_train_readers(recorded):
    spans = []
    for call, (fwd, loss, bwd, opt, host_us) in enumerate([(100.0, 2.0, 190.0, 20.0, 300_000),
                                                            (104.0, 2.0, 186.0, 21.0, 310_000),
                                                            (98.0, 2.0, 200.0, 19.0, 320_000)]):
        i = 10 * call
        spans += [_host("train.step", i, None, call, 0, host_us), _host("train.forward", i + 1, i, call, 0, 1),
                  _host("net.encoder", i + 2, i + 1, call, 0, 1), _host("train.loss", i + 3, i, call, 1, 2),
                  _host("train.backward", i + 4, i, call, 2, 3), _host("train.optimizer", i + 5, i, call, 3, 4)]
        for sp, ms in zip(spans[-6:], (None, fwd, None, loss, bwd, opt)):
            sp.device_ms = ms
    recorded(spans)
    assert _read("step_span_ms.train") == pytest.approx(310.0)
    assert _read("forward_ms.train") == pytest.approx(102.0)
    assert _read("backward_ms.train") == pytest.approx(190.0)
    assert _read("optimizer_span_ms.train") == pytest.approx(20.0)


NEW = ["call_span_ms.infer", "prepare_ms.infer", "staging_ms.infer", "launch_ms.infer", "idle_named_share.infer",
       "encoder_ms.infer", "info_sharing_ms.infer", "heads_ms.infer", "refine_ms.infer", "prepost_ms.infer",
       "step_span_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_span_ms.train"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_no_reading(name, recorded, monkeypatch):
    recorded(_predict_spans())
    reader = bench_run.metric_reader(name)
    assert reader(types.SimpleNamespace(stretch=None)) is None  # no trace
    recorded([])
    assert reader(types.SimpleNamespace(stretch=_stretch())) is None  # nothing recorded
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert reader(types.SimpleNamespace(stretch=_stretch())) is None
