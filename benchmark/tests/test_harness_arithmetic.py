"""The benchmark's arithmetic on fixed inputs: the percentile and the rates,
the sample of calls compared, the flow's share of the control's error, the
busy-time union and the idle gaps of a trace, the roofline sums, and the
bound functions pinned to ``chip_smoke.py``'s figures at the flagship
shapes."""

from __future__ import annotations

import importlib.util
import math
import os
import types

import pytest
import torch

from bench_tiny import ROOT

from benchmark import run as bench_run
from benchmark.harness import check
from benchmark.harness import yardstick as ys
from benchmark.harness.trace import Trace


def test_percentile_over_all_values():
    values = [float(v) for v in range(1, 101)]  # 1..100
    assert ys.percentile(values, 95) == pytest.approx(95.05)
    assert ys.percentile(values, 50) == pytest.approx(50.5)
    assert ys.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        ys.percentile([], 95)


def test_sample_is_uniform_over_the_whole_window():
    """Each of 1000 calls stays in a sample of 8 with probability 8 / 1000:
    over many seeds every tenth of the window is drawn about as often."""
    import random

    tenths = [0] * 10
    for seed in range(400):
        r = check.Reservoir(8, random.Random(seed))
        for i in range(1000):
            r.offer(lambda: i)
        assert len(r.items) == 8 and r.seen == 1000 and len(set(r.items)) == 8
        for i in r.items:
            tenths[i // 100] += 1
    assert all(250 < n < 390 for n in tenths), tenths  # 320 each on average
    short = check.Reservoir(8, random.Random(0))
    for i in range(3):
        short.offer(lambda: i)
    assert short.items == [0, 1, 2]


def test_flow_is_compared_as_a_share_of_the_controls_error():
    want = torch.zeros(2, 2, 10, 100, dtype=torch.float64)
    control = want.clone()
    control[:, 0] = 0.5  # the control is 0.5 px off everywhere
    got = want.clone()
    got[0, 0] = 0.05  # the first pair 0.05 px off everywhere, the second exact but for 2 of its 1000 pixels
    got[1, 1, 0, :2] = 0.4
    gaps = check.predict_gaps({"flow": got}, {"flow": want}, {"flow": control})
    assert gaps["flow"] == pytest.approx(0.1) and gaps["flow_px"] == pytest.approx(0.05)
    assert gaps["flow_tail"] == pytest.approx(0.8) and gaps["flow_tail_px"] == pytest.approx(0.4)
    assert set(gaps) == set(check.predict_numbers()) - {"covariance", "covisibility", "confidence"}
    bad = got.clone()
    bad[0, 0, 0, 0] = math.nan
    assert check.predict_gaps({"flow": bad}, {"flow": want}, {"flow": control})["flow"] == math.inf


def _run(**kw):
    run = types.SimpleNamespace(latency_ms=[], host_ms=[], optimizer_ms=[], pairs=0, window_s=1.0, setup_s=1.0,
                                window_peak_bytes=0, stretch=None, stretch_batches=[], window_taps={}, batch=1,
                                arch=None)
    run.__dict__.update(kw)
    return run


def _reader(name):
    return bench_run.metric_reader(name)


def test_end_to_end_readers():
    run = _run(latency_ms=[float(v) for v in range(1, 101)], pairs=300, window_s=12.0, window_peak_bytes=3 * 2**30)
    assert _reader("latency_p95_ms")(run) == pytest.approx(95.05)
    assert _reader("pairs_per_s")(run) == pytest.approx(25.0)
    assert _reader("train_pairs_per_s")(run) == pytest.approx(25.0)
    assert _reader("train_peak_gib")(run) == pytest.approx(3.0)
    assert _reader("setup_s")(run) == 1.0


def _trace():
    # kernels (us): attention 0-10 and 20-30, mlp 25-40 (overlaps), window 60-70; host spans around them
    dev = [(0.0, 10.0, "void flash_attention_fwd_kernel<64>(Params)"), (20.0, 30.0, "flash_attention_fwd_kernel"),
           (25.0, 40.0, "linear_gelu_bf16_fwd_kernel"), (60.0, 70.0, "window_refinement_fwd_kernel<16, 5>"),
           (75.0, 76.0, "flash_attention_fwd_any_kernel")]
    host = [(0.0, 100.0, "bench.call"), (12.0, 18.0, "cudaGraphLaunch"), (40.0, 59.0, "aten::copy_")]
    return Trace(dev, host, window_s=100e-6, units=2)


def test_busy_union_counts_overlap_once():
    tr = _trace()
    assert tr.busy_s() == pytest.approx((10 + 20 + 10 + 1) * 1e-6)
    assert _reader("idle_share.infer")(_run(stretch=tr)) == pytest.approx(100 * (1 - 41 / 100))


def test_kernel_time_by_name():
    tr = _trace()
    seconds, count = tr.kernel_s("flash_attention_fwd_kernel")
    assert count == 2 and seconds == pytest.approx(20e-6)  # not the _any kernel
    assert tr.kernel_s(r"window_refinement_fwd\w*_kernel") == (pytest.approx(10e-6), 1)
    assert tr.kernel_s("no_such_kernel") == (0.0, 0)


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(map(tuple, _trace().idle_gaps()))
    assert gaps["bench.call > cudaGraphLaunch"] == pytest.approx(10e-6)  # 10-20
    assert gaps["bench.call > aten::copy_"] == pytest.approx(20e-6)  # 40-60
    assert gaps["bench.call"] == pytest.approx(5e-6)  # 70-75


def test_roofline_sums_the_bounds_over_the_kernel_time():
    arch = types.SimpleNamespace(enc=dict(depth=1, patch_size=14, cls=True, embed_dim=1024, num_heads=16, mlp_ratio=4.0),
                                 info=dict(depth=1, dim=768, num_heads=12, mlp_ratio=4.0), model_hw=(420, 560),
                                 encoder_tokens=lambda hp, wp: hp * wp + 1)
    tr = _trace()
    run = _run(stretch=tr, stretch_batches=[0, 1], arch=arch)
    per = ys.attention_bound_ms(2, 1201, 16, 64)[0] + ys.attention_bound_ms(1, 2400, 12, 64)[0]
    assert _reader("attn_fwd_roofline.infer")(run) == pytest.approx(100 * 2 * per / 1e3 / 20e-6)
    quiet = _run(stretch=Trace([(0.0, 1.0, "other_kernel")], [], 1e-6, 1), stretch_batches=[0], arch=arch)
    assert _reader("attn_fwd_roofline.infer")(quiet) is None  # nothing to read: no number, never 0
    assert _reader("mlp_fwd_roofline.infer")(quiet) is None


def test_window_roofline_counts_the_taps():
    arch = types.SimpleNamespace(model_hw=(8, 8), patch=5, cls_head={"output_dim": 16})
    flow = torch.zeros(1, 8, 8, 2)
    taps = ys.window_taps(flow, 5)
    # an 8 x 8 image: each pixel's 8-wide tap rows clipped to the image
    per_axis = sum(min(x + 4, 7) - max(x - 3, 0) + 1 for x in range(8))
    assert taps == per_axis * per_axis
    run = _run(stretch=_trace(), stretch_batches=[0], window_taps={0: taps}, arch=arch)
    want = ys.window_bound_ms((1, 8, 8, 16), 5, taps)[0]
    assert _reader("window_fwd_roofline.infer")(run) == pytest.approx(100 * want / 1e3 / 10e-6)
    far = torch.full((1, 8, 8, 2), 1e6)
    assert ys.window_taps(far, 5) == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,args", [
    ("attention_bound_ms", (2, 1201, 16, 64)), ("attention_bound_ms", (1, 2400, 12, 64)),
    ("attention_bwd_bound_ms", (4, 1201, 16, 64)), ("attention_bwd_bound_ms", (2, 2400, 12, 64)),
    ("linear_gelu_bound_ms", (2402, 1024, 4096)), ("linear_gelu_bound_ms", (2400, 768, 3072)),
    ("linear_gelu_bwd_bound_ms", (4804, 1024, 4096)), ("linear_gelu_bwd_bound_ms", (4800, 768, 3072)),
    ("window_bound_ms", ((1, 420, 560, 16), 5, 1.5e7)), ("window_bound_ms", ((4, 420, 560, 16), 5, 6e7)),
])
def test_bounds_are_chip_smokes(name, args):
    assert getattr(ys, name)(*args) == getattr(_chip_smoke(), name)(*args)


def test_peaks_are_chip_smokes():
    cs = _chip_smoke()
    assert (ys.PEAK_BF16_FLOPS, ys.PEAK_FP32_FLOPS, ys.PEAK_BYTES) == (cs.PEAK_BF16_FLOPS, cs.PEAK_FP32_FLOPS,
                                                                        cs.PEAK_BYTES)


def test_model_flops_at_the_flagship():
    import json

    from benchmark.reference.ufm import Arch

    with open(os.path.join(ROOT, "benchmark", "configs", "ufm_base.json")) as f:
        arch = Arch(json.load(f)["model"])
    fwd = ys.model_flops_per_pair(arch, train=False)
    assert 2.5e12 < fwd < 3.2e12
    assert 2.5 < ys.model_flops_per_pair(arch, train=True) / fwd < 3.5
    assert not math.isnan(fwd)
