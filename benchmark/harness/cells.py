"""The two kinds of traffic the benchmark drives, each one general loop read
from a traffic file:

- ``closed_loop_predict``: one caller, back to back, hands numpy uint8 pairs
  to ``predict_correspondences_batched`` and waits for each answer on the
  card; the pairs come in turn from a pool made from the seed.
- ``train_steps``: the system's train step (``make_train_step`` over
  ``make_optimizer``'s defaults) on batches taken in turn from a pool made
  from the seed, dispatched ahead, the loss read every ``log_every`` steps.

Each builds the system once in set-up, warms every shape the window uses,
measures for ``--seconds``, optionally traces a short steady stretch, then
frees the system and holds what the timed path produced to the reference.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, inputs
from benchmark.harness.trace import profile_stretch
from benchmark.harness.yardstick import percentile, window_taps
from benchmark.reference import load as load_reference
from benchmark.reference import train as ref_train

__all__ = ["Run", "DRIVERS"]


class Run:
    """One run of one cell: its inputs, and what the loops and the check
    recorded. The metric readers (``benchmark/metrics/*.py``) read it.
    ``ref`` is the configuration's reference module, ``arch`` its sizes."""

    def __init__(self, cell: str, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
                 limits: Dict[str, float], process_start: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.ref = load_reference(config)
        self.arch = self.ref.Arch(config["model"])
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, torch.device(device)
        self.limits = limits
        self.process_start = process_start  # time.time() at the process's start
        self.setup_s = math.nan
        self.window_s = math.nan
        self.attempted = 0
        self.failed = 0
        self.pairs = 0
        self.latency_ms: List[float] = []
        self.host_ms: List[float] = []
        self.optimizer_ms: List[float] = []
        self.window_peak_bytes = 0
        self.memory_peak_bytes = 0
        self.stretch = None  # the traced stretch's Trace
        self.stretch_batches: List[int] = []  # pool index of each traced call / step
        self.window_taps: Dict[int, float] = {}  # pool index -> in-image window taps of its pairs
        self.values: Dict[str, float] = {}  # the numbers compared
        self.reference_s = math.nan
        self.readings: Dict[str, object] = {}  # what the check read besides the numbers compared
        self.phases: Dict[str, float] = {}  # seconds from the process's start to each step of set-up

    def mark(self, phase: str) -> None:
        self.phases[phase] = time.time() - self.process_start

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        """Mark the window's start: set-up ends here."""
        self.sync()
        gc.collect()
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.time() - self.process_start
        return time.perf_counter()

    def end_window(self) -> None:
        if self.device.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            self.memory_peak_bytes = max(self.memory_peak_bytes, self.window_peak_bytes)

    def free(self) -> None:
        """Free what the system held; switch TF32 off for the reference,
        which is float32 throughout (:meth:`restore_tf32` switches back)."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self._tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def restore_tf32(self) -> None:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._tf32


def _model(run: Run):
    from ufm_torch import models

    run.mark("import")
    cls = getattr(models, run.config["model_class"])
    model = cls(**run.config["model"], device=run.device)
    params = inputs.make_params(run.arch, run.seed, run.device, run.config["weights"])
    model.net.load_state_dict(params, strict=True)
    del params
    return model


def _fields(res) -> Dict[str, torch.Tensor]:
    out = {"flow": res.flow.flow_output}
    if res.flow.flow_covariance is not None:
        out["flow_covariance"] = res.flow.flow_covariance
    if res.covisibility is not None:
        out["covisibility"] = res.covisibility.mask
    if res.keypoint_confidence is not None:
        out["keypoint_confidence"] = res.keypoint_confidence
    return out


def _as_batch(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(a).to(device)
    return t[None] if t.dim() == 3 else t


def predict_cell(run: Run) -> None:
    tr = run.traffic
    model = _model(run)  # captures its predict programs (the default)
    run.mark("model")
    pool = inputs.predict_pool(run.seed, tr, run.device)
    run.mark("pool")

    def call(i: int):
        src, tgt = pool[i % len(pool)]
        return model.predict_correspondences_batched(source_image=src, target_image=tgt)

    call(0)  # the first call captures the program
    run.sync()
    run.mark("capture")
    for i in range(1, len(pool)):  # every batch once
        call(i)
    run.sync()
    # the calls compared: a uniform sample of the whole window's, drawn from
    # the seed as the calls come; a traced run compares one call of every
    # pool batch (the window roofline counts their taps)
    rng = random.Random(f"{run.seed}/sample")
    strata = len(pool) if run.trace else 1
    sample = [check.Reservoir(1 if run.trace else tr["sample_calls"], rng) for _ in range(strata)]
    flags = []
    traced = res = None
    t_start = run.start_window()
    i = 0
    while time.perf_counter() - t_start < run.seconds:
        t0 = time.perf_counter()
        try:
            res = call(i)
            t1 = time.perf_counter()
            run.sync()
        except Exception as exc:  # a call that raises is a failed call; the loop goes on
            run.failed += 1
            run.attempted += 1
            print(f"call {i} raised: {exc!r}", flush=True)
            i += 1
            continue
        t2 = time.perf_counter()
        run.latency_ms.append((t2 - t0) * 1e3)
        run.host_ms.append((t1 - t0) * 1e3)
        fields = _fields(res)
        flags.append(torch.stack([torch.isfinite(t).all() for t in fields.values()]).all())
        sample[i % strata].offer(lambda: (i % len(pool), fields))
        i += 1
    run.window_s = time.perf_counter() - t_start
    run.end_window()
    finite = torch.stack(flags).cpu().tolist() if flags else []
    run.attempted += len(finite)
    run.failed += sum(not f for f in finite)
    run.pairs = sum(finite) * run.batch
    if run.latency_ms:
        run.readings["latency_ms_p50_p95_max"] = [statistics.median(run.latency_ms), percentile(run.latency_ms, 95),
                                                  max(run.latency_ms)]
        run.readings["host_ms_p50_max"] = [statistics.median(run.host_ms), max(run.host_ms)]

    if run.trace:
        first = i

        def traced(j: int) -> None:
            call(first + j)
            run.sync()

        run.stretch = profile_stretch(traced, tr["stretch_calls"], run.device)
        run.stretch_batches = [(first + j) % len(pool) for j in range(tr["stretch_calls"])]
        run.end_window()
    del model, call, traced, res
    run.free()

    t0 = time.perf_counter()
    params = {k: v.float() for k, v in inputs.make_params(run.arch, run.seed, run.device, run.config["weights"]).items()}
    worst: Dict[str, float] = {}
    kept = [item for r in sample for item in r.items]
    with torch.no_grad():
        for p, got in kept:
            src, tgt = pool[p]
            raw: Dict[str, torch.Tensor] = {}
            src, tgt = _as_batch(src, run.device), _as_batch(tgt, run.device)
            want = run.ref.predict(params, run.arch, src, tgt, raw=raw)
            control = run.ref.predict(params, run.arch, src, tgt, run.ref.CONTROL)
            for k, v in check.predict_gaps(got, want, control).items():
                worst[k] = max(worst.get(k, 0.0), v)
            run.readings.setdefault("flow_rms_px", []).append(float(want["flow"].double().pow(2).mean().sqrt()))
            if run.trace and "regression_flow" in raw:
                run.window_taps[p] = window_taps(raw["regression_flow"], run.arch.patch)
            del raw, want, control
    run.readings["calls_compared_of"] = [len(kept), sum(r.seen for r in sample)]
    if not kept or (run.trace and any(not r.items for r in sample)):  # no answer to compare is no answer
        worst = {k: math.inf for k in check.predict_numbers()}
    run.values = worst
    run.reference_s = time.perf_counter() - t0
    run.restore_tf32()


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def train_cell(run: Run) -> None:
    from ufm_torch.training import make_optimizer, make_train_step

    tr = run.traffic
    model = _model(run)
    net = model.net
    optimizer = make_optimizer(net)
    step = make_train_step(net, optimizer)
    run.mark("model")
    pool = inputs.train_pool(run.seed, tr, run.device)
    run.mark("pool")
    if len(pool) < 3:
        raise ValueError("a training cell needs at least three distinct batches: the checked steps differ")
    names = {id(p): n for n, p in net.named_parameters()}
    owned = {names[id(p)]: (p if m is None else m) for _, _, pairs in optimizer.groups for p, m in pairs}

    # the checked steps, through the window's own call and feed
    losses = [step(pool[0])["total_loss"]]
    run.sync()
    run.mark("first_step")
    beta1 = optimizer.adamw.param_groups[0]["betas"][0]
    # AdamW's first moment after one step is (1 - beta1) times the gradient it received (none: a zero gradient)
    got_grad = _leaf_norms({k: optimizer.adamw.state.get(t, {}).get("exp_avg", torch.zeros_like(t)) / (1 - beta1)
                            for k, t in owned.items()})
    losses += [step(pool[1])["total_loss"], step(pool[2])["total_loss"]]
    got_losses = [float(v) for v in losses]
    with torch.no_grad():  # the change after three steps, kept on the host until the reference has its own
        start = inputs.make_params(run.arch, run.seed, run.device, run.config["weights"])
        got_delta = {k: (t.float() - start[k].float()).cpu() for k, t in owned.items()}
        del start
    n_done = 3
    for _ in range(tr["warm_steps"]):
        step(pool[n_done % len(pool)])
        n_done += 1

    if run.trace:  # the optimizer's device time, by CUDA events around its step
        inner = optimizer.step
        marks = []

        def timed_step() -> None:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            inner()
            b.record()
            marks.append((a, b))

        optimizer.step = timed_step

    reads = []
    metrics = traced = None
    t_start = run.start_window()
    steps = 0
    while time.perf_counter() - t_start < run.seconds:
        t0 = time.perf_counter()
        metrics = step(pool[(n_done + steps) % len(pool)])
        run.host_ms.append((time.perf_counter() - t0) * 1e3)
        steps += 1
        if steps % tr["log_every"] == 0:
            reads.append((steps, float(metrics["total_loss"])))
    run.sync()
    run.window_s = time.perf_counter() - t_start
    run.end_window()
    run.attempted = steps
    bad, last = 0, 0
    for at, loss in reads:
        if not math.isfinite(loss):
            bad += at - last
        last = at
    run.failed = bad
    run.pairs = (steps - bad) * run.batch
    if run.trace:
        run.optimizer_ms = [a.elapsed_time(b) for a, b in marks]
        first = n_done + steps

        def traced(j: int) -> None:
            step(pool[(first + j) % len(pool)])

        run.stretch = profile_stretch(traced, tr["stretch_steps"], run.device)
        run.end_window()
    del model, net, optimizer, step, pool, owned, metrics, traced
    run.free()

    t0 = time.perf_counter()
    trainer = ref_train.Trainer(inputs.make_params(run.arch, run.seed, run.device, run.config["weights"]), run.arch)
    start = {k: v.detach().clone() for k, v in trainer.params.items()}
    batches = inputs.train_pool(run.seed, tr, run.device)[:3]
    want_losses = [trainer.step(batches[0])]
    first_grad = {k: g.clone() for k, g in trainer.last_grads.items()}
    want_grad = _leaf_norms(first_grad)
    want_losses += [trainer.step(batches[1]), trainer.step(batches[2])]
    with torch.no_grad():
        got_change, want_change, left_out = check.change_norms(
            got_delta, {k: trainer.params[k] - start[k] for k in start}, first_grad)
    run.values = check.train_gaps(got_losses, want_losses, got_grad, want_grad, got_change, want_change)
    run.reference_s = time.perf_counter() - t0
    run.restore_tf32()

    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    run.readings.update(
        losses=got_losses, reference_losses=want_losses,
        worst_gradient=worst(check.norm_gaps(got_grad, want_grad)),
        worst_change=worst(check.norm_gaps(got_change, want_change)),
        elements_left_out_of_change=left_out, parameters_left_out_of_change=sorted(set(want_grad) - set(want_change)),
        _leaves={"gradient": {k: [got_grad.get(k), v] for k, v in want_grad.items()},
                 "change": {k: [got_change.get(k), v] for k, v in want_change.items()}})


DRIVERS = {"closed_loop_predict": predict_cell, "train_steps": train_cell}
