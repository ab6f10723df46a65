"""The readers of the program's spans (``benchmark/spans.py``,
``metrics/{forward,backbone,evaluator,launch}_idle_ms.py``) on hand-built
timelines: known gaps, nested and repeated spans, kernels that overlap,
a span that the sub-window clips, and a program that records no span."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import manifest, spans
from benchmark import timeline as tracing
from benchmark.timeline import Timeline

EVAL_READERS = ("forward_idle_ms.serve", "backbone_idle_ms.serve",
                "evaluator_idle_ms.serve", "forward_idle_ms.eval",
                "backbone_idle_ms.eval", "evaluator_idle_ms.eval")


def _ctx(tl, **mix):
    return SimpleNamespace(trace={"timeline": tl, "steps": 1},
                           mix={"fuse_steps": 1, **mix})


def _eval_call(t0):
    """One eval call's spans from ``t0`` (10 s long) and its kernels:
    idle 1.5 s in the forward (0.5 of it in the backbone), 3 s in the
    evaluator's own spans."""
    host = [("evaluator.step", 0, 10), ("evaluator.wire", 0, 1),
            ("evaluator.forward", 1, 6), ("model.backbone", 1, 4),
            ("aten::conv2d", 1.2, 1.4), ("evaluator.labels", 6, 7),
            ("evaluator.metrics", 7, 8), ("evaluator.fetch", 8, 10)]
    # two kernels on two streams overlap in (2.5, 3)
    device = [("k", 0.5, 2), ("k", 2.5, 5), ("k2", 2.5, 3), ("k", 7.5, 9)]
    return ([(n, t0 + s, t0 + e) for n, s, e in host],
            [(n, t0 + s, t0 + e) for n, s, e in device])


def _eval_timeline(calls=2):
    tl = Timeline(0.0, 10.0 * calls)
    for i in range(calls):
        host, device = _eval_call(10.0 * i)
        tl.host += host
        tl.device += device
    return tl


@pytest.mark.parametrize("cell", ["serve", "eval"])
def test_eval_readers_put_the_idle_time_in_each_span(cell):
    ctx = _ctx(_eval_timeline())
    read = {k: manifest.reader(f"{k}.{cell}")(ctx) for k in (
        "forward_idle_ms", "backbone_idle_ms", "evaluator_idle_ms")}
    # per call: forward (1, 6) less (1, 2) and (2.5, 5); backbone (1, 4)
    # less (1, 2) and (2.5, 4); wire 0.5, labels 1, metrics 0.5, fetch 1
    assert read == pytest.approx({"forward_idle_ms": 1500.0,
                                  "backbone_idle_ms": 500.0,
                                  "evaluator_idle_ms": 3000.0})


def test_idle_counts_nested_and_repeated_spans_once():
    tl = Timeline(0.0, 10.0, device=[("k", 2.0, 3.0)],
                  host=[("model.backbone", 1.0, 5.0),
                        ("model.backbone", 2.0, 4.0),     # nested
                        ("model.backbone", 6.0, 7.0)])
    # (1, 5) and (6, 7): 5 s of host time, 1 s of it busy
    assert spans.idle_in(tl, ["model.backbone"]) == pytest.approx(4.0)
    assert spans.count(tl, "model.backbone") == 3
    # a parent and its child among the names: (0.5, 5.5) and (6, 7) once
    tl.host.append(("evaluator.forward", 0.5, 5.5))
    assert spans.idle_in(tl, ["evaluator.forward", "model.backbone"]) \
        == pytest.approx(6.0 - 1.0)


def test_launch_reader_is_per_step():
    k = 8
    host, device = [], []
    for t0 in (0.0, 10.0):
        host += [("fused.launch", t0, t0 + 10), ("fused.wire", t0, t0 + 2),
                 ("fused.slots", t0 + 2, t0 + 3),
                 ("fused.replay", t0 + 3, t0 + 4),
                 ("cudaGraphLaunch", t0 + 3.1, t0 + 3.9),
                 ("fused.outputs", t0 + 9, t0 + 10)]
        device += [("Memcpy DtoD", t0 + 2.5, t0 + 3),
                   ("conv", t0 + 3.5, t0 + 9.5)]
    tl = Timeline(0.0, 20.0, device=device, host=host)
    # a launch: wire 2, slots 0.5, replay 0.5, outputs 0.5 -> 3.5 s
    got = manifest.reader("launch_idle_ms.train")(_ctx(tl, fuse_steps=k))
    assert got == pytest.approx(2 * 3.5e3 / (2 * k))


class _Prof:
    """Writes a Chrome trace as ``torch.profiler.profile`` would."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_a_span_that_the_sub_window_clips():
    # the window (us) opens at 1000 inside a call's root span and its
    # forward; only the parts inside the window count
    ev = [_x(tracing.WINDOW_SPAN, "user_annotation", 1000, 9000),
          _x("evaluator.step", "user_annotation", 0, 6000),
          _x("evaluator.forward", "user_annotation", 500, 4500),
          _x("evaluator.forward", "gpu_user_annotation", 600, 4000),
          _x("evaluator.step", "user_annotation", 6000, 4000),
          _x("evaluator.forward", "user_annotation", 6500, 3000),
          _x("kernel_a", "kernel", 2000, 1000),
          _x("kernel_b", "kernel", 7000, 1000)]
    tl = tracing.timeline(_Prof(ev))
    assert spans.count(tl, "evaluator.step") == 2
    # forward inside the window: (1000, 5000) and (6500, 9500), 7000 us,
    # 2000 us of it busy; the device's shadow of a span is no kernel
    assert spans.idle_in(tl, ["evaluator.forward"]) == pytest.approx(5e-3)
    assert manifest.reader("forward_idle_ms.serve")(_ctx(tl)) == \
        pytest.approx(5e-3 * 1e3 / 2)


@pytest.mark.parametrize("name", EVAL_READERS + ("launch_idle_ms.train",))
def test_no_reading_without_the_programs_spans(name):
    # the benchmark's own spans and aten ops, as a program without spans
    # leaves the trace
    tl = Timeline(0.0, 1.0, device=[("k", 0.1, 0.5)],
                  host=[("bench.eval_step", 0.0, 0.9),
                        ("bench.launch", 0.0, 0.9),
                        ("aten::conv2d", 0.1, 0.2)])
    ctx = _ctx(tl, fuse_steps=8)
    assert manifest.reader(name)(ctx) is None
    ctx.trace = None
    assert manifest.reader(name)(ctx) is None
    assert spans.idle_in(tl, ["evaluator.forward"]) is None


def test_the_spans_read_are_the_programs():
    from pemp_tpu_torch.utils.profiling import SPANS
    from benchmark.metrics import evaluator_idle_ms, launch_idle_ms
    read = {spans.EVAL_ROOT, spans.LAUNCH_ROOT, "evaluator.forward",
            "model.backbone", *evaluator_idle_ms.NAMES,
            *launch_idle_ms.NAMES}
    assert read <= set(SPANS)
