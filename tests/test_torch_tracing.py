"""The port's spans (``pemp_tpu_torch/utils/profiling.py::span``) on the
CPU, and ``summarize``'s device idle time from the union of intervals.

- With no profiler recording, ``span`` is one shared null context and an
  eval step records nothing.
- Under ``torch.profiler``, one eval step of a toy PEMP stage 1 and of
  the cascade gives each evaluator and model span once a call (the
  model's once a stage), each inside the call's root span.
- A fused launch on the CPU is ``fused.launch`` with ``fused.wire`` and
  the model's spans inside it.
- A serving artifact exported while a profiler records holds no profiler
  op.
- ``summarize`` on a profile whose device intervals overlap takes their
  union, and puts the idle time inside each span.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from pemp_tpu_torch.core.evaluator import make_fast_eval_step
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade, PEMPStage2
from pemp_tpu_torch.parallel.step import FusedTrainStep
from pemp_tpu_torch.tools import export_serving as X
from pemp_tpu_torch.utils import profiling
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

HW, LAYERS = 33, (1, 1, 1)
CPU = torch.device("cpu")
EVALUATOR = ("evaluator.step", "evaluator.wire", "evaluator.forward",
             "evaluator.labels", "evaluator.metrics", "evaluator.fetch")
MODEL = ("model.backbone", "model.purifier", "model.mpm", "model.upsample")


def stage1():
    torch.manual_seed(0)
    return PEMPStage1(out_channels=64, layers=LAYERS).eval()


def cascade():
    torch.manual_seed(1)
    return PEMPCascade(stage1(), PEMPStage2(out_channels=64,
                                            layers=LAYERS)).eval()


def episodes(b=2, gt_hw=None):
    """A host batch of ``b`` 1-shot episodes; query GT at the input's size,
    or one GT an episode at the sizes ``gt_hw``."""
    rng = np.random.default_rng(0)
    mask = (rng.random((b, 1, HW, HW)) > 0.5).astype(np.float32)
    batch = {"sup_rgb": rng.standard_normal((b, 1, HW, HW, 3), np.float32),
             "sup_mask": np.stack([mask, 1 - mask], axis=-1),
             "qry_rgb": rng.standard_normal((b, 1, HW, HW, 3), np.float32),
             "qry_msk": rng.integers(0, 2, (b, 1, HW, HW)).astype(np.int64),
             "cls": np.arange(1, b + 1)}
    if gt_hw is not None:
        batch["qry_msk"] = [rng.integers(0, 2, (1, h, w)).astype(np.int64)
                            for h, w in gt_hw]
    return batch


def spans_of(prof):
    """[(name, start us, end us)] of the port's spans in a profile."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in profiling.SPANS]


def inside(child, roots):
    return any(s <= child[1] and child[2] <= e for _, s, e in roots)


def test_no_profiler_no_span(monkeypatch):
    assert profiling.span("evaluator.step") is profiling.span("model.mpm")
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    made = []
    real = torch.profiler.record_function

    def spy(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    step = make_fast_eval_step(stage1(), CPU, compact_wire=False)
    step(episodes())
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        step(episodes())
    assert "evaluator.step" in made and "model.mpm" in made


@pytest.mark.parametrize("name,model,per_call", [
    ("stage1", stage1, {**dict.fromkeys(EVALUATOR + MODEL, 1)}),
    ("cascade", cascade, {**dict.fromkeys(EVALUATOR, 1),
                          **dict.fromkeys(MODEL, 2), "cascade.prior": 1}),
])
def test_eval_step_records_each_span_inside_its_root(name, model, per_call):
    step = make_fast_eval_step(model(), CPU, compact_wire=False)
    calls = 2
    batches = [episodes(), episodes(gt_hw=[(35, 37), (31, 33)])]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]) as prof:
        for b in batches:
            step(b)
    found = spans_of(prof)
    names = [n for n, _, _ in found]
    assert {n: names.count(n) for n in set(names)} == {
        k: v * calls for k, v in per_call.items()}
    roots = [s for s in found if s[0] == "evaluator.step"]
    assert all(inside(s, roots) for s in found)
    # the model's spans nest inside the forward, the forward's not in
    # the evaluator's other spans
    forwards = [s for s in found if s[0] == "evaluator.forward"]
    assert all(inside(s, forwards) for s in found
               if s[0].startswith(("model.", "cascade.")))


def test_fused_launch_on_the_cpu_holds_the_wire_and_the_model():
    model = stage1().train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=0.1)

    def step(t, lr):
        out = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"], out_hw=None)
        loss = out.float().square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), None

    fused = FusedTrainStep(step, 2, CPU, opt, compact_wire=False)
    b = episodes(b=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]) as prof:
        for _ in range(2):
            losses, _ = fused([b, b], [0.1, 0.1])
    assert losses.shape == (2,)
    found = spans_of(prof)
    roots = [s for s in found if s[0] == "fused.launch"]
    wires = [s for s in found if s[0] == "fused.wire"]
    assert len(roots) == 2 and len(wires) == 2
    assert all(inside(s, roots) for s in found)
    assert sum(s[0] == "model.backbone" for s in found) == 4


def test_artifact_exported_under_a_profiler_holds_no_profiler_op(tmp_path):
    c = cascade()
    serve, inputs, dyn = X.build_cascade_serving_fn(
        c.stage1, c.stage2, 1, 1, 1, HW, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        exported = X.export_serving(serve, inputs, dyn)
    out = tmp_path / "c.pt2"
    X.save_serving(exported, out, X.artifact_manifest(
        "cascade", "resnet50", 1, 1, 1, HW, "f32", CPU))
    loaded = X.load_serving(out)
    targets = [str(n.target) for n in loaded.graph.nodes
               if n.op == "call_function"]
    assert any("mpm_match" in t for t in targets)
    assert not [t for t in targets if "profiler" in t]
    got = loaded.module()(*inputs)
    want = serve(*inputs)
    torch.testing.assert_close(got, want)


def _ev(name, device, start, end, user=False):
    return SimpleNamespace(name=name, key=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=user, kernels=(),
                           cpu_parent=None, input_shapes=[])


class _StubProfile:
    """Two device kernels that overlap (0-60 and 40-100 us on two
    streams), a span's shadow on the device, and three host spans."""

    def __init__(self):
        cuda, cpu = DeviceType.CUDA, DeviceType.CPU
        self._events = [
            _ev("k_a", cuda, 0.0, 60.0), _ev("k_b", cuda, 40.0, 100.0),
            _ev("evaluator.forward", cuda, 0.0, 100.0, user=True),
            _ev("evaluator.step", cpu, 0.0, 200.0, user=True),
            _ev("evaluator.forward", cpu, 0.0, 150.0, user=True),
            _ev("evaluator.fetch", cpu, 150.0, 200.0, user=True)]

    def events(self):
        return self._events

    def key_averages(self):
        return [SimpleNamespace(key=e.name, device_type=e.device_type,
                                count=1, self_cpu_time_total=0.0,
                                self_device_time_total=(
                                    e.time_range.end - e.time_range.start),
                                is_user_annotation=e.is_user_annotation)
                for e in self._events if e.device_type == DeviceType.CUDA]


def test_summarize_takes_the_union_of_overlapping_device_intervals():
    s = profiling.summarize(_StubProfile(), 1, 200e-6)
    assert s["timeline"] == "cuda"
    # busy 100 us of 200 (the kernels' sum, 120 us, would say 40 % idle)
    assert s["busy_ms_per_step"] == pytest.approx(0.1)
    assert s["device_ms_per_step"] == pytest.approx(0.1)
    assert s["dispatch_gap_ms_per_step"] == pytest.approx(0.1)
    assert s["device_idle_share"] == pytest.approx(0.5)
    assert s["idle_ms_per_step_by_span"] == pytest.approx({
        "evaluator.step": 0.1, "evaluator.forward": 0.05,
        "evaluator.fetch": 0.05})
    # the span's shadow on the device is no kernel
    assert {r["kernel"] for r in s["top"]} == {"k_a", "k_b"}
