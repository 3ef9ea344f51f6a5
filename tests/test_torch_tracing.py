"""The stage spans and counters of ``memcnet_tpu_torch/utils/tracing.py`` on
the CPU: off, a forward dispatches exactly what it dispatches with no spans;
on, under ``torch.profiler``, every ``memc.*`` range nests under its
``memc.forward`` and carries the forward's number; the counters equal hand
counts; ``device_trace`` writes ``stages.json`` beside ``trace.json``.  The
card's cases (events, K3's hole count) are in tests/test_torch_cuda.py."""

import contextlib
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from memcnet_tpu_torch.models import get_model
from memcnet_tpu_torch.ops import flow_project
from memcnet_tpu_torch.utils import tracing

H, W = 64, 128
STAGES = {
    "MEMC_Net_s": {"flow", "project", "filters", "warp", "blend", "rectify"},
    "MEMC_Net_star": {"flow", "project", "filters", "ctx", "warp", "blend", "rectify"},
}


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return {name: get_model(name).eval() for name in STAGES}


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(1)
    return torch.rand(1, 3, H, W, generator=g), torch.rand(1, 3, H, W, generator=g)


@pytest.fixture(autouse=True)
def clean_recorder():
    tracing.reset()
    yield
    tracing.reset()


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def dispatched(model, x0, x2):
    with torch.inference_mode(), OpLog() as log:
        model(x0, x2)
    return log.ops


def test_the_profiler_sets_the_flag_the_spans_read():
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("name", sorted(STAGES))
def test_off_a_forward_dispatches_what_it_does_without_spans(models, frames, name,
                                                             monkeypatch):
    assert tracing.span("forward") is tracing.span("flow")  # one shared no-op
    assert tracing.counter("holes", frames[0], 1) is None
    traced = dispatched(models[name], *frames)
    with monkeypatch.context() as m:
        m.setattr(tracing, "span", lambda *a, **k: contextlib.nullcontext())
        plain = dispatched(models[name], *frames)
    assert traced == plain and len(plain) > 100
    assert tracing.snapshot() == {"forwards": 0, "spans": {}, "counters": {}}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_on_every_range_nests_under_its_forward(models, frames, name):
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU],
                                         record_shapes=True) as prof:
        for _ in range(2):
            models[name](*frames)
    ranges = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    forwards = [e for e in ranges if e.name == "memc.forward"]
    assert [e.kwinputs for e in forwards] == [{"forward": 1}, {"forward": 2}]
    seen = set()
    for e in ranges:
        if e.name == "memc.forward":
            continue
        # on the profiler's clock inside its memc.forward, with its number
        parent = e.cpu_parent
        assert parent is not None and parent.name == "memc.forward", e.name
        assert parent.time_range.start <= e.time_range.start
        assert e.time_range.end <= parent.time_range.end
        assert e.kwinputs == parent.kwinputs
        seen.add(e.name)
    assert seen == {tracing.PREFIX + s for s in STAGES[name]}
    snap = tracing.snapshot()
    assert snap["forwards"] == 2
    spans = snap["spans"]
    assert set(spans) == seen | {"memc.forward"}
    for s in spans.values():
        assert s["calls"] == 2 and s["device_ms"] is None  # nothing timed off the card
        assert 0.0 < s["host_self_ms"] <= s["host_ms"]
    # every stage is a direct child of the forward: a leaf's self time is all
    # of it, the forward's what its children leave
    children = sum(s["host_ms"] for n, s in spans.items() if n != "memc.forward")
    fwd = spans["memc.forward"]
    assert fwd["host_self_ms"] == pytest.approx(fwd["host_ms"] - children, rel=1e-6, abs=1e-6)
    for n, s in spans.items():
        if n != "memc.forward":
            assert s["host_self_ms"] == pytest.approx(s["host_ms"], rel=1e-12)
    assert set(snap["counters"]) == {"flow_px", "holes"}  # no allocator off the card


def test_counters_equal_hand_counts_on_a_known_flow(models, frames):
    """Direction 0 moves every pixel by (3, 4): |flow| 5, and its landings
    leave the first 3 columns and 4 rows empty.  Direction 1 moves by
    (-1.5, 0): |flow| 1.5, landing on columns 0 .. W - 2 (base cell
    trunc(x - 1.5), its right neighbour one further), so column W - 1 stays
    empty."""
    model = models["MEMC_Net_s"]
    flow = torch.zeros(2, 2, H, W)
    flow[0, 0], flow[0, 1], flow[1, 0] = 3.0, 4.0, -1.5
    x0, x2 = frames
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        flow_project(flow, fillhole=True)  # alone, outside any span: not counted
        model._flow = lambda a, b: flow  # the flow net's output, as constructed
        try:
            off0, off1 = model._flows(x0, x2, fillhole=True)
        finally:
            del model._flow
    c = tracing.snapshot()["counters"]
    assert c["flow_px"]["total"] == 2 * H * W
    assert c["flow_px"]["value"] == pytest.approx(H * W * (5.0 + 1.5), rel=1e-9)
    holes = (H * W - (H - 4) * (W - 3)) + H
    assert c["holes"] == {"value": holes, "total": 2 * H * W}
    assert off0.shape == off1.shape == (1, 2, H, W)


def test_device_trace_writes_stages_beside_the_trace(models, frames, tmp_path):
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        models["MEMC_Net_s"](*frames)  # forgotten: device_trace resets the recorder
    with torch.inference_mode(), tracing.device_trace(str(tmp_path)):
        models["MEMC_Net_s"](*frames)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # operator ranges: the profiler copies user annotations onto the device
    cats = {e.get("cat") for e in events if str(e.get("name", "")).startswith(tracing.PREFIX)}
    assert cats and "user_annotation" not in cats
    stages = json.loads((tmp_path / "stages.json").read_text())
    assert stages["forwards"] == 1
    assert set(stages["spans"]) == {"memc.forward"} | {
        tracing.PREFIX + s for s in STAGES["MEMC_Net_s"]}
    assert stages["counters"]["flow_px"]["total"] == 2 * H * W
    assert stages["counters"]["holes"]["total"] == 2 * H * W
