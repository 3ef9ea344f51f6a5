"""The readers of the program's stage spans and counters
(``benchmark/stages.py``) on a fabricated snapshot: what each reads, and
None where the snapshot is empty or the program keeps no recorder."""

import json
import os
from types import SimpleNamespace

import pytest

from benchmark import run as R

BATCH = 4
FORWARDS = 6


def span(host_ms, device_ms):
    return {"calls": FORWARDS, "host_ms": host_ms, "host_self_ms": host_ms,
            "device_ms": device_ms}


SNAPSHOT = {
    "forwards": FORWARDS,
    "spans": {
        "memc.forward": span(3000.0, 1200.0),
        "memc.flow": span(60.0, 72.0),
        "memc.project": span(6.0, 2.4),
        "memc.filters": span(2400.0, 480.0),
        "memc.ctx": span(3.0, 12.0),
        "memc.warp": span(12.0, 24.0),
        "memc.blend": span(1.2, 4.8),
        "memc.rectify": span(300.0, 600.0),
    },
    "counters": {
        "flow_px": {"value": 12.5, "total": 100},
        "holes": {"value": 3, "total": 600},
        "cuda_allocs": {"value": 18, "total": FORWARDS},
        "cuda_alloc_retries": {"value": 0, "total": FORWARDS},
    },
}
PER_FRAME = FORWARDS * BATCH
EXPECTED = {
    "flow_span_ms": 72.0 / PER_FRAME,
    "filters_span_ms": 480.0 / PER_FRAME,
    "mc_span_ms": (2.4 + 12.0 + 24.0 + 4.8) / PER_FRAME,
    "rectify_span_ms": 600.0 / PER_FRAME,
    "flow_px": 0.125,
    "holes_pct": 0.5,
}
HOST = {
    "flow_host_ms": 60.0 / FORWARDS,
    "filters_host_ms": 2400.0 / FORWARDS,
    "mc_host_ms": (6.0 + 3.0 + 12.0 + 1.2) / FORWARDS,
    "rectify_host_ms": 300.0 / FORWARDS,
    "cuda_allocs": 18 / FORWARDS,
}
READERS = ([f"{m}.{v}" for m in EXPECTED for v in ("stream", "f32_stream")]
           + [f"{m}.f32_stream" for m in HOST])


def expected(name):
    base, _ = name.split(".")
    return EXPECTED.get(base, HOST.get(base))


@pytest.fixture
def tracing(monkeypatch):
    from memcnet_tpu_torch.utils import tracing as mod

    def fake(snap):
        monkeypatch.setattr(mod, "snapshot", lambda: json.loads(json.dumps(snap)))

    return fake


@pytest.fixture
def reading():
    return SimpleNamespace(batch=BATCH, trace=None, window=None)


def test_every_new_metric_has_a_reader_and_an_entry():
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        names = {m["name"] for m in json.load(f)["per_layer"]}
    assert set(READERS) <= names


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_snapshot(tracing, reading, name):
    tracing(SNAPSHOT)
    assert R.reader(name)(reading) == pytest.approx(expected(name), rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_on_an_empty_snapshot(tracing, reading, name):
    tracing({"forwards": 0, "spans": {}, "counters": {}})
    assert R.reader(name)(reading) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_where_the_program_keeps_no_recorder(reading, name, monkeypatch):
    from memcnet_tpu_torch.utils import tracing as mod

    monkeypatch.delattr(mod, "snapshot")
    assert R.reader(name)(reading) is None


def test_span_readers_give_none_off_the_card(tracing, reading):
    snap = json.loads(json.dumps(SNAPSHOT))
    for s in snap["spans"].values():
        s["device_ms"] = None
    tracing(snap)
    for name in READERS:
        base = name.split(".")[0]
        if base.endswith("_span_ms"):
            assert R.reader(name)(reading) is None, name
        else:
            assert R.reader(name)(reading) is not None, name


def test_mc_span_reads_the_stages_present(tracing, reading):
    """MEMC_Net_s has no ``memc.ctx``: the motion compensation is the other three."""
    snap = json.loads(json.dumps(SNAPSHOT))
    del snap["spans"]["memc.ctx"]
    tracing(snap)
    assert R.reader("mc_span_ms.f32_stream")(reading) == pytest.approx(
        (2.4 + 24.0 + 4.8) / PER_FRAME)
    assert R.reader("mc_host_ms.f32_stream")(reading) == pytest.approx(
        (6.0 + 12.0 + 1.2) / FORWARDS)
