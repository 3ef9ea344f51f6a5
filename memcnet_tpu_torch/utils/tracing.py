"""Tracing and profiling of the port (port of memcnet_tpu/utils/tracing.py).

The reference's only observability is wall-clock AverageMeters around the
forward (demo_Vimeo_VE.py:97-98,137-144).  This module keeps those
measurement points (``StageTimers``), runs a ``torch.profiler`` trace over a
block (``device_trace``: Chrome trace format, viewable in Perfetto or
chrome://tracing) and records the stages of the interpolation models.

Stages.  ``MEMCNet.forward`` (``models/memc_net.py``; MEMC_Net, MEMC_Net_s
and MEMC_Net_star) opens a span at each subnet boundary:

  memc.forward   one model call, the root of the others
  memc.flow      FlowNetS with its x10 scale and x4 upsample, or SPyNet with its /2
  memc.project   flow_project: K2 and K3
  memc.filters   the filter and occlusion nets (MonoNet5) with their input concat
  memc.ctx       MEMC_Net_star's contexts
  memc.warp      both K1 calls
  memc.blend     the blend
  memc.rectify   RectifyNet or EDSR with its input concat

and the program keeps four counters, each a value over a total:

  flow_px             the sum of each pixel's |flow| = sqrt(u^2 + v^2) over the
                      flows that enter flow_project (both directions) / their
                      pixels (K2 sums them on the card)
  holes               the pixels K3 fills, count 0 after K2's scatter / the
                      pixels projected with the fill (K3 counts them on the card)

(flow_project's plain version counts both on the CPU; its tile entries
count neither)
  cuda_allocs         the caching allocator's cudaMalloc and cudaFree calls
                      (``num_device_alloc + num_device_free``) inside each
                      memc.forward on the card / the forwards
  cuda_alloc_retries  its ``num_alloc_retries`` there / the forwards

When they are on.  Spans and counters record only while a ``torch.profiler``
profile records, which is what ``torch.autograd.profiler._is_profiler_enabled``
says: under ``device_trace`` (the demos' ``--trace-dir``) or any other
profile.  Otherwise ``span`` returns one shared no-op object and ``counter``
None: no profiler range, no CUDA call, no tensor operation, no allocation.
When on, a span is a profiler range of the name above with the forward's
number as its argument ``forward`` (in a trace's args where the profile
records shapes), so that a trace shows the device operations and idle gaps
under the stage the host was in.  The range is of the operator kind, not a
user annotation as ``torch.profiler.record_function`` opens: the profiler
copies each user annotation onto the device's timeline as a device event of
its own, which a reader of a trace's device events would count as device
work.  The recorder keeps a span's name, forward number, parent span, host
start and end (``time.perf_counter``) and, on the card, a pair of timing
events on the stream that was current when its forward began.  Counters
count inside spans only, so an op called alone under a profile counts
nothing.  Nothing waits for the card on the way: event pairs are read once
complete (at the end of a later forward, while the card still works on
it), the rest by ``snapshot``, and counters add up on the device until
``snapshot`` reads them.

``snapshot()`` gives, per span name, its calls, host ms, host self ms (less
what its child spans cover) and device ms (the stream time between its
events: its operations and any idle the host left inside it; None off the
card); the counters; and the count of memc.forward spans.  ``reset()``
clears the recorder.  ``device_trace`` resets it on entry and writes the
snapshot as ``stages.json`` beside ``trace.json``.
"""

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from memcnet_tpu_torch.metrics.meter import AverageMeter

PREFIX = "memc."
# a profiler range of the operator kind (module docstring): name, inputs, kwargs
_profiler_range = torch._C._profiler._RecordFunctionFast


class StageTimers:
    """proc/total timer pair matching the reference protocol: `proc` spans
    the model call, `total` spans the whole per-item loop body."""

    def __init__(self):
        self.proc = AverageMeter()
        self.total = AverageMeter()

    @contextlib.contextmanager
    def item(self):
        start = time.time()
        yield self
        self.total.update(time.time() - start)

    @contextlib.contextmanager
    def model(self):
        start = time.time()
        yield
        self.proc.update(time.time() - start)

    def summary(self):
        return (
            f"proc {self.proc.avg * 1e3:.1f} ms/item, "
            f"total {self.total.avg * 1e3:.1f} ms/item over {self.total.count} items"
        )


def _allocator_calls(device):
    """(cudaMalloc + cudaFree calls, alloc retries) of the caching allocator
    on ``device`` so far; a KeyError where the allocator keeps no such
    count, rather than a count of 0."""
    s = torch.cuda.memory_stats_as_nested_dict(device)
    return s["num_device_alloc"] + s["num_device_free"], s["num_alloc_retries"]


_OFF = contextlib.nullcontext()  # what ``span`` returns while nothing records


class _Span:
    __slots__ = ("rec", "name", "device", "stream", "seq", "stack", "parent", "range", "t0",
                 "t1", "child_s", "events", "device_ms", "allocs")

    def __init__(self, rec, name, device):
        self.rec, self.name, self.device = rec, name, device
        self.child_s = 0.0
        self.stream = self.events = self.device_ms = self.allocs = None

    def __enter__(self):
        rec = self.rec
        stack = self.stack = rec.stack()
        parent = self.parent = stack[-1] if stack else None
        if parent is None:
            self.seq = next(rec.seq)
            if self.device is not None and self.device.type == "cuda":
                self.stream = torch.cuda.current_stream(self.device)
        else:
            self.seq, self.device, self.stream = parent.seq, parent.device, parent.stream
        self.range = _profiler_range(PREFIX + self.name, (), {"forward": self.seq})
        self.range.__enter__()
        if self.stream is not None and parent is None:
            self.allocs = _allocator_calls(self.device)
        self.t0 = time.perf_counter()
        if self.stream is not None:
            self.events = rec.event_pair(self.device)
            self.events[0].record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.t1 = time.perf_counter()
        if self.allocs is not None:
            calls, retries = _allocator_calls(self.device)
            self.rec.add("cuda_allocs", calls - self.allocs[0], 1)
            self.rec.add("cuda_alloc_retries", retries - self.allocs[1], 1)
        self.range.__exit__(*exc)
        self.stack.pop()
        self.range = self.stack = None
        if self.parent is not None:
            self.parent.child_s += self.t1 - self.t0
        self.rec.finish(self)
        if self.parent is None:
            # the card is still busy with this forward: read what has completed
            self.rec.resolve(wait=False)
        return False


class Recorder:
    """The spans and counters of the traced stretch, in memory."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._free = {}  # device -> timing event pairs read and free again
        self.reset()

    def reset(self):
        with self._lock:
            self.seq = itertools.count(1)
            self.done = []      # finished spans, in the order they ended
            self.pending = []   # finished spans whose events are not read yet
            self.counts = {}    # name -> [host value, total, {device: tensor}]
        self._local.stack = []

    def stack(self):
        """This thread's open spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def event_pair(self, device):
        """Two timing events for a span on ``device``, reused once read."""
        with self._lock:
            free = self._free.setdefault(device, [])
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def finish(self, sp):
        with self._lock:
            self.done.append(sp)
            if sp.events is not None:
                self.pending.append(sp)

    def resolve(self, wait):
        """Read the device ms of finished spans whose end event has completed,
        in the order they were recorded; with ``wait``, of all of them."""
        with self._lock:
            k = 0
            for sp in self.pending:
                end = sp.events[1]
                if wait:
                    end.synchronize()
                elif not end.query():
                    break
                sp.device_ms = sp.events[0].elapsed_time(end)
                self._free.setdefault(sp.device, []).append(sp.events)
                sp.events = None
                k += 1
            del self.pending[:k]

    def add(self, name, value, total):
        """Add a host-side ``value`` and ``total`` to counter ``name``."""
        with self._lock:
            c = self.counts.setdefault(name, [0, 0, {}])
            c[0] += value
            c[1] += total

    def counter(self, name, device, total, dtype):
        """Counter ``name``'s running sum on ``device``, a 0-dim tensor of
        ``dtype`` for the caller (or a kernel, by its pointer) to add into;
        ``total`` joins the counter's total."""
        with self._lock:
            c = self.counts.setdefault(name, [0, 0, {}])
            c[1] += total
            acc = c[2].get(device)
            if acc is None:
                # copied from pinned memory, not filled: no kernel launched
                # for the first time inside a traced forward
                zero = torch.zeros((), dtype=dtype, pin_memory=device.type == "cuda")
                acc = c[2][device] = zero.to(device, non_blocking=True)
            return acc

    def snapshot(self):
        self.resolve(wait=True)
        with self._lock:
            spans = {}
            for sp in self.done:
                d = spans.setdefault(PREFIX + sp.name, {"calls": 0, "host_ms": 0.0,
                                                        "host_self_ms": 0.0, "device_ms": None})
                d["calls"] += 1
                d["host_ms"] += 1e3 * (sp.t1 - sp.t0)
                d["host_self_ms"] += 1e3 * (sp.t1 - sp.t0 - sp.child_s)
                if sp.device_ms is not None:
                    d["device_ms"] = (d["device_ms"] or 0.0) + sp.device_ms
            counters = {name: {"value": value + sum(t.item() for t in sums.values()),
                               "total": total}
                        for name, (value, total, sums) in self.counts.items()}
        forwards = spans.get(PREFIX + "forward", {}).get("calls", 0)
        return {"forwards": forwards, "spans": spans, "counters": counters}


RECORDER = Recorder()


def span(name, on=None):
    """A stage span ``memc.<name>`` while a profile records, else the shared
    no-op.  ``on``, for a root span: a tensor on the device whose current
    stream it and its child spans time (a root without one times nothing on
    a device); a child span times its root's stream."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name, None if on is None else on.device)


def counter(name, on, total, dtype=torch.float64):
    """Inside a span, while a profile records: counter ``name``'s running
    sum on the device of tensor ``on`` (a 0-dim tensor of ``dtype`` to add
    the counted value into), with ``total`` added to what it is counted
    over.  Else None: an op called alone counts nothing, even under a
    profile."""
    if not _profiler._is_profiler_enabled or not RECORDER.stack():
        return None
    return RECORDER.counter(name, on.device, total, dtype)


def snapshot():
    """The recorder's spans and counters so far (module docstring)."""
    return RECORDER.snapshot()


def reset():
    """Forget every span and counter."""
    RECORDER.reset()


@contextlib.contextmanager
def device_trace(log_dir=None):
    """A torch.profiler run over the block (CPU activity, and CUDA
    activity where a CUDA device is present) that writes a Chrome trace,
    ``trace.json``, and the stages' ``snapshot``, ``stages.json``, into
    ``log_dir``; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
    with open(os.path.join(str(log_dir), "stages.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)
