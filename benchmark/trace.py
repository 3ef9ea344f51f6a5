"""The traced window and what the per-layer readers take from it.

``capture`` runs a block under ``torch.profiler`` (CPU and CUDA activity)
inside a host range ``bench.window``.  ``Trace`` reduces the profile to:

  window     (start, end) of ``bench.window`` on the trace's clock, seconds
  ops        the device operations (kernels, copies, memsets): (name, start,
             end, host time of their launch or None)
  ranges     the benchmark's host ranges ``bench.*``: (name, start, end)

The device's busy time is the union of the operations' intervals inside the
window, not their sum, so operations that overlap count once.  An
operation belongs to a host range when the runtime call that launched it
(matched by its correlation id) lies inside the range.
"""

import torch

WINDOW = "bench.window"


def _is_device(e):
    return e.device_type == torch.autograd.DeviceType.CUDA


def capture(fn):
    """(the profile, fn's result) of ``fn()`` run under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return prof, out


def busy_intervals(intervals, lo, hi):
    """The union of the intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_seconds(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    return sum(e - s for s, e in busy_intervals(intervals, lo, hi))


class Trace:
    def __init__(self, prof):
        events = list(prof.events())
        cpu = [e for e in events if not _is_device(e)]
        win = [e for e in cpu if e.name == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench.window range")
        self.window = (win[0].time_range.start / 1e6, win[0].time_range.end / 1e6)
        self.ranges = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                       for e in cpu if e.name.startswith("bench.") and e.name != WINDOW]
        launches = {}
        for e in cpu:  # runtime calls by correlation id
            if e.name.startswith(("cuda", "cu")):
                launches[e.id] = e.time_range.start / 1e6
        self.ops = []
        for e in events:
            if _is_device(e) and not e.name.startswith("bench."):
                at = launches.get(e.id)
                if at is None:
                    at = launches.get(getattr(e, "linked_correlation_id", None))
                self.ops.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6, at))

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return union_seconds([(s, e) for _, s, e, _ in self.ops], *self.window)

    def seconds_of(self, match):
        """Device seconds of the operations whose name ``match`` accepts."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e, _ in self.ops
                   if match(n) and min(e, hi) > max(s, lo))

    def seconds_under(self, range_name):
        """Device seconds of the operations launched inside a host range of
        that name; None where no operation could be tied to its launch."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == range_name)
        if not spans or all(at is None for *_, at in self.ops):
            return None
        total = 0.0
        for _, s, e, at in self.ops:
            if at is not None and any(a <= at <= b for a, b in spans):
                total += e - s
        return total

    def top_ops(self, n=10):
        by = {}
        for name, s, e, _ in self.ops:
            key = name[:160]
            by[key] = by.get(key, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]

    def idle_gaps(self, n=10):
        """The longest idle stretches of the device in the window, each named
        by the innermost benchmark range the host was in when it began."""
        lo, hi = self.window
        busy = busy_intervals([(s, e) for _, s, e, _ in self.ops], lo, hi)
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        out = []
        for s, e in gaps:
            inside = [(rs, name) for name, rs, re_ in self.ranges if rs <= s < re_]
            out.append([max(inside)[1] if inside else "host:outside any range", e - s])
        return sorted(out, key=lambda r: -r[1])[:n]
