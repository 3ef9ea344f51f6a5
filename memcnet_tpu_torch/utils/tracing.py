"""Tracing / profiling utilities (port of memcnet_tpu/utils/tracing.py).

The reference's only observability is wall-clock AverageMeters around the
forward (demo_Vimeo_VE.py:97-98,137-144).  This module keeps those
measurement points and adds a ``torch.profiler`` trace (Chrome trace format,
viewable in Perfetto or chrome://tracing) and a frames/s/card reporter.
"""

import contextlib
import os
import time

import torch

from memcnet_tpu_torch.metrics.meter import AverageMeter


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


@contextlib.contextmanager
def device_trace(log_dir=None):
    """A torch.profiler run over the block (CPU activity, and CUDA
    activity where a CUDA device is present) that writes a Chrome trace,
    ``trace.json``, into ``log_dir``; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def frames_per_second(n_frames, seconds, n_chips=None):
    """frames/s and frames/s per card; ``n_chips`` defaults to the number of
    CUDA devices (1 where there is none)."""
    if n_chips is None:
        n_chips = torch.cuda.device_count() or 1
    fps = n_frames / seconds if seconds > 0 else float("inf")
    return {"frames_per_s": fps, "frames_per_s_per_chip": fps / max(n_chips, 1),
            "n_chips": n_chips}
