"""Whether the frames the timed window produced are correct.

The run keeps a sample of the window's frames, drawn from its seed, as they
reached the host.  Once the window has closed and the program's state is
freed, the configuration's plain float32 reference (``benchmark/reference``,
TF32 off) computes each sampled frame again, one sample at a time, from the
same padded input frames and the same seeded weights, and each frame is
compared with the reference's:

  rms_rel   RMS of (frame - reference) over the RMS of the reference frame
  p50_rel   the median of |frame - reference| over the same RMS
  p99_rel   the 99th percentile of |frame - reference| over the same RMS
  max_rel   the largest |frame - reference| over the same RMS

Each number is the worst over the sampled frames, and each is held against
its limit in the configuration's ``compare``; a NaN or an infinity fails.
The control is the same reference with every conv's operands rounded to the
precision one step below the configuration's (``reference.layers.Operands``);
its readings are what a limit has to reject.
"""

import importlib
import math

import torch

from benchmark import weights as W
from benchmark.reference.layers import Operands, Params

NUMBERS = ("rms_rel", "p50_rel", "p99_rel", "max_rel")


def readings(got, ref):
    """{number: value} of one frame against its reference, both float32."""
    d = got.float() - ref
    a = d.abs().flatten()
    scale = ref.pow(2).mean().sqrt()
    vals = {"rms_rel": d.pow(2).mean().sqrt() / scale,
            "p50_rel": a.kthvalue(max(1, int(0.5 * a.numel()))).values / scale,
            "p99_rel": a.kthvalue(max(1, int(0.99 * a.numel()))).values / scale,
            "max_rel": a.max() / scale}
    return {k: float(v) if math.isfinite(float(v)) else math.inf for k, v in vals.items()}


def worst(per_frame):
    return {k: max(r[k] for r in per_frame) for k in NUMBERS} if per_frame else {}


class Reference:
    """The configuration's reference, its weights made again from the seed."""

    def __init__(self, config, template, seed, device):
        self.forward = importlib.import_module(
            f"benchmark.reference.{config['reference']}").forward
        self.tensors = W.make(template, config["init"], seed, device)

    def frames(self, frames, crop, operands="float32"):
        """The reference's output frame of each sample, cropped: ``frames``
        are the sample's inputs, each (B, 3, H, W) float32."""
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                out = self.forward(Params(self.tensors, Operands(operands)), *frames)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        return out[crop]


def judge(limits, worst_readings, complete):
    """(correct, lines): each number beside its limit."""
    lines, ok = [], complete
    for name in NUMBERS:
        value, limit = worst_readings.get(name), limits.get(name)
        if limit is None:
            continue
        good = value is not None and value <= limit
        ok = ok and good
        lines.append((name, value, limit, good))
    if not lines:
        ok = False
    return ok, lines
