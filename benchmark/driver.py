"""The one traffic generator: a closed loop of clients over the clip's samples.

A traffic file (``benchmark/traffic/<name>.json``) sets it:

  frame          [height, width] of the video; frames are padded by
                 ``clip.pad_plan`` and the output is cropped back
  clip_frames    frames of the moving clip
  pair_gap       the step between a sample's consecutive inputs: a sample of
                 the call's INPUTS frames reads the clip at offsets 0, g, 2g,
                 ... (INPUTS - 1) g from its first frame (a pair: (i, i + g));
                 the samples are sent in order of their first frame, cycled
  batch          samples a forward
  in_flight      forwards dispatched ahead: the host sends forward k only
                 once the frames of forward k - in_flight are on the host
                 (1: one client that sends its next sample when the last frame
                 has arrived)
  warmup_batches forwards run in set-up, on the same shapes
  sample_frames  frames of the window kept for the check, drawn from the seed
  trace_frames   frames of the traced window of a ``--trace 1`` run

Each forward is the configuration's call (``benchmark/calls``) of the
program's model on the batch's samples, in inference mode; its output frames
are cropped and copied to pinned host memory.  A frame is on the host when the
copy's event has completed.
"""

import contextlib
import random
import time
from dataclasses import dataclass, field

import torch

from benchmark.clip import pad_plan


@dataclass
class Window:
    attempted: int = 0                               # frames sent
    frames: int = 0                                  # frames on the host
    seconds: float = 0.0                             # first send to last frame on the host
    latency_ms: list = field(default_factory=list)   # per frame: sent -> on the host
    forward_ms: list = field(default_factory=list)   # per forward: CUDA events around it
    enqueue_ms: list = field(default_factory=list)   # per forward: host time in the call


def inputs_of(first, inputs, gap):
    """The clip's frames that make the sample starting at ``first``."""
    return [first + j * gap for j in range(inputs)]


class Driver:
    def __init__(self, model, call, frames, traffic, device):
        """``call``: the configuration's module of ``benchmark/calls``;
        ``frames``: the padded clip in the model's type, on ``device``."""
        self.model = model
        self.call = call
        self.traffic = traffic
        self.B = traffic["batch"]
        self.in_flight = traffic["in_flight"]
        self.gap = traffic["pair_gap"]
        self.frames = frames
        self.samples = frames.shape[0] - (call.INPUTS - 1) * self.gap
        if self.samples < 1:
            raise ValueError(f"a clip of {frames.shape[0]} frames holds no sample of "
                             f"{call.INPUTS} inputs {self.gap} apart")
        h, w = traffic["frame"]
        left, _, top, _ = pad_plan(h, w)
        self.crop = (slice(None), slice(None), slice(top, top + h), slice(left, left + w))
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.slots = []
        for _ in range(self.in_flight):
            buf = torch.empty((self.B, 3, h, w), dtype=frames.dtype, pin_memory=cuda)
            events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda
                      else None)
            self.slots.append((buf, events))
        self.cycle = []
        for k in range(self.samples):  # a cycle of batches that covers every sample
            idx = [(k * self.B + j) % self.samples for j in range(self.B)]
            t = torch.tensor([inputs_of(i, call.INPUTS, self.gap) for i in idx],
                             device=self.device)
            self.cycle.append((idx, tuple(t.t().contiguous())))  # an index tensor an input
            if (k + 1) * self.B % self.samples == 0:
                break

    def run(self, *, seconds=None, frames=None, sampler=None, span=None):
        """Send batches until ``seconds`` have passed since the first send, or
        until ``frames`` frames were sent; wait for every frame sent."""
        span = span or (lambda name: contextlib.nullcontext())
        win = Window()
        pending = []
        cuda = self.device.type == "cuda"

        def retire():
            k, idx, t_send, buf, events = pending.pop(0)
            with span("bench.wait"):
                if cuda:
                    events[2].synchronize()
            t_done = time.perf_counter()
            if cuda:
                win.forward_ms.append(events[0].elapsed_time(events[1]))
            win.latency_ms.extend([(t_done - t_send) * 1e3] * len(idx))
            win.frames += len(idx)
            if sampler is not None:
                sampler(idx, buf)
            return t_done

        t0 = time.perf_counter()
        t_last = t0
        k = 0
        with torch.inference_mode():
            while True:
                if len(pending) == self.in_flight:
                    t_last = retire()
                now = time.perf_counter()
                if (seconds is not None and now - t0 >= seconds) or (
                        frames is not None and win.attempted >= frames):
                    break
                idx, inputs = self.cycle[k % len(self.cycle)]
                buf, events = self.slots[k % self.in_flight]
                with span("bench.send"):
                    xs = [self.frames[t] for t in inputs]
                    if cuda:
                        events[0].record()
                    t_enq = time.perf_counter()
                    with span("bench.forward"):
                        out = self.call.rectified(self.model, xs)
                    win.enqueue_ms.append((time.perf_counter() - t_enq) * 1e3)
                    if cuda:
                        events[1].record()
                    with span("bench.copy"):
                        buf.copy_(out[self.crop], non_blocking=cuda)
                        if cuda:
                            events[2].record()
                pending.append((k, idx, now, buf, events))
                win.attempted += len(idx)
                k += 1
            while pending:
                t_last = retire()
        win.seconds = t_last - t0
        return win


class Reservoir:
    """Keeps a uniform sample of ``size`` of the frames it is shown, drawn
    from ``seed``: ``items`` maps a slot to (the sample's first frame, host
    copy of the output frame)."""

    def __init__(self, seed, size):
        self.rng = random.Random(seed)
        self.size = size
        self.seen = 0
        self.items = {}

    def __call__(self, idx, buf):
        for j, first in enumerate(idx):
            n = self.seen
            self.seen += 1
            slot = n if n < self.size else self.rng.randrange(n + 1)
            if slot < self.size:
                self.items[slot] = (first, buf[j].clone())
