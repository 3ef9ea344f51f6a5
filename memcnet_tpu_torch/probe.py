"""Inputs and a device-operation count shared by chip_smoke.py, the card
tests and bench/kernel_ab.py.

``synthetic_flow`` is the flow every card check of the projection and the
warp is run on, and ``level_flow`` its coarse flow at each SPyNet level;
``level_prologue`` is SPyNet's level input as separate PyTorch ops around
K5, as the port built it before the fused kernel (bench/kernel_ab.py also
runs it in another checkout's package); ``device_ops`` counts what one call
puts on the device.  Nothing here builds or launches a kernel of its own.
"""

import numpy as np
import torch

H, W = 768, 1344  # 1280x720 padded (data/padding.py)


def synthetic_flow(B, device, seed=0):
    """Smooth low-frequency flow (B, 2, H, W) float32 of up to ~20 px, with
    blocks whose landing falls outside the frame, so the gates and the holes
    are exercised."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    flows = []
    for _ in range(B):
        a, b, c = rng.uniform(0, 2 * np.pi, 3)
        fx = 20.0 * np.sin(2 * np.pi * ys / H + a) * np.cos(2 * np.pi * xs / W + b)
        fy = 12.0 * np.cos(2 * np.pi * xs / (0.7 * W) + c)
        fx[100:140, 200:300] = 2000.0
        fy[600:620, 50:90] = -900.0
        flows.append(np.stack([fx, fy]))
    return torch.from_numpy(np.stack(flows).astype(np.float32)).to(device)


def level_flow(B, level, device):
    """The coarse flow (B, 2, h, w) that SPyNet's level ``level`` of the 720p
    pyramid (0 = 768x1344, 5 = 24x42) upsamples: ``synthetic_flow`` at every
    2 ** (level + 1)-th row and column, so its +-20 px and its out-of-frame
    blocks are kept."""
    s = 2 ** (level + 1)
    return synthetic_flow(B, device)[:, :, ::s, ::s].contiguous()


def level_prologue(fst, snd, flow):
    """SPyNet's level input as separate ops: upsample, * 2.0, replicate pad,
    the float32 grid, the grid sample (K5 on CUDA tensors), cat -- about 12
    device operations.  Imports the package first on ``sys.path``, so that
    bench/kernel_ab.py runs the same ops in the checkout it measures."""
    import torch

    from memcnet_tpu_torch.models import spynet
    from memcnet_tpu_torch.nn import layers as L

    up = L.upsample_bilinear(flow, 2) * 2.0
    pad_b = fst.shape[2] - up.shape[2]
    pad_r = fst.shape[3] - up.shape[3]
    if pad_b or pad_r:
        up = L.replication_pad2d(up, (0, pad_r, 0, pad_b))
    return torch.cat([fst, spynet._backward_warp(snd, up), up], dim=1)


def device_ops(fn):
    """(device operations, device ms, {kernel: device ms}) of one call of
    ``fn`` after a warm-up, from torch.profiler: kernels and memsets.

    The profiler keeps the device records whose times, moved onto the host's
    clock, fall inside its session, and has been seen to drop the one kernel
    of a short call (0 operations for a call whose output was checked); so
    the call runs with 5 ms of idle time before and after it inside the
    session, and the largest count of three sessions is kept (a lost record
    only lowers a count)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        got = (sum(e.count for e in evs), sum(e.self_device_time_total for e in evs) / 1e3,
               {e.key: e.self_device_time_total / 1e3 for e in evs})
        if best is None or got[0] > best[0]:
            best = got
    return best
