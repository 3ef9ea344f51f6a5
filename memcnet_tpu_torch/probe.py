"""Inputs and a device-operation count shared by chip_smoke.py, the card
tests and bench/kernel_ab.py.

``synthetic_flow`` is the flow every card check of the projection and the
warp is run on; ``device_ops`` counts what one call puts on the device.
Nothing here builds or launches a kernel of its own.
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


def device_ops(fn):
    """(device operations, device ms, {kernel: device ms}) of one call of
    ``fn`` after a warm-up, from torch.profiler: kernels and memsets."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return (sum(e.count for e in evs), sum(e.self_device_time_total for e in evs) / 1e3,
            {e.key: e.self_device_time_total / 1e3 for e in evs})
