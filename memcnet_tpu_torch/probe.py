"""Inputs and a device-operation count shared by chip_smoke.py, the card
tests and bench/kernel_ab.py.

``texture`` and ``moving_frames`` make synthetic scenes, and
``write_yuv``, ``write_middlebury`` and ``write_vimeo`` lay them out as the
inputs of the three demos (a YUV420 stream, a Middlebury "other" folder, a
Vimeo-90K test folder), the PNGs with libpng's adaptive row filters, as
real files have them.

``synthetic_flow`` is the flow every card check of the projection and the
warp is run on, and ``level_flow`` its coarse flow at each SPyNet level;
``level_prologue`` is SPyNet's level input as separate PyTorch ops around
K5, as the port built it before the fused kernel (bench/kernel_ab.py also
runs it in another checkout's package); ``device_ops`` counts and times
what one call puts on the device, and ``graph_ops`` counts it where no
record may be lost.  Nothing here builds or launches a kernel of its own.
"""

import os

import numpy as np
import torch

H, W = 768, 1344  # 1280x720 padded (data/padding.py)


def texture(rng, h, w):
    """A (3, h, w) float32 scene in [0, 1]: four plane waves per channel."""
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    img = np.zeros((3, h, w), np.float32)
    for c in range(3):
        for _ in range(4):
            kx, ky, ph = rng.uniform(0.005, 0.05), rng.uniform(0.005, 0.05), rng.uniform(0, 6.3)
            img[c] += np.sin(kx * xs + ky * ys + ph)
    return (img - img.min()) / (img.max() - img.min())


def moving_frames(seed, n, h, w):
    """``n`` uint8 (h, w, 3) frames of one textured scene, each moved 1-6 px
    across and 0-4 px down from the one before, so that frames two apart
    (an interpolated pair) are 2-12 px apart."""
    rng = np.random.RandomState(seed)
    img = texture(rng, h + 4 * n, w + 6 * n)
    frames, y, x = [], 0, 0
    for _ in range(n):
        frames.append(np.round(255.0 * img[:, y:y + h, x:x + w].transpose(1, 2, 0))
                      .astype(np.uint8))
        y, x = y + rng.randint(0, 5), x + rng.randint(1, 7)
    return frames


def levels_apart(got, want):
    """(largest difference in levels, share of values that differ) of two
    uint8 arrays of one shape."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {got.shape} against {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float(np.mean(diff > 0))


def write_yuv(path, frames):
    """``frames`` as a YUV420 stream (data/yuv.py)."""
    from memcnet_tpu_torch.data import YUVWrite

    writer = YUVWrite(path)
    try:
        for f in frames:
            writer.write(f)
    finally:
        writer.close()
    return path


def write_middlebury(root, names, h, w, seed=0):
    """A Middlebury "other" layout: <root>/data/<name>/frame10.png and
    frame11.png, <root>/gt/<name>/frame10i11.png, from three moving frames
    per sequence (the middle one the ground truth).  Returns (data, gt)."""
    from memcnet_tpu_torch.io.png import imwrite

    data, gt = os.path.join(root, "data"), os.path.join(root, "gt")
    for i, name in enumerate(names):
        f10, f10i11, f11 = moving_frames(seed + i, 3, h, w)
        for d, fname, img in ((data, "frame10.png", f10), (data, "frame11.png", f11),
                              (gt, "frame10i11.png", f10i11)):
            os.makedirs(os.path.join(d, name), exist_ok=True)
            imwrite(os.path.join(d, name, fname), img, adaptive=True)
    return data, gt


def write_vimeo(root, n, h, w, seed=0, task_dir="sequences_sigma20_byMTLB"):
    """A Vimeo-90K test layout of ``n`` septuplets: <root>/<task_dir>/00001/
    <seq>/im1..7.png, and the center frame as <root>/target/00001/<seq>/
    im4.png.  Returns root."""
    from memcnet_tpu_torch.io.png import imwrite

    for s in range(n):
        seq = os.path.join("00001", f"{s + 1:04d}")
        frames = moving_frames(seed + s, 7, h, w)
        for d, names in ((task_dir, range(7)), ("target", (3,))):
            os.makedirs(os.path.join(root, d, seq), exist_ok=True)
            for i in names:
                imwrite(os.path.join(root, d, seq, f"im{i + 1}.png"), frames[i],
                        adaptive=True)
    return root


def synthetic_flow(B, device, seed=0, size=None):
    """Smooth low-frequency flow (B, 2, h, w) float32 of up to ~20 px, with
    blocks whose landing falls outside the frame, so the gates and the holes
    are exercised.  ``size`` (h, w) defaults to (H, W); at another size the
    blocks keep their place relative to the frame."""
    h, w = size or (H, W)
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    flows = []
    for _ in range(B):
        a, b, c = rng.uniform(0, 2 * np.pi, 3)
        fx = 20.0 * np.sin(2 * np.pi * ys / h + a) * np.cos(2 * np.pi * xs / w + b)
        fy = 12.0 * np.cos(2 * np.pi * xs / (0.7 * w) + c)
        fx[100 * h // H:140 * h // H, 200 * w // W:300 * w // W] = 2000.0
        fy[600 * h // H:620 * h // H, 50 * w // W:90 * w // W] = -900.0
        flows.append(np.stack([fx, fy]))
    return torch.from_numpy(np.stack(flows).astype(np.float32)).to(device)


def tile_flows(device):
    """The (2, 2, H, W) float32 flows the tile entries are held and timed
    on, within a halo budget of 64: "smooth" (+-6 px), "pm20" (+-20 px with
    noise and a band of columns landing left of the frame) and "invalid"
    (every pixel landing below the frame: fy = 3 H; where H is tiled the
    vertical clamp brings most of them back)."""
    ys = torch.arange(H, device=device, dtype=torch.float32).view(H, 1)
    xs = torch.arange(W, device=device, dtype=torch.float32).view(1, W)
    gen = torch.Generator(device=device).manual_seed(8)
    out = {}
    for name, amp in (("smooth", 6.0), ("pm20", 20.0)):
        f = torch.stack([amp * torch.sin(2 * np.pi * ys / H) * torch.cos(2 * np.pi * xs / W),
                         0.6 * amp * torch.cos(2 * np.pi * xs / W).expand(H, W)])
        f = f.expand(2, 2, H, W).clone()
        if name == "pm20":
            f += 0.5 * torch.randn(f.shape, generator=gen, device=device)
            f[:, 0, :, :24] = -40.0
        out[name] = f
    inv = torch.zeros((2, 2, H, W), device=device)
    inv[:, 1] = 3.0 * H
    out["invalid"] = inv
    return out


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
    of a short call (0 operations for a call whose output was checked), more
    often the later in a run; so the call runs with 25 ms of idle time
    before and after it inside the session, and the largest count of three
    sessions is kept (a lost record only lowers a count)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.025)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.025)
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        got = (sum(e.count for e in evs), sum(e.self_device_time_total for e in evs) / 1e3,
               {e.key: e.self_device_time_total / 1e3 for e in evs})
        if best is None or got[0] > best[0]:
            best = got
    return best


# CUgraphNodeType (cuda.h): kernel, memcpy, memset
_GRAPH_DEVICE_NODES = (0, 1, 2)


def graph_ops(fn):
    """The device operations (kernels, copies, memsets) of one call of
    ``fn`` after a warm-up, counted as the nodes of a CUDA graph that
    captures the call: the capture records every operation the call puts on
    its stream, where the profiler may drop the records of a short call
    (``device_ops``).  Raises where the call cannot be captured (it waits on
    the host)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"graph_ops: {what} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    count = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        count += kind.value in _GRAPH_DEVICE_NODES
    del graph
    torch.cuda.synchronize()
    return count
