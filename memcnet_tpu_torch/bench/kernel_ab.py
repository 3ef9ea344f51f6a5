"""Kernels K1 (warp), K4 (small conv) and K5 (SPyNet's level input) and the
flow projection (K2 and K3) timed on one card at the 720p paths' shapes,
against another checkout of the repo and against K1's design steps.

    python memcnet_tpu_torch/bench/kernel_ab.py [--other DIR] [--out FILE]
                                                [--rows GROUP,...]

Measures this tree's K1 -- MEMC_Net_star's split warp of (frame, context),
67 channels, and the 3-channel frame warp, on the smooth +-20 px flow that
chip_smoke.py checks (``memcnet_tpu_torch/probe.py``), bf16 and float32 --
and K4 -- the ctx conv (3 -> 64) and SPyNet's five 7x7 convs at each of its
six pyramid levels, B = 2, bf16 and float32, each beside ``F.conv2d`` (TF32
off) and its bounds (float32: 3 TF32 passes at 495 TFLOP/s and the CUDA
cores' 67), the bf16 rows' output bits digested and held equal between the
two trees -- and ``flow_project`` with the fill at B = 2 (both directions of
the smooth flow), bf16 and float32, with its device operations and device ms
per call from torch.profiler and, in this tree, its K2 and K3 stages -- and
K5 at SPyNet's top level (B = 2): the level input as separate ops around the
standalone K5, and fused where the tree has it, with device operations; the
standalone K5; SPyNet's forward with its device operations; each the
median device time of repeated launches after a 256 MB L2 flush, and each
checked against the tree's own plain version (the projection against the
tree's CPU path).  The tile entries of partitioned frames (``--rows tile``)
at 768x1344, B = 2, halo 64, on (data 1, tile 4) and (1, 2, 2): K5's level
input on tiles at the top level (merged fst and up bit for bit against the
untiled kernel), K2's tile entry on the +-20 px flow (counts exact against
its plain version), K3's tile entry and the whole tiled fill from avg,
cnt (bit for bit against the carry entry's plain version), the tiled
flow_project with the fill, K2's payload entry on tile origins (P = 3 and
4, the payload built inside the scatter) and N7 and N8 on partitioned
frames, each with its device operations; the projection rows add K2's
payload entry untiled and N7 and N8 whole.  K1's tile entry (``--rows
K1tile``) on the tiles of star's split warp (67 channels, B = 1) at
768x1344, halo 64, on both grids, with phase 8's +-20 px flow
(``probe.tile_flows``); K3 (``--rows fill``) with and without the down
search on the +-20 px flow's average and masks, B = 2, bit for bit against
its plain version, and ``flow_project`` with the down scan whole; these
rows also count device operations as the nodes of a CUDA graph of the call
(``probe.graph_ops``).  K4 at the spec walkers' 3x3 convs (``--rows
K4walk``, float32, B = 1 and 4): every conv of MonoNet5 thin at its 720p
level, a filter branch's and RectifyNet2's, each beside ``F.conv2d`` (TF32
off), its bounds and the float32 body's geometry; and each walk whole
(``models/mononet.py``: the thin trunk, the two filter branches, the
RectifyNet) as the measured tree runs it, with its float32 K4 launches.
``--rows`` picks groups of rows: projection, K1, K5, K4, K4walk, tile,
K1tile, fill (all by default).  The other tree must have the fused payload
entries and K3's tile entry from avg, cnt.

With ``--other DIR`` (a checkout of another commit, e.g. the parent unpacked
with ``git archive``), the same measurements run on that tree's kernels too,
in separate processes in the order other, this, this, other, so that both
meet the same card; the table keeps the mean of each tree's two runs.  The
other tree builds its own kernels into its own ``_build`` directory.

The design steps of K4's float32 body (``conv_f32_steps.cu``: the old
direct kernel, the 3xTF32 GEMM at its first geometry, with N = 8 for small
O, with the wave fitting, with MT = 4, as built with the taps in N for
O * K <= 16 -- which must give the entry's bits, as must the variants: the
halo split once a chunk in shared memory, raw weights split in registers,
the widest instances at one block an SM -- and one TF32 pass), timed at every float32 K4 row, of K1 (``warp_steps.cu``:
tiled and vector-load gathers,
and the floor of 16 loads per channel that all hit the pixel itself) and of
K5's level input (``level_steps.cu``: taps at the pixel, no sample, the copy
floor, four coarse-flow loads a pixel, 8 pixels a thread), of K5's tile
entry (``level_tile_steps.cu``: pixels a thread, register caps, the first
design; each must give the entry's bits) and of K2's tile
entry (``tile_sums_steps.cu``: its memset, scatter and fold apart, each
beside the first design's, and the scatter as one 4-wide vector atomic into
an interleaved buffer; the fold as built must equal the first design's bit
for bit on the same sums), and of K3's tile entry and K2's payload entry on
tile origins (``fill_tiles_steps.cu``: the mask pass and the fill as built,
with summaries, and with every carry given; the memset, the scatter that
builds the payload, the first design's scatter of a built payload, the
fold), and of K1's tile entry (``warp_tile_steps.cu``: the first design,
block shapes, box elements a thread, register caps, channels a stage, bf16
packed as fetched; each must give the entry's bits; and two diagnostics,
staging without sums and sums without fetches) are timed in this tree's
process, and ``mma_probe.cu`` shows how the tensor
cores add: 1 + 2^-k and 1 - 1 + 2^-k in one MMA, for which k the small term
survives.  Results go to ``--out`` as JSON (default
``chiprun_out/kernel_ab/results.json``) and a table to standard output.
"""

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _load_probe():
    """This tree's ``memcnet_tpu_torch/probe.py`` (the flow chip_smoke.py
    checks, the device-operation count), loaded by its path: the measuring
    process imports the package of the tree it measures, which may be
    another checkout's."""
    spec = importlib.util.spec_from_file_location(
        "memcnet_probe", os.path.join(ROOT, "memcnet_tpu_torch", "probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _load_probe()
H, W = PROBE.H, PROBE.W  # 1280x720 padded (data/padding.py)
LEVELS = 6
BASIC = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]  # models/spynet.py
WARP_STEPS = ["128x1 gather (earlier tile)", "32x4 gather", "128x1 vector rows",
              "32x4 vector rows", "floor: every tap at the pixel", "one gather per filter row"]
# K5 level input's design steps (level_steps.cu): (step, pixels a thread, label)
LEVEL_STEPS = [(0, 4, "as built, 4 px a thread"), (1, 4, "taps at the pixel"),
               (2, 4, "no sample (snd not read)"), (3, 4, "copy floor (fst only)"),
               (4, 4, "four coarse-flow loads a pixel"), (0, 8, "as built, 8 px a thread"),
               (4, 8, "four coarse-flow loads a pixel, 8 px a thread")]


def noisy_flow(torch, dev):
    """The smooth flow plus +-30 px white noise: the patches of a block
    spread too far for K1's shared-memory box."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flow = PROBE.synthetic_flow(1, dev)
    return (flow + 30.0 * torch.randn(flow.shape, generator=gen, device=dev)).contiguous()


def timed_ms(torch, fn, flush, reps=10):
    import numpy as np

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_ulps(torch, got, ref, slack):
    """Largest |got - ref| - slack in bf16 units of each ref value (float32:
    plain max abs error)."""
    if ref.dtype == torch.float32:
        return float((got - ref).abs().max())
    r = ref.float().abs()
    e = torch.floor(torch.log2(torch.where(r > 0, r, torch.ones_like(r))))
    ulp = torch.where(r > 0, torch.exp2(e - 7), torch.full_like(r, 2.0 ** -133))
    return float((((got.float() - ref.float()).abs() - slack).clamp(min=0.0) / ulp).max())


ROW_GROUPS = ("projection", "K1", "K5", "K4", "K4walk", "tile", "K1tile", "fill")
# the spec walkers' 3x3 convs (models/mononet.py) at 720p: (part, C, O, level,
# ReLU fused): MonoNet5 thin in walk order, a filter branch's first conv, RectifyNet2's
WALKER_CONVS = [("trunk", 6, 16, 0, True), ("trunk", 16, 32, 0, True),
                ("trunk", 32, 64, 1, True), ("trunk", 64, 128, 2, True),
                ("trunk", 128, 256, 3, True), ("trunk", 256, 512, 4, True),
                ("trunk", 512, 512, 5, True), ("trunk", 512, 256, 4, True),
                ("trunk", 256, 128, 3, True), ("trunk", 128, 64, 2, True),
                ("trunk", 64, 32, 1, True), ("trunk", 32, 16, 0, True),
                ("branch", 16, 16, 0, True), ("rectify", 41, 64, 0, True),
                ("rectify", 64, 64, 0, True), ("rectify", 64, 3, 0, False)]
WALKER_BATCHES = (1, 4)
TILE_HALO = 64
TILE_GRIDS = (("tile4", None), ("tile2x2", "tile_h"))  # (data 1, tile 4), (1, 2, 2)
# in the order timed, twice over (the best of the two passes is kept)
LEVEL_TILE_STEPS = [(5, "first design (1 px a thread, 1D grid)"), (0, "4 px a thread where it fits"),
                    (1, "2 px a thread"), (2, "1 px a thread (as built)"),
                    (3, "4 px, at most 85 registers"), (4, "4 px, at most 64 registers")]
TILE_SUMS_STEPS = [(0, "memset of S"), (1, "scatter as built"),
                   (2, "scatter, first design (1D grid, 64-bit divisions)"),
                   (3, "fold as built (warp strips)"),
                   (4, "fold, first design (one thread an element)"),
                   (5, "memset of S interleaved (4 floats a cell)"),
                   (6, "scatter, one float4 atomic a pixel"), (7, "fold of interleaved S")]


def measure(root, steps, groups=ROW_GROUPS):
    """This process's measurements of the kernels of the tree at ``root``."""
    sys.path.insert(0, root)
    import torch

    from memcnet_tpu_torch.ops.cuda import _lib

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    step_lib = build(_lib, "warp_steps") if steps and "K1" in groups else None
    level_lib = build(_lib, "level_steps") if steps and "K5" in groups else None
    tile_libs = ((build(_lib, "level_tile_steps"), build(_lib, "tile_sums_steps"),
                  build(_lib, "fill_tiles_steps"))
                 if steps and "tile" in groups else (None, None, None))
    warp_tile_lib = build(_lib, "warp_tile_steps") if steps and "K1tile" in groups else None
    conv_lib = build(_lib, "conv_f32_steps") if steps and "K4" in groups else None
    if steps and "K4" in groups:
        res["mma probe"] = mma_probe(torch, build(_lib, "mma_probe"))
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        if "projection" in groups:
            projection_rows(torch, res, name, dt, flush, steps)
            payload_rows(torch, res, name, dt, flush)
        if "K1" in groups:
            warp_rows(torch, res, name, dt, gen, flush, step_lib)
        if "K5" in groups:
            level_input_rows(torch, res, name, dt, gen, flush, level_lib)
        if "K4" in groups:
            conv_rows(torch, res, name, dt, gen, flush, conv_lib)
        if "K4walk" in groups and dt == torch.float32:
            walker_rows(torch, res, gen, flush)
        if "tile" in groups:
            tile_entry_rows(torch, res, name, dt, flush, *tile_libs)
        if "K1tile" in groups:
            warp_tile_rows(torch, res, name, dt, gen, flush, warp_tile_lib)
        if "fill" in groups:
            fill_rows(torch, res, name, dt, flush)
        torch.cuda.empty_cache()
    return res


def projection_rows(torch, res, name, dt, flush, steps):
    """``flow_project`` with the fill, B = 2, against the tree's CPU path."""
    from memcnet_tpu_torch.ops import projection

    dev = torch.device("cuda")
    pflow = PROBE.synthetic_flow(2, dev).to(dt)  # both directions, as served
    # both trees' CPU path is the plain composition
    ref = projection.flow_project(pflow.cpu(), fillhole=True).to(dev)
    got = projection.flow_project(pflow, fillhole=True)
    n_ops, dev_ms, by_kernel = PROBE.device_ops(
        lambda: projection.flow_project(pflow, fillhole=True))
    key = f"flow_project {name}"
    res[key] = dict(ms=timed_ms(torch, lambda: projection.flow_project(pflow, fillhole=True),
                                flush),
                    err=max_ulps(torch, got, ref, 0.0), launches=n_ops, device_ms=dev_ms,
                    kernels=by_kernel)
    if steps:
        res[key]["steps"] = projection_steps(torch, projection, pflow, flush)
    del ref, got


def warp_rows(torch, res, name, dt, gen, flush, step_lib):
    """K1's split warp, its frame warp and the split warp on a noisy flow."""
    from memcnet_tpu_torch.ops.cuda import _lib, warp_kernel

    dev = torch.device("cuda")
    smooth = PROBE.synthetic_flow(1, dev).to(dt).float()
    frame = torch.rand((1, 3, H, W), generator=gen, device=dev).to(dt)
    ctx = torch.randn((1, 64, H, W), generator=gen, device=dev).to(dt)
    filt = (torch.rand((1, 16, H, W), generator=gen, device=dev) / 8.0).to(dt)
    noisy = noisy_flow(torch, dev).to(dt).float()
    for srcs, flow, tag in (((frame, ctx), smooth, ""), ((frame,), smooth, ""),
                            ((frame, ctx), noisy, " noisy flow")):
        key = f"K1 {sum(s.shape[1] for s in srcs)}ch{tag} {name}"
        ref = warp_kernel.reference(srcs, flow, filt, 4)
        got = warp_kernel.launch(srcs, flow, filt, 4)
        res[key] = dict(ms=timed_ms(torch, lambda: warp_kernel.launch(srcs, flow, filt, 4),
                                    flush),
                        err=max(max_ulps(torch, g, r, 0.0) for g, r in zip(got, ref)))
        if step_lib is not None and not tag:
            res[key]["steps"] = time_steps(torch, step_lib, warp_kernel, _lib, srcs, flow,
                                           filt, flush)
    del frame, ctx, filt, noisy


WARP_TILE_STEPS = [(0, "first design (K1's kernel, TILE flag, 32x8, 2 channels a barrier)"),
                   (1, "as built"), (2, "32x8 blocks"), (3, "3 box elements a thread"),
                   (4, "at least 4 blocks an SM"), (5, "at least 2 blocks an SM"),
                   (6, "8-byte elements"), (7, "bf16 packed as fetched"),
                   (8, "bf16 packed as fetched, 3 box elements (first build)"),
                   (9, "diagnostic: stage and store, no tap sums"),
                   (10, "diagnostic: tap sums, no fetch")]
WARP_TILE_DIAG = (9, 10)  # compute something else: timed only


def warp_tile_rows(torch, res, name, dt, gen, flush, step_lib=None):
    """K1's tile entry on the tiles of star's split warp (frame and context,
    67 channels, B = 1) at 768x1344 on (1, 4) and (1, 2, 2), halo 64, with
    phase 8's +-20 px flow (``probe.tile_flows``), against its plain version;
    with ``step_lib``, its design steps (``warp_tile_steps.cu``), each
    checked bit for bit against the entry."""
    from memcnet_tpu_torch.ops.cuda import warp_kernel
    from memcnet_tpu_torch.parallel import make_mesh, make_mesh_2d
    from memcnet_tpu_torch.parallel import tiling as T

    dev = torch.device("cuda")
    devs = [dev] * 4
    frame = torch.rand((1, 3, H, W), generator=gen, device=dev).to(dt)
    ctx = torch.randn((1, 64, H, W), generator=gen, device=dev).to(dt)
    filt = (torch.rand((1, 16, H, W), generator=gen, device=dev) / 8.0).to(dt)
    flow = PROBE.tile_flows(dev)["pm20"][:1].contiguous()
    for grid, axis_h in TILE_GRIDS:
        mesh = make_mesh(4, devices=devs) if grid == "tile4" else make_mesh_2d(4, devices=devs)
        ring = T._ring(mesh, 1, "tile", axis_h)
        Wl, Hl, hh = T._grid(mesh, frame.shape, "tile", axis_h, TILE_HALO, None)
        exts = []
        for im in (frame, ctx):
            e = T._exchange_halo(ring.split(im), ring, "tile", TILE_HALO, -1)
            exts.append((T._exchange_halo(e, ring, axis_h, hh, -2) if axis_h else e).contiguous())
        org = T._origins(ring, "tile", axis_h, Wl, Hl, dev)
        fl, fi = ring.split(flow).contiguous(), ring.split(filt).contiguous()
        geom = (TILE_HALO, hh, 4, W, H)

        def entry():
            return warp_kernel.launch_tile(exts, fl, fi, org, *geom)

        got = entry()
        ref = warp_kernel.tile_reference(exts, fl, fi, org, *geom)
        key = f"K1 tile {grid} {name}"
        res[key] = timed_row(torch, entry, flush,
                             err=max(max_ulps(torch, g, r, 0.0) for g, r in zip(got, ref)),
                             graph_ops=PROBE.graph_ops(entry), tile=f"{tuple(exts[1].shape)}")
        if step_lib is not None:
            res[key]["steps"] = warp_tile_steps(torch, step_lib, exts, fl, fi, org, hh, got, flush)
        del exts, fl, fi, got, ref


def warp_tile_steps(torch, lib, exts, fl, fi, org, hh, want, flush):
    """ms of each design step of K1's tile entry (``warp_tile_steps.cu``) on
    the entry's inputs, each checked bit for bit against the entry's output."""
    from memcnet_tpu_torch.ops.cuda import _lib, warp_kernel

    outs = [torch.empty_like(w) for w in want]
    sources = warp_kernel._WarpSources()
    for k, (e, o) in enumerate(zip(exts, outs)):
        sources.src[k], sources.out[k], sources.channels[k] = e.data_ptr(), o.data_ptr(), e.shape[1]
    sources.n = len(exts)
    n, _, Hl, Wl = fl.shape
    ms = {}
    for step, label in WARP_TILE_STEPS:
        def run():
            err = lib.memc_warp_tile_step(step, ctypes.byref(sources), fl.data_ptr(), fi.data_ptr(),
                                          org.data_ptr(), n, Hl, Wl, TILE_HALO, hh, H, W,
                                          _lib.dtype_code(fi.dtype),
                                          torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"warp tile step {label}: CUDA error {err}")
        for o in outs:
            o.fill_(float("nan"))
        run()
        if step not in WARP_TILE_DIAG and not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise RuntimeError(f"warp tile step {label}: not the entry's bits")
        ms[label] = timed_ms(torch, run, flush)
    return ms


def fill_rows(torch, res, name, dt, flush):
    """K3 on the average and masks of the +-20 px flow's projection at
    768x1344, B = 2: with the down search and without, each bit for bit
    against its plain version; and ``flow_project`` with the down scan whole
    against its plain composition.  Device operations from a CUDA graph of
    the call (``probe.graph_ops``)."""
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    dev = torch.device("cuda")
    flow = PROBE.synthetic_flow(2, dev).to(dt)
    _, avg, masks = P.sums_stage_reference(flow, True)
    for label, down in (("fill_holes[down]", True), ("fill_holes", False)):
        def fill():
            return P.launch_fill(avg, masks, dt, down=down)

        exact = bool(torch.equal(fill(), P.fill_stage_reference(avg, masks, dt, down=down)))
        res[f"{label} {name}"] = timed_row(torch, fill, flush, bit_equal=exact,
                                           graph_ops=PROBE.graph_ops(fill))

    def whole():
        return projection.flow_project(flow, fillhole=True, fix_down_scan_bug=True)

    ref = projection.reference(flow, fillhole=True, fix_down_scan_bug=True)
    res[f"flow_project[down] {name}"] = timed_row(torch, whole, flush,
                                                  err=max_ulps(torch, whole(), ref, 0.0),
                                                  graph_ops=PROBE.graph_ops(whole))
    del avg, masks


def conv_rows(torch, res, name, dt, gen, flush, step_lib=None):
    """K4: the ctx conv and SPyNet's five 7x7 convs at each of its levels,
    each beside ``F.conv2d`` of the same conv (TF32 off) and its bounds; the
    bf16 rows with a digest of their output bits (main() fails if the two
    trees' differ); with ``step_lib``, the float32 rows' design steps
    (``conv_f32_steps``)."""
    import hashlib

    import torch.nn.functional as F

    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops.cuda import conv_kernel

    dev = torch.device("cuda")
    convs = [("ctx 3->64", 3, 64, H, W, False, False)]
    convs += [(f"L{lvl} {H >> lvl}x{W >> lvl} {cin}->{cout}", cin, cout, H >> lvl, W >> lvl,
               True, j < len(BASIC) - 1)
              for lvl in range(LEVELS) for j, (cin, cout) in enumerate(BASIC)]
    wgen = torch.Generator().manual_seed(2)
    for label, cin, cout, h, w_, bias, relu in convs:
        x = (torch.rand((2, cin, h, w_), generator=gen, device=dev) * 4.0 - 2.0).to(dt)
        if bias:
            w = I.torch_default_uniform((cout, cin, 7, 7), wgen).to(dev).to(dt)
            b = I.torch_default_uniform((cout,), wgen, fan_in=cin * 49).to(dev)
        else:
            w = I.resnet_msra((cout, cin, 7, 7), torch.Generator().manual_seed(1)).to(dev).to(dt)
            b = None
        got = conv_kernel.launch(x, w, b, relu=relu)
        ref = conv_kernel.reference(x, w, b, relu=relu)

        def library():
            out = F.conv2d(x, w, None if b is None else b.to(dt), padding=3)
            return out.clamp_(min=0.0) if relu else out

        flops = 2 * 2 * h * w_ * cout * cin * 49
        nbytes = 2 * h * w_ * (cin + cout) * x.element_size() + w.numel() * w.element_size()
        t_bytes = nbytes / 3.35e12 * 1e3
        row = dict(ms=timed_ms(torch, lambda: conv_kernel.launch(x, w, b, relu=relu), flush),
                   err=max_ulps(torch, got, ref, 5e-4 if bias else 0.0),
                   library_ms=timed_ms(torch, library, flush))
        if dt == torch.float32:
            row.update(bound_tf32x3_ms=max(t_bytes, 3 * flops / 495e12 * 1e3),
                       bound_cuda_cores_ms=max(t_bytes, flops / 67e12 * 1e3))
            if step_lib is not None:
                row["steps"] = conv_f32_steps(torch, step_lib, conv_kernel, x, w, b, relu, got,
                                              ref, flush)
        else:
            row.update(bound_ms=max(t_bytes, flops / 989e12 * 1e3),
                       digest=hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes())
                       .hexdigest()[:16])
        res[f"K4 {label} {name}"] = row
        del x, w, b, got, ref


def walker_rows(torch, res, gen, flush):
    """float32 K4 at the spec walkers' 3x3 convs (WALKER_CONVS), B = 1 and 4,
    kaiming weights and uniform biases, each beside ``F.conv2d`` (TF32 off),
    its bounds (3 TF32 passes at 495 TFLOP/s; the CUDA cores' 67), the
    body's geometry, and its error from a float64 conv: the largest and the
    mean of err * sign(exact), which reads below zero where the sums lean
    toward zero (``F.conv2d``'s largest beside it); then each walk
    whole as the measured tree's ``models/mononet.py`` runs it (eval mode),
    with its float32 K4 launches."""
    import torch.nn.functional as F

    from memcnet_tpu_torch.models import mononet
    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops.cuda import conv_kernel

    dev = torch.device("cuda")
    wgen = torch.Generator().manual_seed(3)
    for B in WALKER_BATCHES:
        for part, cin, cout, lvl, relu in WALKER_CONVS:
            h, w_ = H >> lvl, W >> lvl
            x = torch.rand((B, cin, h, w_), generator=gen, device=dev) * 4.0 - 2.0
            w = I.kaiming_uniform((cout, cin, 3, 3), wgen).to(dev)
            b = (torch.rand((cout,), generator=wgen) - 0.5).to(dev)
            got = conv_kernel.launch(x, w, b, relu=relu)

            def library():
                out = F.conv2d(x, w, b, padding=1)
                return out.clamp_(min=0.0) if relu else out

            flops = 2 * B * h * w_ * cout * cin * 9
            t_bytes = (4 * B * h * w_ * (cin + cout) + 4 * w.numel()) / 3.35e12 * 1e3
            geo = conv_kernel.f32_geometry(B, cin, h, w_, cout, 3)
            ref64 = F.conv2d(x.double(), w.double(), b.double(), padding=1)
            ref64 = ref64.clamp(min=0.0) if relu else ref64
            e64 = got.double() - ref64
            res[f"K4walk {part} {h}x{w_} {cin}->{cout} B{B}"] = dict(
                ms=timed_ms(torch, lambda: conv_kernel.launch(x, w, b, relu=relu), flush),
                err=float((got - conv_kernel.reference(x, w, b, relu=relu)).abs().max()),
                err_f64=float(e64.abs().max()), lean_f64=float((e64 * ref64.sign()).mean()),
                library_err_f64=float((library().double() - ref64).abs().max()),
                library_ms=timed_ms(torch, library, flush),
                bound_tf32x3_ms=max(t_bytes, 3 * flops / 495e12 * 1e3),
                bound_cuda_cores_ms=max(t_bytes, flops / 67e12 * 1e3),
                geometry={k: geo[k] for k in ("CG", "NT", "MT", "taps")})
            del x, w, b, got, ref64, e64
    fs2 = 16
    walks = [("thin trunk", mononet.mononet5_specs(3, True, variant="thin"), 6, False),
             ("filter branches", mononet.branch_specs(fs2), 16, True),
             ("rectify", mononet.rectify_specs(3 + 4 + 2 * fs2 + 2), 41, False)]
    for B in WALKER_BATCHES:
        for label, specs, cin, dual in walks:
            nets = [mononet.build_modulelist(specs).to(dev).eval() for _ in range(1 + dual)]
            for net in nets:
                mononet.init_specs(net, specs, I.kaiming_uniform, wgen)
            x = torch.rand((B, cin, H, W), generator=gen, device=dev)

            def walk():
                with torch.inference_mode():
                    if dual:
                        return mononet.forward_dual_path(nets[0], nets[1], specs, x)
                    return mononet.forward_single_path(nets[0], specs, x)

            before = conv_kernel.f32_counter.count
            walk()
            launches = conv_kernel.f32_counter.count - before
            res[f"K4walk walk {label} B{B}"] = dict(ms=timed_ms(torch, walk, flush),
                                                   k4_f32=launches)
            del nets, x
            torch.cuda.empty_cache()


def conv_f32_steps(torch, lib, conv_kernel, x, w, b, relu, want, ref, flush):
    """ms of each design step of K4's float32 body (``conv_f32_steps.cu``) at
    one conv; the as-built geometry must give the entry's bits, every
    3-pass step the plain version within 5e-4."""
    B, C, h, w_ = x.shape
    O, K = w.shape[0], w.shape[2]
    built = conv_kernel.f32_geometry(B, C, h, w_, O, K)
    nt = next(n for n in conv_kernel.F32_NT if n >= min(O, 64))
    first = dict(conv_kernel.f32_geometry(B, C, h, w_, O, K, small_o=False, max_mt=2),
                 NT=max(16, nt), MT=2)
    steps = [(0, None, "0 direct kernel (CUDA cores, the old body)"),
             (1, first, "1 3xTF32, MT 2, NT >= 16 (first GEMM)"),
             (1, dict(first, NT=nt), "2 + NT 8 for O <= 8"),
             (1, conv_kernel.f32_geometry(B, C, h, w_, O, K, small_o=False, max_mt=2),
              "3 + wave fitting"),
             (1, conv_kernel.f32_geometry(B, C, h, w_, O, K, small_o=False),
              "4 + MT 4 for NT 16, 32"),
             (1, built, "5 + taps in N for O * K <= 16 (as built)"),
             (2, built, "6 one TF32 pass (TF32 precision; timing only)")]
    if not built["taps"]:
        steps += [(4, built, "7 halo split once a chunk in shared memory"),
                  (5, built, "8 raw weights split in registers")]
        if built["CG"] == 8 and (built["NT"], built["MT"]) in ((64, 2), (32, 4)):
            steps.append((3, built, "9 one block an SM (255 registers)"))
    out = torch.empty_like(want)
    bias_ptr = None if b is None else b.data_ptr()
    ms = {}
    for step, geo, label in steps:
        g = geo or dict(CG=0, NT=0, MT=0, taps=False)
        wp = (w if geo is None else conv_kernel.pack_f32_tap_weights(w) if g["taps"]
              else conv_kernel.pack_f32_weights(w, g["CG"], g["NT"], split=step != 5))

        def run():
            err = lib.memc_conv_f32_step(step, x.data_ptr(), wp.data_ptr(), bias_ptr,
                                         out.data_ptr(), B, C, h, w_, O, K, g["CG"], g["NT"],
                                         g["MT"], int(g["taps"]), int(relu),
                                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"conv f32 step {label}: CUDA error {err}")
        run()
        if step != 2 and float((out - ref).abs().max()) > 5e-4:
            raise RuntimeError(f"conv f32 step {label}: off the plain version")
        if geo is built and step != 2 and not torch.equal(out, want):
            raise RuntimeError(f"conv f32 step {label}: not the entry's bits")
        ms[label] = timed_ms(torch, run, flush)
    return ms


def level_input_rows(torch, res, name, dt, gen, flush, level_lib=None):
    """K5 at SPyNet's top level, B = 2, in the measured tree: the level input
    as separate ops around the standalone K5 (``probe.level_prologue``) and,
    in a tree that has it, fused in one launch; the standalone K5 on the
    float32 grid; and SPyNet's whole forward.  Each with its device
    operations and device ms, the level inputs' warp held against the plain
    grid sample of their own upsampled flow; with ``level_lib``, the fused
    kernel's design steps (``level_steps.cu``), each as-built variant checked
    bit for bit against the kernel."""
    from memcnet_tpu_torch.models import spynet
    from memcnet_tpu_torch.ops.cuda import gather_kernel

    dev = torch.device("cuda")
    fst, snd = (torch.rand((2, 3, H, W), generator=gen, device=dev).to(dt) for _ in range(2))
    cflow = PROBE.level_flow(2, 0, dev).to(dt)
    ways = {"K5 level input, separate ops": lambda: PROBE.level_prologue(fst, snd, cflow)}
    if hasattr(gather_kernel, "launch_level_input"):
        def fused():
            return gather_kernel.launch_level_input(fst, snd, cflow)

        ways["K5 level input, fused"] = fused
    for label, fn in ways.items():
        out = fn()
        want = gather_kernel.reference(snd, spynet.warp_grid(out[:, 6:8]))
        n_ops, dev_ms, by_kernel = PROBE.device_ops(fn)
        res[f"{label} {name}"] = dict(ms=timed_ms(torch, fn, flush),
                                      err=max_ulps(torch, out[:, 3:6], want, 0.0),
                                      launches=n_ops, device_ms=dev_ms, kernels=by_kernel)
    if level_lib is not None:
        res[f"K5 level input, fused {name}"]["steps"] = level_steps(
            torch, level_lib, fst, snd, cflow, gather_kernel.launch_level_input(fst, snd, cflow),
            flush)
    grid = spynet.warp_grid(PROBE.synthetic_flow(2, dev).to(dt)).contiguous()
    res[f"K5 grid sample {name}"] = dict(
        ms=timed_ms(torch, lambda: gather_kernel.launch(snd, grid), flush),
        err=max_ulps(torch, gather_kernel.launch(snd, grid), gather_kernel.reference(snd, grid),
                     0.0))
    net = spynet.SPyNet()
    net.init_params(torch.Generator().manual_seed(0))
    net = net.to(device=dev, dtype=dt).eval()
    with torch.inference_mode():
        n_ops, dev_ms, by_kernel = PROBE.device_ops(lambda: net(fst, snd))
        res[f"SPyNet forward B=2 {name}"] = dict(
            ms=timed_ms(torch, lambda: net(fst, snd), flush, reps=5), launches=n_ops,
            device_ms=dev_ms, kernels={}, by_kernel=by_kernel)


def level_steps(torch, lib, fst, snd, cflow, want, flush):
    """ms of each of K5 level input's design steps; the as-built variants
    (steps 0 and 4) must equal the kernel's output bit for bit."""
    from memcnet_tpu_torch.ops.cuda import _lib

    out = torch.empty_like(want)
    B, _, H_l, W_l = fst.shape
    code = _lib.dtype_code(fst.dtype)
    ms = {}
    for step, pix, label in LEVEL_STEPS:
        def run():
            err = lib.memc_level_step(step, pix, fst.data_ptr(), snd.data_ptr(), cflow.data_ptr(),
                                      out.data_ptr(), B, H_l, W_l, code,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"level step {label}: CUDA error {err}")
        run()
        if step in (0, 4) and not torch.equal(out, want):
            raise RuntimeError(f"level step {label}: differs from the kernel")
        ms[label] = timed_ms(torch, run, flush)
    return ms


def op_inputs(torch, dev, dt, B=2):
    """N7's depth (quarters) and N8's frames at H x W, in ``dt``, from a
    seed."""
    gen = torch.Generator(device=dev).manual_seed(18)
    depth = (torch.randint(1, 8, (B, 1, H, W), generator=gen, device=dev) * 0.25).to(dt)
    f1 = torch.rand((B, 3, H, W), generator=gen, device=dev)
    f2 = (f1 + 0.05 * torch.randn(f1.shape, generator=gen, device=dev)).clamp(0.0, 1.0)
    return depth, f1.to(dt), f2.to(dt)


THRESHOLD = 20.0 / 255.0


def host_us(torch, fn, reps=50):
    """µs of host time a call takes to enqueue its work (no synchronize
    inside the loop): where it exceeds the device time the card waits."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def timed_row(torch, fn, flush, err=None, **extra):
    """ms of ``fn`` after an L2 flush, its device operations and device ms,
    and its host µs a call."""
    n_ops, dev_ms, by_kernel = PROBE.device_ops(fn)
    row = dict(ms=timed_ms(torch, fn, flush), launches=n_ops, device_ms=dev_ms, kernels=by_kernel,
               host_us=host_us(torch, fn), **extra)
    if err is not None:
        row["err"] = err
    return row


def payload_rows(torch, res, name, dt, flush):
    """K2's payload entry untiled at B = 2, 768x1344 on the +-20 px flow,
    N7's and N8's payloads built inside the scatter, each with its last
    plane checked exactly against its plain version.  Then N7 and N8 whole
    with the fill."""
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    dev = torch.device("cuda")
    flow = PROBE.synthetic_flow(2, dev).to(dt)
    depth, f1, f2 = op_inputs(torch, dev, dt)
    for planes, op, ins in ((3, "depth", (depth,)), (4, "gated", (f1, f2))):
        def entry():
            return P.launch_payload(op, flow, ins, THRESHOLD, False)

        ref = P.op_stage_reference(op, flow, ins, THRESHOLD, False)
        exact = bool(torch.equal(entry()[0][:, -1], ref[0][:, -1]))
        res[f"K2 payload P={planes} {name}"] = timed_row(torch, entry, flush, last_plane_exact=exact)
    for op_name, fn in (("N7", lambda: projection.depth_flow_project(flow, depth, fillhole=True)),
                        ("N8", lambda: projection.weighted_flow_project(flow, f1, f2,
                                                                        fillhole=True))):
        res[f"{op_name} untiled, fill {name}"] = timed_row(torch, fn, flush)


def tile_op_rows(torch, res, name, dt, flush, fill_lib=None):
    """At 768x1344, B = 2, halo 64, on (1, 4) and (1, 2, 2), the +-20 px
    flow: K3's tile entry (from avg, cnt alone) and the whole tiled fill,
    each against the carry entry's plain version with the carries of
    ``_carry``, bit for bit; the tiled flow_project with the fill; and on
    (1, 4) K2's payload entry on tile origins (P = 3 and 4, the payload
    built inside), and N7 and N8 on partitioned frames with the fill."""
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.parallel import (active_partition, make_mesh, make_mesh_2d,
                                            shard_frames, spatial_tiling)
    from memcnet_tpu_torch.parallel import tiling as T

    dev = torch.device("cuda")
    devs = [dev] * 4
    flow = PROBE.synthetic_flow(2, dev).to(dt)
    depth, f1, f2 = op_inputs(torch, dev, dt)
    for grid, axis_h in TILE_GRIDS:
        mesh = make_mesh(4, devices=devs) if grid == "tile4" else make_mesh_2d(4, devices=devs)
        avg, cnt, ring = T._tiled_average(mesh, flow, TILE_HALO, "tile", axis_h, None)
        has = cnt > 0.0
        carries = [T._carry(T._edge_message(has, avg, 2, last=True), ring, "tile", 1),
                   T._carry(T._edge_message(has, avg, 2, last=False), ring, "tile", -1),
                   T._carry(T._edge_message(has, avg, 1, last=True), ring, axis_h, 1)
                   if axis_h else None]
        ref = P.carry_fill_reference(avg, cnt, *carries, dt)
        stacks = (ring.stacked("tile"), ring.stacked(axis_h) if axis_h else None)

        def entry():
            return P.launch_fill_tiles(avg, cnt, stacks, None, None, None, dt)

        def whole():
            return T._tiled_fill(avg, cnt, ring, "tile", axis_h, dt)

        res[f"K3 tile entry {grid} {name}"] = timed_row(
            torch, entry, flush, bit_equal=bool(torch.equal(entry(), ref)))
        res[f"K3 tiled fill, avg and cnt in {grid} {name}"] = timed_row(
            torch, whole, flush, bit_equal=bool(torch.equal(whole(), ref)))
        if fill_lib is not None:
            res[f"K3 tile entry {grid} {name}"]["steps"] = fill_tiles_steps(
                torch, fill_lib, avg, cnt, ring, axis_h, carries, ref, flush)
        res[f"tiled flow_project, fill {grid} {name}"] = timed_row(
            torch, lambda: T.tiled_flow_project(mesh, flow, halo=TILE_HALO, fillhole=True,
                                                axis_h=axis_h), flush)
        del avg, cnt, carries, ref
        with spatial_tiling(mesh, halo=TILE_HALO, axis_h=axis_h):
            shard_frames(mesh, torch.zeros((1, 1, H, W), device=dev))
            ft, dtl, t1, t2 = shard_frames(mesh, flow, depth, f1, f2)
            p = active_partition()
            n = ft.shape[0]
            S, org = p.samples(n), p.origins((H, W), n, dev)
            whole2 = p.gather(t2, (H, W))
            if grid == "tile4":
                for planes, op, ins in ((3, "depth", (dtl,)), (4, "gated", (t1, whole2))):
                    def tile_entry():
                        return P.launch_payload_tile(op, ft, ins, THRESHOLD, org, S, H, W)
                    got, ref = tile_entry(), P.payload_tile_reference(
                        op, ft, ins, THRESHOLD, org, S, H, W)
                    key = f"K2 payload tile P={planes} tile4 {name}"
                    res[key] = timed_row(torch, tile_entry, flush,
                                         err=float((got - ref).abs().max()),
                                         last_plane_exact=bool(torch.equal(got[:, -1],
                                                                           ref[:, -1])))
                    if fill_lib is not None:
                        res[key]["steps"] = payload_tile_steps(
                            torch, fill_lib, op, ft, ins, P.op_payload(op, ft, ins, THRESHOLD, org),
                            org, S, got, flush)
                    del got, ref
            for op_name, fn in (
                    ("N7", lambda: projection.depth_flow_project(ft, dtl, fillhole=True)),
                    ("N8", lambda: projection.weighted_flow_project(ft, t1, t2, fillhole=True))):
                res[f"{op_name} partitioned, fill {grid} {name}"] = timed_row(torch, fn, flush)
        del ft, dtl, t1, t2, whole2


def fill_tiles_steps(torch, lib, avg, cnt, ring, axis_h, carries, ref, flush):
    """ms of each step of K3's tile entry (``fill_tiles_steps.cu``) on the
    entry's own inputs: the mask pass and the fill as built (no summaries),
    with summaries (a memset, atomicOr), and the fill with every carry given
    (the carry entry's design); each fill must give the plain version's
    bits."""
    from memcnet_tpu_torch.ops.cuda import _lib
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    n, _, Hl, Wl = avg.shape
    a, c = avg.contiguous(), cnt.contiguous()
    masks = torch.empty(sum(math.prod(s) for s in P.mask_shapes(n, Hl, Wl)), dtype=torch.int32,
                        device=avg.device)
    out = torch.empty((n, 2, Hl, Wl), dtype=ref.dtype, device=avg.device)
    (tw, iw), (th, ih) = ring.stacked("tile"), ring.stacked(axis_h) if axis_h else (1, 1)
    cs = [None if x is None else x.contiguous() for x in carries]

    def run(step):
        err = lib.memc_fill_tiles_step(step, a.data_ptr(), c.data_ptr(), masks.data_ptr(),
                                       out.data_ptr(), n, Hl, Wl, tw, iw, th, ih,
                                       *[None if x is None else x.data_ptr() for x in cs],
                                       _lib.dtype_code(ref.dtype),
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fill tiles step {step}: CUDA error {err}")

    labels = {0: "memset of the summaries", 1: "mask pass with summaries (atomicOr)",
              2: "fill with summaries", 3: "mask pass as built (no summaries)",
              4: "fill as built (no summaries)", 5: "fill with every carry given"}
    for steps in ((3, 4), (0, 1, 2), (0, 1, 5)):
        for step in steps:
            run(step)
        if not torch.equal(out, ref):
            raise RuntimeError(f"fill tiles steps {steps}: not the plain version's bits")
    return {labels[k]: timed_ms(torch, lambda: run(k), flush) for k in labels}


def payload_tile_steps(torch, lib, op, ft, ins, payload, org, S, want, flush):
    """ms of each step of K2's payload entry on tile origins
    (``fill_tiles_steps.cu``): the memset, the scatter that builds the
    payload (as built), the first design's scatter of a built payload, the
    fold; both scatters then the fold must give the entry's last plane."""
    from memcnet_tpu_torch.ops.cuda import _lib
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    n, _, h, w = ft.shape
    planes = 4 if op == "gated" else 3
    sums = torch.empty((S, planes, H, W), device=ft.device)
    out = torch.empty_like(sums)
    ins = [x.float().contiguous() for x in ins]
    payload = payload.contiguous()

    def run(step):
        err = lib.memc_payload_tile_step(
            step, P.PAYLOAD_OPS[op], ft.data_ptr(), ins[0].data_ptr(), ins[-1].data_ptr(),
            THRESHOLD, payload.data_ptr(), org.data_ptr(), sums.data_ptr(), out.data_ptr(), n, h,
            w, S, H, W, _lib.dtype_code(ft.dtype), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"payload tile step {step}: CUDA error {err}")

    for steps in ((0, 1, 3), (0, 2, 3)):
        for step in steps:
            run(step)
        if not torch.equal(out[:, -1], want[:, -1]):
            raise RuntimeError(f"payload tile steps {steps}: the last plane differs")
    labels = {0: "memset of S", 1: "scatter building the payload (as built)",
              2: "scatter of a built payload (first design)", 3: "fold"}
    return {labels[k]: timed_ms(torch, lambda: run(k), flush) for k in labels}


def tile_entry_rows(torch, res, name, dt, flush, level_lib=None, sums_lib=None, fill_lib=None):
    """The tile entries at 768x1344, B = 2, halo 64 in the measured tree:
    K5's level input on the tiles of the top level, (1, 4) and (1, 2, 2),
    the coarse flow of probe.level_flow clipped to +-10 px (its merged fst
    and up must equal the untiled kernel's bit for bit); K2's tile entry on
    (1, 4) and (1, 2, 2) with the +-20 px flow of probe.synthetic_flow (its
    counts must equal its plain version's).  Each with its device
    operations; with ``level_lib``, K5's tile entry in variants, and with
    ``sums_lib``, K2's tile entry in steps; then ``tile_op_rows`` (with
    ``fill_lib``, K3's tile entry and K2's payload tile entry in steps)."""
    from memcnet_tpu_torch.ops.cuda import gather_kernel as G
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.parallel import (active_partition, make_mesh, make_mesh_2d,
                                            shard_frames, spatial_tiling)
    from memcnet_tpu_torch.parallel import tiling as T

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    devs = [dev] * 4
    fst, snd = (torch.rand((2, 3, H, W), generator=gen, device=dev).to(dt) for _ in range(2))
    cflow = PROBE.level_flow(2, 0, dev).clamp(-10.0, 10.0).to(dt)
    flow = PROBE.synthetic_flow(2, dev).to(dt)
    untiled = G.launch_level_input(fst, snd, cflow)
    for grid, axis_h in TILE_GRIDS:
        mesh = make_mesh(4, devices=devs) if grid == "tile4" else make_mesh_2d(4, devices=devs)
        with spatial_tiling(mesh, halo=TILE_HALO, axis_h=axis_h):
            shard_frames(mesh, torch.zeros((1, 1, H, W), device=dev))
            p = active_partition()
            ft = p.split(fst)
            window, origins, level = p.level_input_window(p.split(cflow), ft)
            args = (ft, p.gather(p.split(snd)), window, origins, *level)
        tiles = G.launch_level_input_tile(*args)
        got = p.merge(tiles)
        n_bad = int((got[:, :3] != untiled[:, :3]).sum() + (got[:, 6:] != untiled[:, 6:]).sum())
        n_ops, dev_ms, by_kernel = PROBE.device_ops(lambda: G.launch_level_input_tile(*args))
        key = f"K5 level input tile {grid} {name}"
        res[key] = dict(
            ms=timed_ms(torch, lambda: G.launch_level_input_tile(*args), flush),
            err=max_ulps(torch, got[:, 3:6], G.reference(snd, G.warp_grid(got[:, 6:8])), 0.0),
            launches=n_ops, device_ms=dev_ms, kernels=by_kernel, fst_up_not_bit_equal=n_bad,
            tile=f"{tuple(ft.shape)}")
        if level_lib is not None:
            res[key]["steps"] = level_tile_steps(torch, level_lib, args, tiles, flush)
        del got, tiles, args, ft, window
        # K2's tile entry on the tiles tiling.py hands it
        ring = T._ring(mesh, 2, "tile", axis_h)
        Wl, Hl, hh = T._grid(mesh, flow.shape, "tile", axis_h, TILE_HALO, None)
        fl = ring.split(flow)
        org = T._origins(ring, "tile", axis_h, Wl, Hl, dev)
        geom = (TILE_HALO, hh, W, H)
        got = P.launch_tile_sums(fl, org, *geom)
        ref = P.tile_sums_reference(fl, org, *geom)
        n_ops, dev_ms, by_kernel = PROBE.device_ops(lambda: P.launch_tile_sums(fl, org, *geom))
        res[f"K2 tile sums {grid} {name}"] = dict(
            ms=timed_ms(torch, lambda: P.launch_tile_sums(fl, org, *geom), flush),
            err=float((got - ref).abs().max()), launches=n_ops, device_ms=dev_ms,
            kernels=by_kernel, counts_equal=bool(torch.equal(got[:, 2], ref[:, 2])),
            tile=f"{tuple(fl.shape)}")
        if sums_lib is not None:
            res[f"K2 tile sums {grid} {name}"]["steps"] = tile_sums_steps(
                torch, sums_lib, fl, org, geom, got, flush)
        del got, ref
    del flow
    tile_op_rows(torch, res, name, dt, flush, fill_lib)


def level_tile_steps(torch, lib, args, want, flush):
    """ms of each variant of K5's tile entry (``level_tile_steps.cu``), each
    checked bit for bit against the entry's output."""
    from memcnet_tpu_torch.ops.cuda import _lib

    ft, snd, window, origins, GH, GW = args
    n, _, th, tw = ft.shape
    out = torch.empty_like(want)
    ms = {}
    for step, label in LEVEL_TILE_STEPS * 2:
        def run():
            err = lib.memc_level_tile_step(
                step, ft.data_ptr(), snd.data_ptr(), window.data_ptr(), origins.data_ptr(),
                out.data_ptr(), n, snd.shape[0], th, tw, window.shape[2], window.shape[3], GH,
                GW, _lib.dtype_code(ft.dtype), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"level tile step {label}: CUDA error {err}")
        run()
        if not torch.equal(out, want):
            raise RuntimeError(f"level tile step {label}: differs from the entry")
        ms[label] = min(ms.get(label, float("inf")), timed_ms(torch, run, flush))
    return ms


def tile_sums_steps(torch, lib, fl, org, geom, want, flush):
    """ms of each step of K2's tile entry (``tile_sums_steps.cu``) on the
    entry's own inputs.  The scatter as built, then the fold as built, must
    give the entry's counts; the fold as built must equal the first design's
    fold bit for bit on the same S, and the fold of the interleaved S (where
    the vector atomic was compiled in) the fold as built on its own S's
    planes."""
    from memcnet_tpu_torch.ops.cuda import _lib

    halo, hh, Wg, Hg = geom
    n, _, Hl, Wl = fl.shape
    He, We = Hl + 2 * hh, Wl + 2 * halo
    code = _lib.dtype_code(fl.dtype)
    sums = torch.empty((n, 3, He, We), device=fl.device)
    sums4 = torch.empty((n, He, We, 4), device=fl.device)
    out = torch.empty_like(sums)

    def run(step, buf=sums):
        err = lib.memc_tile_sums_step(step, fl.data_ptr(), org.data_ptr(), buf.data_ptr(),
                                      out.data_ptr(), n, Hl, Wl, halo, hh, Hg, Wg, code,
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tile sums step {step}: CUDA error {err}")

    for step in (0, 1, 3):
        run(step)
    if not torch.equal(out[:, 2], want[:, 2]):
        raise RuntimeError("tile sums steps: counts differ from the entry's")
    built = out.clone()
    run(4)
    fold_bit_equal = bool(torch.equal(out, built))
    if not fold_bit_equal:
        raise RuntimeError("tile sums steps: the fold as built differs from the first design's")
    vec = bool(lib.memc_tile_sums_vec_atomic())
    ms = {}
    for step, label in TILE_SUMS_STEPS:
        if step >= 5 and not vec:
            continue
        buf = sums4 if step >= 5 else sums
        ms[label] = timed_ms(torch, lambda: run(step, buf), flush)
    if vec:
        for step in (5, 6, 7):
            run(step, sums4)
        vec_out = out.clone()
        for step in (0, 1):
            run(step)
        planes = sums4[..., :3].permute(0, 3, 1, 2).contiguous()
        sums.copy_(planes)
        run(3)
        if not torch.equal(out[:, 2], want[:, 2]) or not torch.equal(vec_out, out):
            raise RuntimeError("tile sums steps: the interleaved path differs")
    return dict(ms, fold_bit_equal=fold_bit_equal, vector_atomic=vec)


def projection_steps(torch, projection, flow, flush):
    """The fused projection's stages, this tree only: K2 (memset, scatter,
    fold-and-divide) with and without the fill's masks, K3 (the fill), and
    the whole op without the L2 flush before it (host time shows)."""
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    _, avg, masks = P.launch_sums(flow, True)
    steps = {
        "K2 stage (memset, scatter, fold-and-divide, masks)":
            timed_ms(torch, lambda: P.launch_sums(flow, True), flush),
        "K2 stage without the fill (result in the flow's type)":
            timed_ms(torch, lambda: P.launch_sums(flow, False), flush),
        "K3 stage (fill)": timed_ms(torch, lambda: P.launch_fill(avg, masks, flow.dtype), flush),
    }
    steps["whole op, no L2 flush before it"] = timed_ms(
        torch, lambda: projection.flow_project(flow, fillhole=True), torch.empty(0, device="cuda"))
    return steps


def build(_lib, name):
    """nvcc ``<name>.cu`` of this folder into a library beside the kernels'."""
    so = os.path.join(_lib.BUILD_ROOT, f"{name}.so")
    os.makedirs(_lib.BUILD_ROOT, exist_ok=True)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC_DIR),
                    os.path.join(HERE, f"{name}.cu"), "-o", so],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "warp_steps":
        lib.memc_warp_step.argtypes = [i, vp, vp, vp, i, i, i, i, vp]
        lib.memc_warp_step.restype = i
    elif name == "warp_tile_steps":
        lib.memc_warp_tile_step.argtypes = [i, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        lib.memc_warp_tile_step.restype = i
    elif name == "level_steps":
        lib.memc_level_step.argtypes = [i, i, vp, vp, vp, vp, i, i, i, i, vp]
        lib.memc_level_step.restype = i
    elif name == "level_tile_steps":
        lib.memc_level_tile_step.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
                                             vp]
        lib.memc_level_tile_step.restype = i
    elif name == "tile_sums_steps":
        lib.memc_tile_sums_step.argtypes = [i, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        lib.memc_tile_sums_step.restype = i
        lib.memc_tile_sums_vec_atomic.restype = i
    elif name == "conv_f32_steps":
        lib.memc_conv_f32_step.argtypes = [i, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i,
                                           vp]
        lib.memc_conv_f32_step.restype = i
    elif name == "fill_tiles_steps":
        lib.memc_fill_tiles_step.argtypes = [i, vp, vp, vp, vp, i, i, i, i, i, i, i, vp, vp, vp, i,
                                             vp]
        lib.memc_fill_tiles_step.restype = i
        lib.memc_payload_tile_step.argtypes = [i, i, vp, vp, vp, ctypes.c_float, vp, vp, vp, vp, i,
                                               i, i, i, i, i, i, vp]
        lib.memc_payload_tile_step.restype = i
    else:
        lib.memc_mma_probe.argtypes = [vp, vp, vp, vp]
        lib.memc_mma_probe.restype = i
    return lib


def mma_probe(torch, lib):
    """For k = 20..30: what one MMA returns for 1 + 2^-k (the accumulator 1,
    one product 2^-k) and for 1 - 1 + 2^-k (three products), less the large
    part, in units of 2^-k: 1 where the small term survives, 0 where it is
    dropped."""
    def mma(products, c0):
        A = torch.zeros(16, 16, dtype=torch.float64)
        A[0, :len(products)] = torch.tensor(products, dtype=torch.float64)
        A = A.to("cuda", torch.bfloat16)
        Bt = torch.ones(8, 16, device="cuda", dtype=torch.bfloat16)
        C = torch.zeros(16, 8, device="cuda")
        C[0, 0] = c0
        D = torch.zeros(16, 8, device="cuda")
        err = lib.memc_mma_probe(A.data_ptr(), Bt.data_ptr(), C.data_ptr(), D.data_ptr())
        if err:
            raise RuntimeError(f"mma probe: CUDA error {err}")
        return float(D[0, 0].double())

    return {k: {"c=1, p=2^-k": (mma([2.0 ** -k], 1.0) - 1.0) / 2.0 ** -k,
                "p=1, -1, 2^-k": mma([1.0, -1.0, 2.0 ** -k], 0.0) / 2.0 ** -k}
            for k in range(20, 31)}


def time_steps(torch, lib, warp_kernel, _lib, srcs, flow, filt, flush):
    outs = [torch.empty_like(s) for s in srcs]
    sources = warp_kernel._WarpSources()
    for k, (a, o) in enumerate(zip(srcs, outs)):
        sources.src[k], sources.out[k], sources.channels[k] = a.data_ptr(), o.data_ptr(), a.shape[1]
    sources.n = len(srcs)
    code = _lib.dtype_code(srcs[0].dtype)
    ms = {}
    for v, label in enumerate(WARP_STEPS):
        def run():
            err = lib.memc_warp_step(v, ctypes.byref(sources), flow.data_ptr(), filt.data_ptr(),
                                     1, H, W, code, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"warp step {label}: CUDA error {err}")
        ms[label] = timed_ms(torch, run, flush)
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="checkout of another commit to time beside this one")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "kernel_ab",
                                                  "results.json"))
    ap.add_argument("--rows", default=",".join(ROW_GROUPS),
                    help="groups of rows to measure, of " + ", ".join(ROW_GROUPS))
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # internal: one tree's process
    ap.add_argument("--steps", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = tuple(g for g in args.rows.split(",") if g)
    if not groups or set(groups) - set(ROW_GROUPS):
        ap.error(f"--rows takes groups of {', '.join(ROW_GROUPS)}, got {args.rows!r}")
    if args.measure:
        print(json.dumps(measure(args.measure, args.steps, groups)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    trees = [("this", ROOT)] + ([("other", os.path.abspath(args.other))] if args.other else [])
    order = ["other", "this", "this", "other"] if args.other else ["this"]
    runs = {name: [] for name, _ in trees}
    for i, name in enumerate(order):
        root = dict(trees)[name]
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root, "--rows", args.rows]
        if name == "this" and not any(r for r in runs["this"]):
            cmd.append("--steps")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    probe = runs["this"][0].pop("mma probe", {})
    for r in runs["this"][1:]:
        r.pop("mma probe", None)
    table = {}
    for key in dict.fromkeys(k for rs in runs.values() for r in rs for k in r):
        row = {}
        for name, rs in runs.items():
            rs = [r[key] for r in rs if key in r]  # rows only one of the trees has
            if not rs:
                continue
            row[f"{name}_ms"] = sum(r["ms"] for r in rs) / len(rs)
            if "err" in rs[0]:
                row[f"{name}_err"] = max(r["err"] for r in rs)
            if "launches" in rs[0]:
                row[f"{name}_launches"] = rs[0]["launches"]
                row[f"{name}_device_ms"] = sum(r["device_ms"] for r in rs) / len(rs)
                row[f"{name}_kernels"] = rs[0]["kernels"]
            for k, v in rs[0].items():  # a row's own checks and shapes
                if k not in ("ms", "err", "launches", "device_ms", "kernels", "steps", "by_kernel"):
                    row[f"{name}_{k}"] = v
        if "steps" in runs["this"][0].get(key, {}):
            row["steps_ms"] = runs["this"][0][key]["steps"]
        table[key] = row
    # bf16 K4 rows: the two trees' output bits must agree
    differ = [k for k, r in table.items()
              if "other_digest" in r and r["this_digest"] != r["other_digest"]]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "order": order, "rows": table, "mma_probe": probe,
                   "runs": runs}, f, indent=1)
    print(f"card: {card}; order {order}")
    for k, row in probe.items():
        print(f"mma probe k={k}: " + ", ".join(f"{n} -> {v:g}" for n, v in row.items()))
    for key, row in table.items():
        trees = [n for n in runs if f"{n}_ms" in row]
        line = f"{key:<34} " + "  ".join(
            f"{n} {row[f'{n}_ms']:.4f} ms"
            + (f" (err {row[f'{n}_err']:.3g})" if f"{n}_err" in row else "") for n in trees)
        if "this_launches" in row:
            line += "  device ops, device ms a call: " + ", ".join(
                f"{n} {row[f'{n}_launches']}, {row[f'{n}_device_ms']:.4f}" for n in trees)
        print(line)
        for n in trees:
            for k, ms in row.get(f"{n}_kernels", {}).items():
                print(f"    {n} kernel {k[:70]:<70} {ms:.4f} ms")
        for n in trees:
            checks = {k[len(n) + 1:]: v for k, v in row.items() if k.startswith(f"{n}_")
                      and k[len(n) + 1:] not in ("ms", "err", "launches", "device_ms", "kernels", "tile")}
            if checks:
                print(f"    {n}: " + ", ".join(f"{k} {v}" for k, v in checks.items()))
        for label, ms in row.get("steps_ms", {}).items():
            print(f"    step {label:<32} " + (f"{ms:.4f} ms" if isinstance(ms, float) else str(ms)))
    if differ:
        print(f"kernel_ab: bf16 K4 output bits differ between the trees: {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
