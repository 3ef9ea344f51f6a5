#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (memcnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result line):
  1. build the hand-written CUDA kernels from memcnet_tpu_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card, in bf16
     and in float32, at the shapes of the 720p serving paths (1280x720 padded
     to 1344x768): K1-K4 at MEMC_Net_star's, K5 (grid sample) at SPyNet's
     top level, K5's fused SPyNet level input (upsample, pad, grid, sample,
     concat) at each of the six levels, exact in its fst and upsampled-flow
     channels, with its device operations (1) beside those of the separate
     ops it replaces, and K4 at each of the five convs of every SPyNet level,
     768x1344 down to 24x42 (MEMC_Net_s; float32 K4 beside two bounds, three
     TF32 passes at 495 TFLOP/s and the CUDA cores' 67), and K1 and K4 at MEMC_Net_VE's
     320x512 window (K1 over six neighbours and their contexts on the smooth
     flow and on +-20 px noise, K4 over seven frames); K5's tile entry (the
     level input on partitioned frames) on the tiles of three levels of
     768x1344 on the (data 1, tile 4) and (1, 2, 2) grids, +-20 px flows,
     its fst and up equal to the untiled kernel's bit for bit, timed at the
     top level on (1, 4) beside F.grid_sample of the same sample; K2's
     payload entry on tile origins (the depth-weighted and gated projections
     on partitioned frames, the payload built inside the scatter from the
     depth or from frame1 and frame2's whole level) on the (1, 4) tiles of
     768x1344, B = 2, P = 3 and 4, its last plane (depth sums, gate counts)
     equal to its plain version's and to the untiled payload entry's, its
     sums within 1e-5 of their scale, at most 3 device operations per call,
     timed beside index_add_ of the same payload into a whole-frame buffer; the projection's K2
     and K3 stages each, and the whole op (flow_project) against its plain
     composition on
     smooth, +-200 px and all-invalid flows, with its device operations per
     call from torch.profiler (at most 4 with the fill); time the kernel,
     its plain version and, where one PyTorch call computes the same
     function, that call;
  3. serve, each model with seeded random weights in bf16 through
     build_model and PaddedInterp on synthetic 1280x720 frame pairs, the
     launch counts set to 0 just before and read just after: MEMC_Net_star
     (3 pairs), MEMC_Net_s (3 pairs), MEMC_Net (1 pair); then MEMC_Net_VE
     through build_model and PaddedVE on 3 synthetic seven-frame 256x448
     windows (padded to 320x512), 1 K1 and 1 K4 launch per window; each
     model is also held against the CPU plain path on a small float32 pair
     or window;
  4. where one frame's (or window's) time goes, for each model: the forward
     alone (CUDA events), its kernels by device time (torch.profiler) and one
     served frame split into host stages (pad, copy in, forward, copy out); for
     MEMC_Net_s also SPyNet's forward alone (B = 2) with its device
     operations, and the same with the separate-op level input it replaced;
     then MEMC_Net_s served in float32, the default type, on 2 synthetic
     1280x720 pairs through PaddedInterp(dtype=torch.float32): 54 K4
     launches a frame (SPyNet's 30, the spec walkers' 24: thin trunk,
     filter branches, RectifyNet), every one on K4's float32 body (csrc/conv_f32.cu,
     three TF32 passes on the tensor cores), the forward alone by CUDA
     events and that body's device ms and launches in one profiled forward,
     and the small float32 pair against the CPU path;
  5. serve through the demos' own main(), on the card by default, each with
     the launch counts set to 0 just before and read just after: demo_hd720p
     (MEMC_Net_star, bf16) over a synthetic 1280x720 YUV420 stream of 9
     frames, --frames 8 (4 pairs: exact output size, 4-line logs, 8 K1, 4 K2,
     4 K3, 4 K4); demo_middlebury (MEMC_Net_s, bf16) on two synthetic 388x584
     sequences (both artifacts, 4 K1, 2 K2, 2 K3, 60 K4, 12 K5); demo_vimeo_ve
     (MEMC_Net_VE, bf16) on two 256x448 septuplets (im4.png each,
     metrics.txt, 2 K1, 2 K4), their PNGs written with libpng's adaptive row
     filters; each demo's proc and total ms per item; demo_hd720p on a
     float32 64x128 stream with --device cuda against --device cpu (ground
     truth byte-equal, reconstructions within 1 level on at most 0.5% of
     bytes); the native YUV library must build (g++) and the HD720p demo
     must read every frame through its NativeYUVReader.  Every kernel launch
     of these runs is recorded with its shapes,
     and each kernel is then held against its plain version at every shape
     recorded (Middlebury's 512x640 pyramid among them), bf16 and float32,
     under phase 2's rules.  Also: one HD720p pair split into host stages
     through the demo's own helpers (read_triple through the native reader
     and through the numpy YUVRead), and png.imread of adaptively filtered
     388x584 and 256x448 frames, and their unfilter in C (csrc/png.cu) and in
     Python;
  6. train each model on the card, float32 (Config's type) and seeded random
     weights, on synthetic 256x448 frames: MEMC_Net_star 6 steps in float32
     and 6 in bf16, MEMC_Net and MEMC_Net_s 4 steps each, through
     build_interp_trainer and fit over a VimeoTriplet of one fixed triplet
     written by probe.write_vimeo (a checkpoint at the end); MEMC_Net_VE 4
     steps of make_ve_train_step on a seven-frame window.  Each step's
     launches, counted around the whole step (forward, backward, optimizer),
     equal EXPECTED_PER_STEP (no K3: training turns the hole fill off); the
     losses fall; every BatchNorm running statistic moves.  Each run's ms per
     step (CUDA events), peak memory and one profiled step (kernels by device
     time, idle share, forward / backward / optimizer device ms, the share of
     each kernel's plain-version backward); one MEMC_Net_star bf16 step at
     768x1344 (time, peak memory); one float32 MEMC_Net and MEMC_Net_star step
     at 2x 64x128 on the card against the CPU (loss, every gradient, every
     parameter and running statistic after the update); every kernel held
     against its plain version at every shape the train steps launched it at
     (recorded), bf16 and float32, and its step gradient against the plain
     version's at the largest such shape;
  7. the op library (ops.__all__'s 13 names) on the card, on textured frames
     from probe.py and the +-20 px flows of phase 2: K2's payload entry (N7's
     payload built inside the scatter from the depth, 3 planes, and N8's
     from the frames with the gate, 4) and K3's down search against their
     plain versions at B = 2, 768x1344, bf16 and float32 (counts, gate
     decisions and masks exact; timed beside their bounds and, for K2,
     index_add_ of the same payload); depth_flow_project,
     weighted_flow_project and flow_project with fix_down_scan_bug whole,
     one K2 and (with the fill) one K3 per call, at most 4 device operations
     with the fill and 3 without; then the op library's run:
     each of the 13 ops once on the card in float32 (the projections, the
     warps and separable_conv at B = 2, 768x1344; the MC ops at B = 1, C = 3)
     with the launch counts set to 0 just before and read just after, each
     against the port's CPU result on the same inputs (and a VJP for the
     ops with hand backwards), and each op's device ms from one profiled
     call;
  8. the parallel layer on the one card: the tile entries of K1, K2 and K3
     (parallel/tiling.py's tile-local steps) against their plain versions at
     MEMC_Net_star's 768x1344 in bf16 and float32, on a (data 1, tile 4)
     and a (1, 2, 2) grid with halo 64, on smooth, +-20 px and all-invalid
     flows (counts and masks exact; K3's tile entry bit-equal to the tiled
     fill's plain composition with the tiles stacked and with every carry
     given, and the whole tiled fill from avg, cnt at most 2 device
     operations), timed beside their bounds; the tiled
     warp and projection against the global ops on the card, with launches,
     ms and device operations per call of each; MEMC_Net_star served at 720p
     under spatial_tiling (tile 4, halo 64) through PaddedInterp, the launch
     counts set to 0 just before and read just after (2 K1, 1 K2 and 1 K3
     tile entry and 1 K4 per frame, no global K1-K3), against the untiled
     forward on the same pairs; one float32 star step at 256x448 on a
     one-rank NCCL group through DataParallelStep (DDP) and ZeroAdamax
     against TrainStep and Adamax; and demo_hd720p --multihost as two
     processes on the one card (a gloo host group) over phase 5's synthetic
     stream in 4 GOPs: both processes work, the journal holds every GOP
     once, and the stitched stream is byte-equal to a one-process run;
  9. partitioned convolutions: MEMC_Net_star, MEMC_Net and MEMC_Net_s served
     in bf16 on synthetic 720p pairs through PaddedInterp(sharded=True), and
     MEMC_Net_VE on synthetic 256x448 windows (padded to 320x512) through
     PaddedVE(sharded=True), under spatial_tiling (halo 64) on the (data 1,
     tile 4) and (1, 2, 2) grids -- pad, shard_frames, every layer on its
     tile with halos, gather, unpad -- the launch counts set to 0 just
     before and read just after (per frame 2 K1 tile, 1 K2 tile, 1 K3 carry
     launch, star's 1 K4 on the halo-extended tiles, MEMC_Net_s's 30 K4 and
     6 K5 tile entries with one whole-level gather each; per window 1 K1
     tile and 1 K4; no global K1-K3 or K5), against the untiled forward on
     the same inputs (the flow net's last conv scaled to about 8 px flows): every
     output's largest difference over its scale reported, in float32 the
     99.9th percentile within 1e-4, in bf16 no further from the float32
     forward of the same weights than the untiled bf16 forward (1.25x on
     the mean and the 99.9th percentile; PART_F32_TOL says why); per model
     and grid the forward's ms by CUDA
     events (median of 5), its device ms and device operations and the
     halo and whole-level gathers' device ms from one profiled forward, and
     its peak memory,
     each beside the untiled forward's; and one float32 MEMC_Net_star step
     at 256x448 on (1, 4), halo 16, its frames sharded, against TrainStep
     on the whole frames (the loss within 1e-5 relative, the parameters
     within 1e-6 on at least 99.9% of elements and within 2 lr everywhere);
 10. the op library on partitioned frames: every name of ops.__all__ and the
     grid sample and replication pad layers, float32, B = 2, 768x1344, on
     the (data 1, tile 4) and (1, 2, 2) grids, halo 64, on phase 8's +-20 px
     flow and (the ops with no halo budget) a +-200 px one, each against the
     same op untiled on the card: where nothing lands or lands outside
     exactly, the outputs and the VJP of a seeded cotangent within 1e-4 of
     their scale; launches per call exact (N7 and N8: one K2 payload entry
     on tile origins and one K3 carry entry, the grid sample one K5 general
     entry, the filter warps one K1 tile entry, flow_project one K2 tile
     entry and one K3 carry entry, nothing else), and the whole-level
     gathers and reductions of the forward and the backward; the tiled fill
     of flow_project, N7 and N8 at most 2 device operations from avg, cnt
     (counted where the profiler keeps the records, at least once);
     for the +-20 px flow each op's device ms and device operations from one
     profiled call (N7 and N8 at most 30: no payload built in PyTorch), the
     gathers' and reductions' device ms and the peak memory, beside the
     untiled op's; then K3's tile entry and K2's payload entries, recorded
     through phases 9-10 (phase 8 holds its own), held against their plain
     versions at every shape those phases launched them at, bf16 and
     float32.
Prints a JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.  Long output (the kernels' build
log, the full results) goes to chiprun_out/chip_smoke/.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")
H, W = 768, 1344            # 1280x720 padded (data/padding.py)
FRAME_H, FRAME_W = 720, 1280
SERVED = (("MEMC_Net_star", 3), ("MEMC_Net_s", 3), ("MEMC_Net", 1))  # (model, pairs)
# MEMC_Net_VE: the Vimeo-90K window of the reference's VE demo (cli/demo_vimeo_ve.py),
# seven 256x448 frames padded to 320x512
VE_FRAME_H, VE_FRAME_W = 256, 448
VE_H, VE_W = 320, 512
VE_WINDOWS = 3
# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
# float32: CUDA cores; tf32x3: float32 products as three TF32 passes on the
# tensor cores (495 TFLOP/s), K4's float32 body
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
# launches per served frame in bf16 (SPyNet: 6 levels of 5 convs and 1 warp at 720p)
EXPECTED_PER_FRAME = {
    "MEMC_Net_star": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 1,
                      "conv2d_small": 1, "grid_sample": 0},
    "MEMC_Net_s": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 1,
                   "conv2d_small": 30, "grid_sample": 6},
    "MEMC_Net": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 1,
                 "conv2d_small": 0, "grid_sample": 0},
    # per seven-frame window: one 6B split warp, one 7B ctx conv, no projection
    "MEMC_Net_VE": {"filter_interp_warp": 1, "base_scatter": 0, "fill_holes": 0,
                    "conv2d_small": 1, "grid_sample": 0},
}
# K4 launches that the spec walkers (models/mononet.py) add to a served float32
# MEMC_Net_s frame: every 3x3 conv of its thin MonoNet5 trunk (12), two filter
# branches (2 x 2) and RectifyNet (8) on K4's float32 body; in bf16 and in train
# steps they run F.conv2d
S_WALKER_F32_K4 = 24


TPU_KERNELS = {
    "filter_interp_warp": ("memcnet_tpu_torch/csrc/warp.cu",
                           "memcnet_tpu/ops/pallas/warp_kernel.py:827"),
    "base_scatter": ("memcnet_tpu_torch/csrc/project.cu",
                     "memcnet_tpu/ops/pallas/scatter_kernel.py:156"),
    "fill_holes": ("memcnet_tpu_torch/csrc/project.cu",
                   "memcnet_tpu/ops/pallas/fill_kernel.py:114"),
    "conv2d_small": ("memcnet_tpu_torch/csrc/conv.cu",
                     "memcnet_tpu/ops/pallas/conv_kernel.py:119"),
    "grid_sample": ("memcnet_tpu_torch/csrc/gather.cu",
                    "memcnet_tpu/ops/pallas/gather_kernel.py:135"),
}

# the tile entries (phase 8): no launch on any earlier path
TILE_COUNTERS = {"filter_interp_warp_tile": 0, "base_scatter_tile": 0, "fill_holes_carry": 0,
                 "level_input_tile": 0,
                 "base_scatter_payload_tile": 0}
TILE_ENTRIES = {
    "filter_interp_warp_tile": ("memcnet_tpu_torch/csrc/warp.cu",
                                "memcnet_tpu/ops/pallas/warp_kernel.py:827",
                                "memcnet_tpu/parallel/tiling.py:51 (_local_filter_interp)"),
    "base_scatter_tile": ("memcnet_tpu_torch/csrc/project.cu",
                          "memcnet_tpu/ops/pallas/scatter_kernel.py:156",
                          "memcnet_tpu/parallel/tiling.py:187-222 (tiled_flow_project's scatter)"),
    "fill_holes_carry": ("memcnet_tpu_torch/csrc/project.cu",
                         "memcnet_tpu/ops/pallas/fill_kernel.py:114",
                         "memcnet_tpu/parallel/tiling.py:236-289 (_tiled_fill, chained_scan)"),
}
TILE_ENTRY_NAMES = {"filter_interp_warp_tile": "memc_filter_interp_warp_tile",
                    "base_scatter_tile": "memc_project_tile_sums",
                    "fill_holes_carry": "memc_project_fill_tiles"}

# the ShapeRecorder rows of phases 9-10: K3's tile entry, K2's payload entries
PARALLEL_SHAPE_ROWS = ("fill_tiles", "payload", "payload_tile")
# the ShapeRecorder rows (phase 5) that hold each kernel of the line; K3
# runs in flow_project with the fill
DEMO_SHAPE_ROWS = {"filter_interp_warp": ("filter_interp_warp",),
                   "base_scatter": ("flow_project",), "fill_holes": ("flow_project",),
                   "conv2d_small": ("conv2d_small",),
                   "grid_sample": ("spynet_level_input", "grid_sample")}


class CheckFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def gpu_name_and_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


FILL_OPS_MAX = 2  # the tiled fill, from avg, cnt to the filled tiles


def fill_count(torch, fn, what):
    """The tiled fill's device operations, counted as CUDA-graph nodes
    (``probe.graph_ops``, which loses none) and held at 1 to FILL_OPS_MAX,
    with its device ms and kernels from the profiler where that kept every
    record (else None: not measured)."""
    from memcnet_tpu_torch.probe import device_ops, graph_ops

    n = graph_ops(fn)
    if not 1 <= n <= FILL_OPS_MAX:
        raise CheckFailed(f"{what}: {n} device operations from avg, cnt to the filled tiles, "
                          f"1 to {FILL_OPS_MAX}")
    kept, ms, by_kernel = device_ops(fn)
    whole = kept == n
    return dict(device_ops=n, device_ms=ms if whole else None,
                by_kernel=by_kernel if whole else None)


def timed_ms(torch, fn, reps=10, flush=None):
    """Median device time of one call, each run after an L2 flush (the 50 MB
    L2 is overwritten by ``flush``)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def bf16_ulps(got, ref, slack=0.0):
    """Largest |got - ref| - slack in bf16 units in the last place of each
    reference value (with no slack a zero reference must be matched exactly)."""
    import torch

    r = ref.float().abs()
    e = torch.floor(torch.log2(torch.where(r > 0, r, torch.ones_like(r))))
    ulp = torch.where(r > 0, torch.exp2(e - 7), torch.full_like(r, 2.0 ** -133))
    return float((((got.float() - ref.float()).abs() - slack).clamp(min=0.0) / ulp).max())


def compare(pairs, f32_atol, long_sums=False):
    """(max_abs_err, measure, limit, rule) over (kernel, plain) pairs.
    float32: max |kernel - plain| <= f32_atol (the same float32 arithmetic
    summed in another order).  bf16: both sides sum in float32 in different
    orders and round once to bf16, so a rounding may flip: at most 2 bf16
    units in the last place of each plain value.  With ``long_sums`` (K4's
    thousands of terms, which may cancel to near zero) the float32 sums may
    differ by f32_atol before that rounding: at most 2 ulps beyond f32_atol."""
    import torch

    err = max(max_err(g, r) for g, r in pairs)
    if pairs[0][1].dtype == torch.float32:
        return err, err, f32_atol, f"max abs err <= {f32_atol:.3g}"
    slack = f32_atol if long_sums else 0.0
    ulps = max(bf16_ulps(g, r, slack) for g, r in pairs)
    if long_sums:
        return err, ulps, 2.0, f"<= 2 bf16 ulps of each plain value beyond {f32_atol:.3g}"
    return err, ulps, 2.0, "<= 2 bf16 ulps of each plain value"


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_op(dtype_name):
    """The operations' type K4 runs in: float32 as three TF32 passes."""
    return "tf32x3" if dtype_name == "float32" else dtype_name


def k4_extra(dtype_name, nbytes, flops):
    """A float32 K4 row's second bound: the same work on the CUDA cores."""
    if dtype_name != "float32":
        return None
    b_ms, b_by = bound(nbytes, flops, "float32")
    return dict(bound_cuda_cores_ms=b_ms, bound_cuda_cores_by=b_by)


def check_projection_exact(torch, what, S, S_ref, masks, masks_ref):
    """The projection's counts (the last plane of S, base and folded) and its
    has-value masks are sums of 1.0 (or of quarters) and bits: the kernel
    must match its plain version exactly."""
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    if not torch.equal(S[:, -1], S_ref[:, -1]) or not torch.equal(
            P.fold(S)[:, -1], P.fold(S_ref)[:, -1]):
        raise CheckFailed(f"{what}: counts differ from the plain version")
    for name, m, r in zip(masks._fields, masks, masks_ref):
        if not torch.equal(m, r):
            raise CheckFailed(f"{what}: mask {name} differs from the plain version")


def record_row(rows, name, dtype, check, k_ms, p_ms, lib_ms, nbytes, flops, op_dtype,
               extra=None):
    """Log one kernel row (its check against the plain version, its ms,
    the plain version's, the library call's and its bound) into ``rows``;
    raise if the check failed."""
    err, measure, limit, rule = check
    b_ms, b_by = bound(nbytes, flops, op_dtype)
    ok = bool(measure <= limit)
    rows.setdefault(name, {})[dtype] = dict(
        max_abs_err=err, check=rule, check_value=measure, ok=ok, ms=k_ms, plain_ms=p_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
        **(extra or {}))
    def ms(v):
        return "-" if v is None else f"{v:.4f} ms"

    log(f"  {name:<19} {dtype:<8} max_abs_err {err:.3e} [{rule}: {measure:.3g}] "
        f"{'ok' if ok else 'FAIL'}  kernel {ms(k_ms)}  plain {ms(p_ms)}  "
        f"library {ms(lib_ms)}  bound {b_ms:.4f} ms ({b_by})")
    if not ok:
        raise CheckFailed(f"{name} {dtype}: kernel disagrees with its plain version "
                          f"({rule}: {measure})")


def phase_kernels(torch, results):
    import torch.nn.functional as F

    from memcnet_tpu_torch.models import spynet
    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.probe import device_ops, level_flow, level_prologue, synthetic_flow

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def record(*args, **kw):
        record_row(rows, *args, **kw)

    flow2 = synthetic_flow(2, dev)  # both directions, f32
    for dtype_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        esize = torch.tensor([], dtype=dt).element_size()
        # in bf16 serving the flows are bf16 activations: the projection reads
        # them in their type, K1 and K5 take them as float32
        flow_dt = flow2.to(dt)
        flow = flow_dt.float()
        B = flow.shape[0]
        HW = H * W

        # --- K2: memset, scatter and fold-and-divide of both directions' flows
        S, avg, masks = P.launch_sums(flow_dt, True)
        S_ref, avg_ref, masks_ref = P.sums_stage_reference(flow_dt, True)
        check_projection_exact(torch, f"base_scatter {dtype_name}", S, S_ref, masks, masks_ref)
        valid, ixL, iyT = P.landing_cells(flow)
        payload = torch.where(valid[:, None], torch.cat([-flow, torch.ones_like(flow[:, :1])], 1),
                              0.0).contiguous()
        lin64 = torch.where(valid, iyT * W + ixL, 0).long().view(B, 1, HW).expand(B, 3, HW)

        def lib_scatter():  # the base scatter alone, as one PyTorch call
            return torch.zeros(B, 3, HW, device=dev).scatter_add_(2, lin64, payload.view(B, 3, HW))

        mask_bytes = 4 * sum(m.numel() for m in masks)
        # float32 sums of up to ~10 values of |f| <= 20 in a run-dependent order
        record("base_scatter", dtype_name, compare([(avg, avg_ref)], 1e-3),
               timed_ms(torch, lambda: P.launch_sums(flow_dt, True), flush=flush),
               timed_ms(torch, lambda: P.sums_stage_reference(flow_dt, True), flush=flush),
               timed_ms(torch, lib_scatter, flush=flush),
               nbytes=B * HW * (2 * esize + 2 * 4) + mask_bytes, flops=0, op_dtype="float32",
               extra=dict(valid_pixels=int(valid.sum())))
        del S, S_ref, avg, masks, payload, lin64

        # --- K3: the fill of the plain stage's average and masks -----------
        holes = int((~P.unpack_bits(masks_ref.rows, W)).sum())
        if holes == 0:
            raise CheckFailed("fill_holes: the synthetic flow left no holes to fill")
        got = P.launch_fill(avg_ref, masks_ref, dt)
        ref = P.fill_stage_reference(avg_ref, masks_ref, dt)
        # every pixel a hole with nothing to find: the searches' worst case
        none = P.pack_masks(torch.zeros((B, H, W), dtype=torch.bool, device=dev))
        zeros = torch.zeros_like(avg_ref)
        if P.launch_fill(zeros, none, dt).any():
            raise CheckFailed(f"fill_holes {dtype_name}: holes with no value became nonzero")
        record("fill_holes", dtype_name, compare([(got, ref)], 1e-5),
               timed_ms(torch, lambda: P.launch_fill(avg_ref, masks_ref, dt), flush=flush),
               timed_ms(torch, lambda: P.fill_stage_reference(avg_ref, masks_ref, dt),
                        flush=flush),
               None, nbytes=B * HW * (2 * 4 + 2 * esize) + mask_bytes, flops=0,
               op_dtype="float32",
               extra=dict(holes=holes, all_holes_ms=timed_ms(
                   torch, lambda: P.launch_fill(zeros, none, dt), flush=flush)))
        del avg_ref, masks_ref, got, ref, zeros

        # --- the whole op, flow_project with the fill, against the plain
        # composition: the smooth flow (the row), +-200 px noise and a flow
        # whose every landing is invalid; and once without the fill
        flows = {"smooth": flow_dt,
                 "pm200": (torch.rand(flow_dt.shape, generator=gen, device=dev) * 400.0
                           - 200.0).to(dt),
                 "all_invalid": torch.full_like(flow_dt, 3.0 * W)}
        extra = {}
        for tag, fl in flows.items():
            for fillhole in (True, False) if tag == "smooth" else (True,):
                got = projection.flow_project(fl, fillhole=fillhole)
                ref = projection.reference(fl, fillhole=fillhole)
                err, measure, limit, rule = compare([(got, ref)], 1e-3)
                n_ops, dev_ms, by_kernel = device_ops(
                    lambda: projection.flow_project(fl, fillhole=fillhole))
                most = 4 if fillhole else 3
                name = f"{tag}{'' if fillhole else ', no fill'}"
                log(f"  flow_project        {dtype_name:<8} {name}: max_abs_err {err:.3e} "
                    f"[{rule}: {measure:.3g}]; device ops per call {n_ops} (at most {most}), "
                    f"device ms {dev_ms:.4f}: "
                    + ", ".join(f"{k[:40]} {v:.4f}" for k, v in by_kernel.items()))
                if not measure <= limit:
                    raise CheckFailed(f"flow_project {dtype_name} {name}: kernel disagrees with "
                                      f"the plain composition ({rule}: {measure})")
                if not 0 < n_ops <= most:
                    raise CheckFailed(f"flow_project {dtype_name} {name}: {n_ops} device "
                                      f"operations per call seen, 1 to {most} expected")
                if tag == "all_invalid" and got.any():
                    raise CheckFailed(f"flow_project {dtype_name}: an all-invalid flow gave "
                                      "nonzero values")
                extra[name] = dict(max_abs_err=err, device_ops=n_ops, device_ms=dev_ms,
                                   device_ms_by_kernel=by_kernel)
                if tag != "smooth":
                    extra[name]["ms"] = timed_ms(
                        torch, lambda: projection.flow_project(fl, fillhole=True), flush=flush)
        record("flow_project", dtype_name, compare([(projection.flow_project(flow_dt, fillhole=True),
                                                     projection.reference(flow_dt, fillhole=True))],
                                                    1e-3),
               timed_ms(torch, lambda: projection.flow_project(flow_dt, fillhole=True), flush=flush),
               timed_ms(torch, lambda: projection.reference(flow_dt, fillhole=True), flush=flush),
               None, nbytes=2 * B * HW * 2 * esize, flops=0, op_dtype="float32",
               extra=dict(device_ops=extra["smooth"]["device_ops"],
                          device_ms=extra["smooth"]["device_ms"], flows=extra))
        del flows, got, ref

        # --- K1 warp of (frame, context) with one direction's flow ----------
        f1 = flow[:1].contiguous()
        frame = torch.rand((1, 3, H, W), generator=gen, device=dev).to(dt)
        ctx = torch.randn((1, 64, H, W), generator=gen, device=dev).to(dt)
        filt = (torch.rand((1, 16, H, W), generator=gen, device=dev) / 8.0).to(dt)
        got = warp_kernel.launch((frame, ctx), f1, filt, 4)
        ref = warp_kernel.reference((frame, ctx), f1, filt, 4)
        nvalid = int(warp_kernel.valid_and_taps(f1, H, W)[0].sum())
        # float32: 16-term sums of values |v| <= ~5
        record("filter_interp_warp", dtype_name, compare(list(zip(got, ref)), 1e-4),
               timed_ms(torch, lambda: warp_kernel.launch((frame, ctx), f1, filt, 4), flush=flush),
               timed_ms(torch, lambda: warp_kernel.reference((frame, ctx), f1, filt, 4),
                        reps=3, flush=flush),
               None,
               nbytes=H * W * ((3 + 64 + 16) * esize + 2 * 4 + (3 + 64) * esize),
               flops=nvalid * 2 * 16 * 67, op_dtype="float32",  # float32 FMAs
               extra=dict(valid_pixels=nvalid))

        # --- K4 ctx conv 3 -> 64, 7x7, no bias ------------------------------
        x = (torch.rand((2, 3, H, W), generator=gen, device=dev) * 4.0 - 2.0).to(dt)
        w = I.resnet_msra((64, 3, 7, 7), torch.Generator().manual_seed(1)).to(dev).to(dt)
        got = conv_kernel.launch(x, w, None)
        ref = conv_kernel.reference(x, w, None)
        # float32: 147-term sums of |x w| <= ~1
        record("conv2d_small", dtype_name, compare([(got, ref)], 1e-4),
               timed_ms(torch, lambda: conv_kernel.launch(x, w, None), flush=flush),
               timed_ms(torch, lambda: conv_kernel.reference(x, w, None), flush=flush),
               timed_ms(torch, lambda: F.conv2d(x, w, None, padding=3), flush=flush),
               nbytes=2 * H * W * (3 + 64) * esize + w.numel() * esize,
               flops=2 * 2 * H * W * 64 * 3 * 49, op_dtype=k4_op(dtype_name),
               extra=k4_extra(dtype_name, 2 * H * W * (3 + 64) * esize + w.numel() * esize,
                              2 * 2 * H * W * 64 * 3 * 49))
        del frame, ctx, filt, got, ref

        # --- MEMC_Net_VE's shapes (320x512): K1 over one window's six
        # neighbours with their contexts, on the smooth flow and on +-20 px
        # noise (source boxes too wide for shared memory: the global-gather
        # path); K4 ctx over the window's seven frames.  Rows "...[ve <tag>]"
        vframe = torch.rand((6, 3, VE_H, VE_W), generator=gen, device=dev).to(dt)
        vctx = torch.randn((6, 64, VE_H, VE_W), generator=gen, device=dev).to(dt)
        vfilt = (torch.rand((6, 16, VE_H, VE_W), generator=gen, device=dev) / 8.0).to(dt)
        noise = torch.rand((6, 2, VE_H, VE_W), generator=gen, device=dev) * 40.0 - 20.0
        for tag, vflow in (("smooth", synthetic_flow(6, dev, size=(VE_H, VE_W))),
                           ("pm20", noise)):
            vflow = vflow.to(dt).float()  # a bf16 activation in bf16 serving
            got = warp_kernel.launch((vframe, vctx), vflow, vfilt, 4)
            ref = warp_kernel.reference((vframe, vctx), vflow, vfilt, 4)
            nvalid = int(warp_kernel.valid_and_taps(vflow, VE_H, VE_W)[0].sum())
            record(f"filter_interp_warp[ve {tag}]", dtype_name, compare(list(zip(got, ref)), 1e-4),
                   timed_ms(torch, lambda: warp_kernel.launch((vframe, vctx), vflow, vfilt, 4),
                            flush=flush),
                   timed_ms(torch, lambda: warp_kernel.reference((vframe, vctx), vflow, vfilt, 4),
                            reps=3, flush=flush),
                   None,
                   nbytes=6 * VE_H * VE_W * ((3 + 64 + 16) * esize + 2 * 4 + (3 + 64) * esize),
                   flops=nvalid * 2 * 16 * 67, op_dtype="float32",
                   extra=dict(valid_pixels=nvalid, shape=f"6x(3+64)x{VE_H}x{VE_W}"))
            del got, ref
        x = (torch.rand((7, 3, VE_H, VE_W), generator=gen, device=dev) * 4.0 - 2.0).to(dt)
        w = I.resnet_msra((64, 3, 7, 7), torch.Generator().manual_seed(1)).to(dev).to(dt)
        got = conv_kernel.launch(x, w, None)
        ref = conv_kernel.reference(x, w, None)
        record("conv2d_small[ve ctx]", dtype_name, compare([(got, ref)], 1e-4),
               timed_ms(torch, lambda: conv_kernel.launch(x, w, None), flush=flush),
               timed_ms(torch, lambda: conv_kernel.reference(x, w, None), flush=flush),
               timed_ms(torch, lambda: F.conv2d(x, w, None, padding=3), flush=flush),
               nbytes=7 * VE_H * VE_W * (3 + 64) * esize + w.numel() * esize,
               flops=2 * 7 * VE_H * VE_W * 64 * 3 * 49, op_dtype=k4_op(dtype_name),
               extra=dict(shape=f"7x3x{VE_H}x{VE_W}"))
        del vframe, vctx, vfilt, noise, x, w, got, ref

        # --- K5 grid sample of SPyNet's top level: x (2, 3, H, W) and the
        # float32 grid _backward_warp builds from both directions' flows
        x = torch.rand((2, 3, H, W), generator=gen, device=dev).to(dt)
        grid = spynet.warp_grid(flow).contiguous()
        got = gather_kernel.launch(x, grid)
        ref = gather_kernel.reference(x, grid)

        def lib_gs():
            return F.grid_sample(x, grid.to(dt), mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        if dt == torch.float32:  # a second oracle, in float32 only
            lib_err = max_err(got, lib_gs())
            log(f"  grid_sample         float32  vs F.grid_sample: max_abs_err {lib_err:.3e} "
                f"(tol 1e-5)")
            if not lib_err <= 1e-5:
                raise CheckFailed(f"grid_sample float32 disagrees with F.grid_sample ({lib_err})")
        zero_px = int((ref == 0).all(dim=1).sum())
        # float32: 4-term sums of values in [0, 1)
        record("grid_sample", dtype_name, compare([(got, ref)], 1e-5),
               timed_ms(torch, lambda: gather_kernel.launch(x, grid), flush=flush),
               timed_ms(torch, lambda: gather_kernel.reference(x, grid), flush=flush),
               timed_ms(torch, lib_gs, flush=flush),
               nbytes=2 * H * W * (3 * esize + 2 * 4 + 3 * esize),
               flops=2 * H * W * 3 * 4 * 2, op_dtype="float32",
               extra=dict(zero_pixels=zero_px))
        del x, grid, got, ref

        # --- K5 fused: SPyNet's level input at each level of the 720p
        # pyramid, B = 2, the coarse flow of probe.level_flow (+-20 px, blocks
        # landing outside the frame).  fst and up must equal the plain
        # composition's bit for bit; the warp is held against the plain grid
        # sample of the kernel's own up.  The top level, checked last, is the
        # row, timed beside the separate ops it replaced (stock-op grid, K5,
        # cat: the "parent prologue")
        levels = []
        for lvl in reversed(range(spynet.LEVELS)):
            h, w_ = H >> lvl, W >> lvl
            fst, snd = (torch.rand((2, 3, h, w_), generator=gen, device=dev).to(dt)
                        for _ in range(2))
            cflow = level_flow(2, lvl, dev).to(dt)
            got = gather_kernel.launch_level_input(fst, snd, cflow)
            ref = gather_kernel.level_input_reference(fst, snd, cflow)
            for part, sl in (("fst", slice(0, 3)), ("up", slice(6, 8))):
                n_bad = int((got[:, sl] != ref[:, sl]).sum())
                if n_bad:
                    raise CheckFailed(f"spynet_level_input {dtype_name} {h}x{w_}: {n_bad} {part} "
                                      "values differ from the plain version")
            want = gather_kernel.reference(snd, gather_kernel.warp_grid(got[:, 6:8]))
            # float32: 4-term sums of values in [0, 1)
            check = compare([(got[:, 3:6], want)], 1e-5)
            levels.append(dict(shape=f"{h}x{w_}", max_abs_err=check[0], check_value=check[1],
                               off_frame_px=int((want == 0).all(dim=1).sum())))
            log(f"  spynet_level_input  {dtype_name:<8} {h}x{w_}: fst, up exact; warp "
                f"max_abs_err {check[0]:.3e} [{check[3]}: {check[1]:.3g}]")
            if not check[1] <= check[2]:
                raise CheckFailed(f"spynet_level_input {dtype_name} {h}x{w_}: the warp disagrees "
                                  f"with the plain grid sample ({check[3]}: {check[1]})")
            del got, ref, want
        n_ops = device_ops(lambda: gather_kernel.launch_level_input(fst, snd, cflow))
        n_old = device_ops(lambda: level_prologue(fst, snd, cflow))
        if n_ops[0] != 1:
            raise CheckFailed(f"spynet_level_input {dtype_name}: {n_ops[0]} device operations "
                              "per call, 1 expected")
        record("spynet_level_input", dtype_name, check,
               timed_ms(torch, lambda: gather_kernel.launch_level_input(fst, snd, cflow),
                        flush=flush),
               timed_ms(torch, lambda: gather_kernel.level_input_reference(fst, snd, cflow),
                        flush=flush),
               None, nbytes=2 * (2 * (H // 2) * (W // 2) + (3 + 3 + 8) * H * W) * esize,
               # per pixel: 2 x 6 for the upsample, 8 for the grid, 3 x 8 for the taps
               flops=2 * H * W * 44, op_dtype="float32",
               extra=dict(device_ops=n_ops[0], device_ms=n_ops[1], levels=levels,
                          parent_prologue=dict(
                              ms=timed_ms(torch, lambda: level_prologue(fst, snd, cflow),
                                          flush=flush),
                              device_ops=n_old[0], device_ms=n_old[1], by_kernel=n_old[2])))
        log(f"  spynet_level_input  {dtype_name:<8} device ops {n_ops[0]}, device ms "
            f"{n_ops[1]:.4f}; parent prologue: {n_old[0]} device ops, device ms {n_old[1]:.4f}, "
            f"{rows['spynet_level_input'][dtype_name]['parent_prologue']['ms']:.4f} ms")
        del fst, snd, cflow
        level_input_tile_rows(torch, rows, dt, dtype_name, gen, flush)
        payload_tile_rows(torch, rows, dt, dtype_name, flush)

        # --- K4 at each conv of every SPyNet level: B = 2, 7x7, bias, ReLU on
        # the first four; torch-0.2 default weights.  The top level keeps its
        # row names; level l (l = 1..5, 2**l times smaller) is tagged "L<l>".
        wgen = torch.Generator().manual_seed(2)
        for lvl in range(spynet.LEVELS):
            h, w_ = H >> lvl, W >> lvl
            tag = "" if lvl == 0 else f"L{lvl} {h}x{w_} "
            for j, (cin, cout) in enumerate(spynet.BASIC):
                relu = j < len(spynet.BASIC) - 1
                x = (torch.rand((2, cin, h, w_), generator=gen, device=dev) * 4.0 - 2.0).to(dt)
                w = I.torch_default_uniform((cout, cin, 7, 7), wgen).to(dev).to(dt)
                b = I.torch_default_uniform((cout,), wgen, fan_in=cin * 49).to(dev)
                got = conv_kernel.launch(x, w, b, relu=relu)
                ref = conv_kernel.reference(x, w, b, relu=relu)

                def lib_conv():
                    out = F.conv2d(x, w, b.to(dt), padding=3)
                    return out.clamp_(min=0.0) if relu else out

                # float32: up to 3,136-term sums of |x w| <= 2 / sqrt(fan_in)
                record(f"conv2d_small[spynet {tag}{cin}->{cout}]", dtype_name,
                       compare([(got, ref)], 5e-4, long_sums=True),
                       timed_ms(torch, lambda: conv_kernel.launch(x, w, b, relu=relu),
                                flush=flush),
                       timed_ms(torch, lambda: conv_kernel.reference(x, w, b, relu=relu),
                                reps=10 if lvl == 0 else 5, flush=flush),
                       timed_ms(torch, lib_conv, flush=flush),
                       nbytes=2 * h * w_ * (cin + cout) * esize + w.numel() * esize + 4 * cout,
                       flops=2 * 2 * h * w_ * cout * cin * 49, op_dtype=k4_op(dtype_name),
                       extra=k4_extra(dtype_name, 2 * h * w_ * (cin + cout) * esize
                                      + w.numel() * esize + 4 * cout,
                                      2 * 2 * h * w_ * cout * cin * 49))
                del x, w, b, got, ref
        torch.cuda.empty_cache()
    results["kernels"] = rows


def synthetic_frames(seed):
    """A textured 1280x720 frame and the same scene moved a few pixels."""
    from memcnet_tpu_torch.probe import texture

    rng = np.random.RandomState(seed)
    img = texture(rng, FRAME_H + 40, FRAME_W + 40)
    dx, dy = rng.randint(2, 12), rng.randint(2, 8)
    x0 = img[:, 20:20 + FRAME_H, 20:20 + FRAME_W]
    x2 = img[:, 20 + dy:20 + dy + FRAME_H, 20 + dx:20 + dx + FRAME_W]
    return np.ascontiguousarray(x0), np.ascontiguousarray(x2)


def synthetic_window(seed, h=VE_FRAME_H, w=VE_FRAME_W):
    """Seven textured h x w frames of one scene: the center (frame 3) and six
    neighbours, each moved 2-12 px across and 0-8 px down or up from it."""
    from memcnet_tpu_torch.probe import texture

    rng = np.random.RandomState(100 + seed)
    img = texture(rng, h + 40, w + 40)
    frames = []
    for t in range(7):
        dx, dy = 0, 0
        if t != 3:
            dx = rng.randint(2, 13) * rng.choice((-1, 1))
            dy = rng.randint(0, 9) * rng.choice((-1, 1))
        frames.append(np.ascontiguousarray(img[:, 20 + dy:20 + dy + h, 20 + dx:20 + dx + w]))
    return frames


def offset_spynet(torch, model):
    """Scale SPyNet's last convs and give them a constant bias, so the flow of
    a 128x128 input sits near (0.7, 0.42) px: far from the integer cell
    boundaries where the projection and the warp are discontinuous and the
    card and the CPU, summing in other orders, could land in other cells."""
    with torch.no_grad():
        for basic in model.flownets.moduleBasic:
            last = basic.moduleBasic[8]
            last.weight.mul_(0.02)
            last.bias.copy_(torch.tensor([0.1, 0.06]))
    return model


def small_pair_check(torch, name):
    """A small float32 pair: the card's path against the CPU plain path,
    same weights."""
    from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model

    rng = np.random.RandomState(1)
    a = rng.rand(3, 100, 120).astype(np.float32)
    b = np.roll(a, (2, 3), axis=(1, 2))
    outs = []
    for dev in ("cpu", "cuda"):
        model = build_model(name, seed=0, device=dev)
        if name == "MEMC_Net_s":
            offset_spynet(torch, model)
        outs.append(PaddedInterp(model, device=dev)(a, b)[0])
    err = float(np.abs(outs[1] - outs[0]).max())
    log(f"  {name} small pair f32, card vs CPU plain path: max_abs_err {err:.3e} (tol 1e-3)")
    if not (err <= 1e-3):
        raise CheckFailed(f"{name}: served output on the card disagrees with the CPU path ({err})")
    return err


def phase_serve(torch, name, n_pairs, results):
    """Serve ``n_pairs`` synthetic 1280x720 pairs in bf16 through PaddedInterp,
    the launch counts set to 0 just before and read just after."""
    from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model
    from memcnet_tpu_torch.ops import cuda as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small_err = small_pair_check(torch, name)

    t0 = time.perf_counter()
    model = build_model(name, seed=0, dtype=torch.bfloat16, device="cuda")
    interp = PaddedInterp(model, dtype=torch.bfloat16, device="cuda")
    log(f"  build_model {name} bf16: {time.perf_counter() - t0:.2f} s")
    pairs = [synthetic_frames(s) for s in range(n_pairs)]
    interp(*pairs[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()

    K.reset_counters()
    ms = []
    outs = []
    for x0, x2 in pairs:
        t0 = time.perf_counter()
        out, aux = interp(x0, x2)   # returns host arrays: the work has finished
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((out, aux))
    counts = K.launch_counts()
    log(f"  {name}: served {n_pairs} pairs: ms/frame {', '.join(f'{m:.3f}' for m in ms)}; "
        f"launches {counts}")
    for kname, per in {**TILE_COUNTERS, **EXPECTED_PER_FRAME[name]}.items():
        if counts[kname] != per * n_pairs:
            raise CheckFailed(f"{name}: {kname} launched {counts[kname]} times in {n_pairs} "
                              f"frames, expected {per * n_pairs}")
    for out, aux in outs:
        if out.shape != (3, FRAME_H, FRAME_W) or not np.isfinite(out).all():
            raise CheckFailed(f"{name} served output: shape {out.shape}, "
                              f"finite {np.isfinite(out).all()}")
        if aux["offsets"][0].shape != (2, FRAME_H, FRAME_W):
            raise CheckFailed(f"{name} offsets shape {aux['offsets'][0].shape}")
    results.setdefault("serve", {})[name] = dict(
        ms_per_frame=ms, launches=counts, small_pair_err=small_err,
        out_dtype=str(interp.last_out_dtype))
    return model, pairs[0]


def small_window_check(torch):
    """A small float32 window (100x120, padded to 128x128): the card's path
    against the CPU plain path, same weights, within 1e-3 of the output's
    scale (random kaiming weights put the output in the thousands)."""
    from memcnet_tpu_torch.cli.runner import PaddedVE, build_model

    frames = synthetic_window(7, 100, 120)
    outs = [PaddedVE(build_model("MEMC_Net_VE", seed=0, device=dev), device=dev)(frames)
            for dev in ("cpu", "cuda")]
    scale = max(1.0, float(np.abs(outs[0]).max()))
    err = float(np.abs(outs[1] - outs[0]).max())
    log(f"  MEMC_Net_VE small window f32, card vs CPU plain path: max_abs_err {err:.3e} "
        f"(tol 1e-3 x {scale:.4g})")
    if not (err <= 1e-3 * scale):
        raise CheckFailed(f"MEMC_Net_VE: served output on the card disagrees with the CPU path "
                          f"({err} at scale {scale})")
    return err


def phase_serve_ve(torch, results):
    """Serve VE_WINDOWS synthetic seven-frame 256x448 windows in bf16 through
    PaddedVE, the launch counts set to 0 just before and read just after."""
    from memcnet_tpu_torch.cli.runner import PaddedVE, build_model
    from memcnet_tpu_torch.data import pad_plan
    from memcnet_tpu_torch.ops import cuda as K

    name = "MEMC_Net_VE"
    left, right, top, bottom = pad_plan(VE_FRAME_H, VE_FRAME_W)
    if (VE_FRAME_H + top + bottom, VE_FRAME_W + left + right) != (VE_H, VE_W):
        raise CheckFailed(f"{name}: {VE_FRAME_W}x{VE_FRAME_H} pads to "
                          f"{VE_FRAME_W + left + right}x{VE_FRAME_H + top + bottom}")
    small_err = small_window_check(torch)

    t0 = time.perf_counter()
    model = build_model(name, seed=0, dtype=torch.bfloat16, device="cuda")
    serve = PaddedVE(model, dtype=torch.bfloat16, device="cuda")
    log(f"  build_model {name} bf16: {time.perf_counter() - t0:.2f} s")
    windows = [synthetic_window(s) for s in range(VE_WINDOWS)]
    serve(windows[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()

    K.reset_counters()
    ms = []
    outs = []
    for frames in windows:
        t0 = time.perf_counter()
        outs.append(serve(frames))  # a host array: the work has finished
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    log(f"  {name}: served {VE_WINDOWS} windows: ms/window {', '.join(f'{m:.3f}' for m in ms)}; "
        f"launches {counts}")
    for kname, per in {**TILE_COUNTERS, **EXPECTED_PER_FRAME[name]}.items():
        if counts[kname] != per * VE_WINDOWS:
            raise CheckFailed(f"{name}: {kname} launched {counts[kname]} times in {VE_WINDOWS} "
                              f"windows, expected {per * VE_WINDOWS}")
    for out in outs:
        if out.shape != (3, VE_FRAME_H, VE_FRAME_W) or not np.isfinite(out).all():
            raise CheckFailed(f"{name} served output: shape {out.shape}, "
                              f"finite {np.isfinite(out).all()}")
    results.setdefault("serve", {})[name] = dict(
        ms_per_frame=ms, launches=counts, small_window_err=small_err,
        out_dtype=str(serve.last_out_dtype))
    return model, windows[0]


def spynet_ops(torch, net, x0, x2):
    """SPyNet's forward alone at 720p, B = 2 (both directions, as MEMC_Net_s
    batches them): device operations and device ms (torch.profiler) and
    time (CUDA events); then the same forward with the separate ops around
    K5 that the fused level input replaced."""
    from memcnet_tpu_torch.ops.cuda import gather_kernel
    from memcnet_tpu_torch.probe import device_ops, level_prologue

    first, second = torch.cat([x0, x2]), torch.cat([x2, x0])
    out = {}
    fused = gather_kernel.level_input
    for tag, fn in (("fused", fused), ("parent_prologue", level_prologue)):
        gather_kernel.level_input = fn  # SPyNet.forward looks it up at each level
        try:
            with torch.inference_mode():
                n_ops, dev_ms, _ = device_ops(lambda: net(first, second))
                ms = timed_ms(torch, lambda: net(first, second), reps=5)
        finally:
            gather_kernel.level_input = fused
        out[tag] = dict(device_ops=n_ops, device_ms=dev_ms, ms=ms)
        log(f"  SPyNet forward alone, B=2 bf16, {tag} level input: {n_ops} device ops, "
            f"device ms {dev_ms:.3f}, {ms:.3f} ms")
    return out


def stage(torch, stages, name, fn):
    """Run one host stage of a served frame and record its host ms (each
    stage ends in a synchronise)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = (time.perf_counter() - t0) * 1e3
    return out


def profile_forward(torch, name, fwd, results, dtype_name="bf16"):
    """The model forward alone (CUDA events, no host copies) and its kernels
    by device time (torch.profiler), with the device's idle share over the
    profiled forward."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fwd_ms = timed_ms(torch, fwd, reps=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    cuda_kind = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == cuda_kind and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "memc::" in r[0])  # csrc/*.cu namespace
    log(f"  {name} forward alone ({dtype_name}, device time, 5 runs median): {fwd_ms:.3f} ms; profiled "
        f"forward: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}; port kernels {ours:.3f} ms")
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        for key, ms_, n in rows:
            f.write(f"{ms_:10.4f} ms {n:5d}x  {key}\n")
    for key, ms_, n in rows[:12]:
        log(f"    {ms_:9.4f} ms {100 * ms_ / max(busy, 1e-9):5.1f}% {n:4d}x  {key[:90]}")
    res = results.setdefault("profile", {})[name] = dict(
        forward_ms=fwd_ms, wall_ms=wall_ms, kernel_ms=busy, port_kernel_ms=ours, top=rows[:25],
        port_kernels=[r for r in rows if "memc::" in r[0]])
    return res


def phase_profile(torch, name, model, pair, results):
    """Where one served frame's time goes: the forward alone and its kernels
    (profile_forward); then one served frame split into its host stages."""
    from memcnet_tpu_torch.data import pad_frame, pad_plan, unpad_frame

    plan = pad_plan(FRAME_H, FRAME_W)
    x0, x2 = (torch.from_numpy(np.ascontiguousarray(pad_frame(f, plan)[None]))
              .to("cuda", torch.bfloat16) for f in pair)
    prof_res = profile_forward(torch, name, lambda: model(x0, x2), results)
    if name == "MEMC_Net_s":
        prof_res["spynet"] = spynet_ops(torch, model.flownets, x0, x2)

    # one served frame stage by stage, as PaddedInterp runs it (host clock)
    stages = {}
    padded = stage(torch, stages, "pad",
                   lambda: [np.ascontiguousarray(pad_frame(f, plan)[None]) for f in pair])
    xs = stage(torch, stages, "to_device",
               lambda: [torch.from_numpy(a).to(device="cuda", dtype=torch.bfloat16)
                        for a in padded])
    with torch.inference_mode():
        (interp, rect), offs, filts, occs = stage(torch, stages, "forward", lambda: model(*xs))
        stage(torch, stages, "to_host",
              lambda: [unpad_frame(t[0].float().cpu().numpy(), plan, FRAME_H, FRAME_W)
                       for t in (rect, interp, *offs, *filts, *occs)])
    log(f"  {name}: one served frame by stage (host ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    prof_res["host_stages_ms"] = stages


def phase_profile_ve(torch, model, frames, results):
    """Where one served VE window's time goes: the forward alone and its
    kernels (profile_forward); then one window split into its host stages,
    as PaddedVE runs it (seven frames in, the 3-plane center out)."""
    from memcnet_tpu_torch.data import pad_frame, pad_plan, unpad_frame

    name = "MEMC_Net_VE"
    plan = pad_plan(VE_FRAME_H, VE_FRAME_W)
    xs = [torch.from_numpy(np.ascontiguousarray(pad_frame(f, plan)[None]))
          .to("cuda", torch.bfloat16) for f in frames]
    prof_res = profile_forward(torch, name, lambda: model(xs), results)
    del xs
    stages = {}
    padded = stage(torch, stages, "pad",
                   lambda: [np.ascontiguousarray(pad_frame(f, plan)[None]) for f in frames])
    xs = stage(torch, stages, "to_device",
               lambda: [torch.from_numpy(a).to(device="cuda", dtype=torch.bfloat16)
                        for a in padded])
    with torch.inference_mode():
        out = stage(torch, stages, "forward", lambda: model(xs))
        stage(torch, stages, "to_host",
              lambda: unpad_frame(out[0].float().cpu().numpy(), plan, VE_FRAME_H, VE_FRAME_W))
    log(f"  {name}: one served window by stage (host ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    prof_res["host_stages_ms"] = stages


F32_PAIRS = 2                # MEMC_Net_s served in float32, Config's default type
# K4's float32 body (csrc/conv_f32.cu): conv2d_tf32x3_kernel and its small-O
# variant conv2d_tf32x3_taps_kernel
F32_K4_KERNEL = "conv2d_tf32x3"


def phase_serve_f32(torch, results):
    """MEMC_Net_s served in float32, the port's default type (Config.dtype,
    build_model and PaddedInterp), on F32_PAIRS synthetic 1280x720 pairs, the
    counts set to 0 just before and read just after: EXPECTED_PER_FRAME's
    launches with the walkers' float32 K4 added, every K4 launch (54 a frame)
    on the float32 body; its forward
    alone by CUDA events and one profiled forward, with the float32 K4
    body's device ms and launches there; the small float32 pair against the
    CPU path."""
    from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model
    from memcnet_tpu_torch.data import pad_frame, pad_plan
    from memcnet_tpu_torch.ops import cuda as K

    name = "MEMC_Net_s"
    expected = dict(EXPECTED_PER_FRAME[name],
                    conv2d_small=EXPECTED_PER_FRAME[name]["conv2d_small"] + S_WALKER_F32_K4)
    small_err = small_pair_check(torch, name)
    model = build_model(name, seed=0, dtype=torch.float32, device="cuda")
    interp = PaddedInterp(model, dtype=torch.float32, device="cuda")
    pairs = [synthetic_frames(s) for s in range(F32_PAIRS)]
    interp(*pairs[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()

    K.reset_counters()
    ms = []
    outs = []
    for x0, x2 in pairs:
        t0 = time.perf_counter()
        outs.append(interp(x0, x2)[0])  # a host array: the work has finished
        ms.append((time.perf_counter() - t0) * 1e3)
    counts, f32 = K.launch_counts(), K.body_counts()["conv2d_small[float32]"]
    log(f"  {name} float32: served {F32_PAIRS} pairs: ms/frame "
        f"{', '.join(f'{m:.3f}' for m in ms)}; launches {counts}, float32 K4 body {f32}")
    for kname, per in {**TILE_COUNTERS, **expected}.items():
        if counts[kname] != per * F32_PAIRS:
            raise CheckFailed(f"{name} float32: {kname} launched {counts[kname]} times in "
                              f"{F32_PAIRS} frames, expected {per * F32_PAIRS}")
    if f32 != expected["conv2d_small"] * F32_PAIRS:
        raise CheckFailed(f"{name} float32: {f32} launches of K4's float32 body in {F32_PAIRS} "
                          f"frames, expected {expected['conv2d_small']} a frame")
    for out in outs:
        if out.shape != (3, FRAME_H, FRAME_W) or not np.isfinite(out).all():
            raise CheckFailed(f"{name} float32 served output: shape {out.shape}, "
                              f"finite {np.isfinite(out).all()}")
    plan = pad_plan(FRAME_H, FRAME_W)
    x0, x2 = (torch.from_numpy(np.ascontiguousarray(pad_frame(f, plan)[None]))
              .to("cuda", torch.float32) for f in pairs[0])
    prof = profile_forward(torch, f"{name}_float32", lambda: model(x0, x2), results,
                           dtype_name="float32")
    k4 = [r for r in prof["port_kernels"] if F32_K4_KERNEL in r[0]]
    k4_ms, k4_n = sum(r[1] for r in k4), sum(r[2] for r in k4)
    log(f"  {name} float32 forward: K4's float32 body {k4_ms:.3f} device ms in {k4_n} launches "
        f"({len(k4)} instances) of {prof['kernel_ms']:.3f} device ms")
    if k4_n != expected["conv2d_small"]:
        raise CheckFailed(f"{name} float32: the profiled forward ran {k4_n} launches of "
                          f"{F32_K4_KERNEL}, expected {expected['conv2d_small']}")
    results["serve_f32"] = dict(
        model=name, ms_per_frame=ms, launches=counts, f32_launches=f32, small_pair_err=small_err,
        forward_ms=prof["forward_ms"], device_ms=prof["kernel_ms"], k4_f32_device_ms=k4_ms,
        k4_f32_profiled_launches=k4_n, out_dtype=str(interp.last_out_dtype))
    del model, interp, x0, x2
    torch.cuda.empty_cache()


# phase 5: the three demos through their main(), at full width, on the card
# by default (no --device); each run's launch counts set to 0 just before it
# and read just after
MB_H, MB_W = 388, 584        # a Middlebury "other" frame (padded to 512x640)
MB_SEQS = 2                  # sequences of the Middlebury run
HD_FRAMES = 8                # --frames 8 of a 9-frame stream: one GOP of 4 pairs
VE_SEQS = 2                  # septuplets of the Vimeo-VE run (--limit 2)
YUV_FRAME_BYTES = FRAME_H * FRAME_W * 3 // 2  # 1,382,400
SMALL_H, SMALL_W = 64, 128   # the card-against-CPU stream


def run_demo(torch, results, path, main, argv, items, expected):
    """``main(argv)`` of one demo with its output kept in
    OUT_DIR/<path>.log; fails unless each kernel launched ``expected[k]``
    times per item in this run alone and the demo printed one
    ": interpolation error / PSNR :" line per item.  Returns (main's
    result, stdout, stderr)."""
    import contextlib
    import io

    from memcnet_tpu_torch.ops import cuda as K

    out, err = io.StringIO(), io.StringIO()
    K.reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = main(argv)
    wall_s = time.perf_counter() - t0
    counts = K.launch_counts()
    with open(os.path.join(OUT_DIR, f"{path}.log"), "w") as f:
        f.write(out.getvalue() + err.getvalue())
    for kname, per in {**TILE_COUNTERS, **expected}.items():
        if counts[kname] != per * items:
            raise CheckFailed(f"{path}: {kname} launched {counts[kname]} times over {items} "
                              f"items, expected {per * items}")
    n_lines = out.getvalue().count(": interpolation error / PSNR :")
    if n_lines != items:
        raise CheckFailed(f"{path}: {n_lines} item lines printed, expected {items}")
    results.setdefault("demos", {})[path] = dict(launches=counts, wall_s=wall_s, items=items)
    return ret, out.getvalue(), err.getvalue()


def stage_timers(path, text):
    """proc and total ms per item, and the item count, of the StageTimers
    summary a demo prints last."""
    import re

    found = re.findall(r"proc ([\d.]+) ms/item, total ([\d.]+) ms/item over (\d+) items", text)
    if not found:
        raise CheckFailed(f"{path}: no StageTimers summary in its output")
    proc, total, n = found[-1]
    return float(proc), float(total), int(n)


def check_finite(path, **values):
    bad = {k: v for k, v in values.items() if not np.all(np.isfinite(v))}
    if bad:
        raise CheckFailed(f"{path}: values not finite: {bad}")


def demo_hd720p_run(torch, results, work, card):
    """MEMC_Net_star in bf16 over a synthetic 1280x720 YUV420 stream of 9
    frames (moving_frames: pairs moved 2-12 px), --frames 8: 4 pairs."""
    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.cli import demo_hd720p

    from memcnet_tpu_torch import native

    src = probe.write_yuv(os.path.join(work, "hd.yuv"),
                          probe.moving_frames(0, HD_FRAMES + 1, FRAME_H, FRAME_W))
    out = os.path.join(work, "hd_out")
    path, pairs = "demo_hd720p", HD_FRAMES // 2
    native_reads = []
    real_read = native.NativeYUVReader.read
    native.NativeYUVReader.read = lambda self, i: native_reads.append(i) or real_read(self, i)
    try:
        (p, s), _, err = run_demo(
            torch, results, path, demo_hd720p.main,
            ["--yuv", src, "--height", str(FRAME_H), "--width", str(FRAME_W),
             "--frames", str(HD_FRAMES), "--out-dir", out,
             "--net-name", "MEMC_Net_star", "--dtype", "bfloat16", "--uid", "smoke"],
            pairs, EXPECTED_PER_FRAME["MEMC_Net_star"])
    finally:
        native.NativeYUVReader.read = real_read
    if len(native_reads) != 3 * pairs:
        raise CheckFailed(f"{path}: {len(native_reads)} reads through NativeYUVReader, expected "
                          f"{3 * pairs}")
    size = os.path.getsize(os.path.join(out, "smoke", "hd.yuv"))
    if size != 2 * pairs * YUV_FRAME_BYTES:
        raise CheckFailed(f"{path}: output stream of {size} bytes, expected "
                          f"{2 * pairs} x {YUV_FRAME_BYTES}")
    logs = {}
    for what in ("psnr", "ssim"):
        logs[what] = np.loadtxt(os.path.join(out, "smoke", f"hd.yuv_{what}_Y.txt"), ndmin=1)
        if logs[what].shape != (pairs,):
            raise CheckFailed(f"{path}: {what} log has {logs[what].shape[0]} lines, expected "
                              f"{pairs}")
    check_finite(path, psnr=p, ssim=s, psnr_log=logs["psnr"], ssim_log=logs["ssim"])
    proc, total, n = stage_timers(path, err)
    log(f"  {path} MEMC_Net_star bf16, {pairs} pairs of 1280x720: proc {proc} ms/item, total "
        f"{total} ms/item over {n} items; PSNR {p}, SSIM {s}; launches "
        f"{results['demos'][path]['launches']}; card {card}")
    results["demos"][path].update(proc_ms=proc, total_ms=total, items_timed=n, psnr=p, ssim=s,
                                  psnr_Y=logs["psnr"].tolist(), ssim_Y=logs["ssim"].tolist(),
                                  out_bytes=size, native_reads=len(native_reads))
    return src


def demo_hd720p_stages(torch, results, src, reps=3):
    """One pair of the HD720p demo stage by stage (host clock, each stage
    synchronised), ``reps`` times after one untimed pair: the loop body of
    demo_hd720p.run, helper by helper in its order (read_triple through the
    native reader the demo uses, and beside it through the numpy YUVRead, to_input,
    the PaddedInterp call, to_uint8_frame, two writes, score_y), and beside
    the PaddedInterp call the same forward copying out its output alone (the
    difference is what the aux dict the demo discards costs)."""
    from memcnet_tpu_torch.cli import demo_hd720p as D
    from memcnet_tpu_torch.cli.runner import PaddedInterp, build_from_config
    from memcnet_tpu_torch.data import YUVRead, YUVWrite, pad_frame, pad_plan, unpad_frame
    from memcnet_tpu_torch.metrics import to_uint8_frame
    from memcnet_tpu_torch.utils.config import Config

    model = build_from_config(Config(net_name="MEMC_Net_star", dtype="bfloat16"))
    fwd = PaddedInterp(model, dtype=torch.bfloat16)
    plan = pad_plan(FRAME_H, FRAME_W)

    def output_only(x0, x2):
        xs = [torch.from_numpy(np.ascontiguousarray(pad_frame(x, plan)[None]))
              .to(fwd.device, torch.bfloat16) for x in (x0, x2)]
        with torch.inference_mode():
            (_, rect), *_ = model(*xs)
            return unpad_frame(rect[0].float().cpu().numpy(), plan, FRAME_H, FRAME_W)

    from memcnet_tpu_torch import native

    reader = YUVRead(src, FRAME_H, FRAME_W)
    nreader = native.NativeYUVReader(src, FRAME_H, FRAME_W, stride=2)
    writer = YUVWrite(os.devnull)
    runs = []
    try:
        for r in range(reps + 1):
            st = {}
            f0, f2, gt = stage(torch, st, "read_triple_native",
                               lambda: D.read_triple(nreader, 0, 2, 1))
            stage(torch, st, "read_triple_numpy", lambda: D.read_triple(reader, 0, 2, 1))
            x0, x2 = stage(torch, st, "to_input", lambda: (D.to_input(f0), D.to_input(f2)))
            out = stage(torch, st, "forward_padded_interp", lambda: fwd(x0, x2)[0])
            stage(torch, st, "forward_output_only", lambda: output_only(x0, x2))
            rec = stage(torch, st, "to_uint8", lambda: to_uint8_frame(out))
            stage(torch, st, "write_x2", lambda: (writer.write(f0), writer.write(rec)))
            stage(torch, st, "score_y", lambda: D.score_y(rec, gt))
            if r:
                runs.append(st)
    finally:
        reader.close()
        nreader.close()
        writer.close()
    for st in runs:
        log("  demo_hd720p one pair by stage (host ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            + f"; aux copies {st['forward_padded_interp'] - st['forward_output_only']:.3f}")
    results["demos"]["demo_hd720p"]["host_stages_ms"] = runs


def demo_middlebury_run(torch, results, work, card):
    """MEMC_Net_s in bf16 on two synthetic 388x584 sequences with ground
    truth: frame10i11.png and its diff image per sequence."""
    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.cli import demo_middlebury
    from memcnet_tpu_torch.io.png import imread

    names = [f"Seq{i}" for i in range(MB_SEQS)]
    data, gt = probe.write_middlebury(os.path.join(work, "mb"), names, MB_H, MB_W)
    out = os.path.join(work, "mb_out")
    path = "demo_middlebury"
    res, _, err = run_demo(
        torch, results, path, demo_middlebury.main,
        ["--data-dir", data, "--gt-dir", gt, "--out-dir", out, "--net-name", "MEMC_Net_s",
         "--dtype", "bfloat16"],
        MB_SEQS, EXPECTED_PER_FRAME["MEMC_Net_s"])
    if [r[0] for r in res] != names:
        raise CheckFailed(f"{path}: results for {[r[0] for r in res]}, expected {names}")
    check_finite(path, ie=[r[1] for r in res], psnr=[r[2] for r in res])
    (uid,) = os.listdir(out)
    for name in names:
        files = sorted(os.listdir(os.path.join(out, uid, name)))
        diffs = [f for f in files if f.startswith("frame10i11_diff")]
        if "frame10i11.png" not in files or len(diffs) != 1:
            raise CheckFailed(f"{path}: {name} holds {files}")
        for f in ("frame10i11.png", diffs[0]):
            shape = imread(os.path.join(out, uid, name, f)).shape
            if shape != (MB_H, MB_W, 3):
                raise CheckFailed(f"{path}: {name}/{f} is {shape}")
    proc, total, n = stage_timers(path, err)
    log(f"  {path} MEMC_Net_s bf16, {MB_SEQS} sequences of {MB_W}x{MB_H}: proc {proc} ms/item, "
        f"total {total} ms/item over {n} items; (IE, PSNR) "
        f"{[(r[1], r[2]) for r in res]}; launches {results['demos'][path]['launches']}; "
        f"card {card}")
    results["demos"][path].update(proc_ms=proc, total_ms=total, items_timed=n,
                                  results=[list(r) for r in res])


def demo_vimeo_ve_run(torch, results, work, card):
    """MEMC_Net_VE in bf16 on two synthetic 256x448 septuplets of the
    denoise task, --limit 2: im4.png per sequence and metrics.txt."""
    import re

    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.cli import demo_vimeo_ve
    from memcnet_tpu_torch.io.png import imread

    root = probe.write_vimeo(os.path.join(work, "vimeo"), VE_SEQS, VE_FRAME_H, VE_FRAME_W)
    out = os.path.join(work, "ve_out")
    path = "demo_vimeo_ve"
    (p, s), stdout, _ = run_demo(
        torch, results, path, demo_vimeo_ve.main,
        ["--root", root, "--out-dir", out, "--task", "denoise", "--limit", str(VE_SEQS),
         "--dtype", "bfloat16"],
        VE_SEQS, EXPECTED_PER_FRAME["MEMC_Net_VE"])
    for i in range(VE_SEQS):
        shape = imread(os.path.join(out, "00001", f"{i + 1:04d}", "im4.png")).shape
        if shape != (VE_FRAME_H, VE_FRAME_W, 3):
            raise CheckFailed(f"{path}: im4.png of sequence {i + 1} is {shape}")
    if not os.path.exists(os.path.join(out, "metrics.txt")):
        raise CheckFailed(f"{path}: no metrics.txt")
    check_finite(path, psnr=p, ssim=s)
    total = float(re.findall(r"\(I/O \+ processing\) : (\S+)", stdout)[-1]) * 1e3
    proc = float(re.findall(r"time \(processing\) : (\S+)", stdout)[-1]) * 1e3
    log(f"  {path} MEMC_Net_VE bf16, {VE_SEQS} windows of {VE_FRAME_W}x{VE_FRAME_H}: proc "
        f"{proc} ms/item, total {total} ms/item (I/O + processing); PSNR {p}, SSIM {s}; "
        f"launches {results['demos'][path]['launches']}; card {card}")
    results["demos"][path].update(proc_ms=proc, total_ms=total, psnr=p, ssim=s)


def demo_card_vs_cpu(torch, results, work):
    """The HD720p demo over one float32 stream of 5 frames at 64x128, with
    --device cuda and with --device cpu: the ground-truth frames of the two
    output streams byte-equal, the reconstructions within 1 level on at most
    0.5% of bytes."""
    import contextlib
    import io

    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.cli import demo_hd720p

    src = probe.write_yuv(os.path.join(work, "small.yuv"),
                          probe.moving_frames(1, 5, SMALL_H, SMALL_W))
    from memcnet_tpu_torch.ops import cuda as K

    streams = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"small_{dev}")
        K.reset_counters()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            demo_hd720p.main(["--yuv", src, "--height", str(SMALL_H), "--width", str(SMALL_W),
                              "--frames", "4", "--out-dir", out, "--net-name", "MEMC_Net_star",
                              "--uid", "u", "--device", dev])
        streams[dev] = np.fromfile(os.path.join(out, "u", "small.yuv"), np.uint8).reshape(4, -1)
        if dev == "cuda":
            counts = K.launch_counts()
    gt_equal = bool(np.array_equal(streams["cuda"][0::2], streams["cpu"][0::2]))
    most, share = probe.levels_apart(streams["cuda"][1::2], streams["cpu"][1::2])
    sat = float(np.mean((streams["cpu"][1::2] == 0) | (streams["cpu"][1::2] == 255)))
    log(f"  demo_hd720p card vs CPU, float32 64x128, 2 pairs: ground truth byte-equal {gt_equal}; "
        f"reconstructions at most {most} level(s) apart on {share:.5f} of bytes (limits 1 and "
        f"0.005); saturated share {sat:.4f}")
    results["demos"]["card_vs_cpu"] = dict(gt_equal=gt_equal, max_levels=most,
                                           share_differing=share, saturated=sat,
                                           launches=counts)
    if not gt_equal or most > 1 or share > 0.005:
        raise CheckFailed("demo_hd720p: the card's output stream disagrees with the CPU's")


class ShapeRecorder:
    """Notes the shapes, types and options of every kernel launch made while
    it is active, by wrapping each kernel's launch function in its wrapper
    module (the functions the autograd.Functions call); it launches nothing
    and leaves the launch counts alone.  ``seen`` maps a kernel to the set
    of its launch signatures."""

    def __init__(self, only=None):
        import inspect

        from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
        from memcnet_tpu_torch.ops.cuda import project_kernel

        def warp(a):
            im = a["images"]
            return (im[0].shape[0], tuple(x.shape[1] for x in im), *im[0].shape[2:],
                    a["filter_size"])

        self.targets = (
            ("filter_interp_warp", warp_kernel, "launch", warp),
            ("flow_project", project_kernel, "_sums",
             lambda a: (*a["flow"].shape, bool(a["fillhole"]))),
            ("conv2d_small", conv_kernel, "launch",
             lambda a: (*a["x"].shape, *a["w"].shape, a["b"] is not None, bool(a["relu"]))),
            ("spynet_level_input", gather_kernel, "launch_level_input",
             lambda a: tuple(a["fst"].shape)),
            ("grid_sample", gather_kernel, "launch",
             lambda a: (*a["x"].shape, *a["grid"].shape[1:3])),
            # K3's tile entry: (n, H, W, the stacked axes, which carries are given)
            ("fill_tiles", project_kernel, "launch_fill_tiles",
             lambda a: (a["avg"].shape[0], *a["avg"].shape[2:], a["stacks"],
                        tuple(a[k] is not None for k in ("left", "right", "up")))),
            # K2's payload entry: (op, flow shape, fill); on tile origins (op, flow
            # shape, samples, frame), its first origins kept
            ("payload", project_kernel, "_payload_sums",
             lambda a: (a["op"], *a["flow"].shape, bool(a["fillhole"]))),
            ("payload_tile", project_kernel, "launch_payload_tile",
             lambda a: (a["op"], *a["flow"].shape, a["samples"], a["H"], a["W"])),
        )
        if only is not None:
            self.targets = tuple(t for t in self.targets if t[0] in only)
        self.seen = {name: set() for name, *_ in self.targets}
        self.calls = {name: 0 for name, *_ in self.targets}
        self.origins = {}  # (name, key) -> the origins of its first launch
        self.saved = []
        self.inspect = inspect

    def __enter__(self):
        for name, mod, attr, key in self.targets:
            fn = getattr(mod, attr)
            sig = self.inspect.signature(fn)

            def wrapped(*args, _fn=fn, _sig=sig, _name=name, _key=key, **kwargs):
                bound = _sig.bind(*args, **kwargs)
                bound.apply_defaults()
                k = _key(bound.arguments)
                self.seen[_name].add(k)
                if "origins" in bound.arguments:
                    self.origins.setdefault((_name, k), bound.arguments["origins"])
                self.calls[_name] += 1
                return _fn(*args, **kwargs)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []


def hold_recorded_shapes(torch, results, seen, tag="demo", origins=None):
    """Each kernel against its plain version at every shape a path (the
    demos, the train steps) launched it at (``ShapeRecorder.seen``), in bf16
    and in float32, on
    synthetic inputs made as in phase 2 and under phase 2's rules: K1 on the
    smooth +-20 px flow with out-of-frame blocks; the projection on that
    flow, +-200 px noise and an all-invalid flow (counts and masks exact);
    K4 with torch-0.2 default weights and bias where the path has a bias
    (SPyNet), MSRA weights where it has none (ctx); K5's level input exact
    in fst and up, its warp against the plain grid sample; K3's tile entry
    on sparse counts (carries from tiles away, rows empty to the frame's
    edge) and on counts whose last column and row are empty, bits and masks
    exact against the tiled fill's plain composition; K2's payload entry
    (N7's depth in quarters, N8's gate at 20/255) on the +-20 px flow, its
    last plane and masks exact, and on tile origins (``origins``: the
    first launch's of each shape), its last plane exact.  Per-shape lines
    go to OUT_DIR/<tag>_shapes.log, the rows to results["<tag>_shapes"]."""
    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.probe import synthetic_flow

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    wgen = torch.Generator().manual_seed(6)

    def rand(*shape, dt, scale=1.0, shift=0.0):
        return (torch.rand(shape, generator=gen, device=dev) * scale + shift).to(dt)

    def warp(dt, B, chans, H, W, fs):
        images = [rand(B, c, H, W, dt=dt) if k == 0 else
                  torch.randn((B, c, H, W), generator=gen, device=dev).to(dt)
                  for k, c in enumerate(chans)]
        flow = synthetic_flow(B, dev, size=(H, W)).to(dt).float()
        filt = rand(B, fs * fs, H, W, dt=dt, scale=1.0 / 8.0)
        got = warp_kernel.launch(images, flow, filt, fs)
        return compare(list(zip(got, warp_kernel.reference(images, flow, filt, fs))), 1e-4)

    def project(dt, B, two, H, W, fillhole):
        smooth = synthetic_flow(B, dev, size=(H, W)).to(dt)
        if fillhole:
            S, _, masks = P.launch_sums(smooth, True)
            S_ref, _, masks_ref = P.sums_stage_reference(smooth, True)
            check_projection_exact(torch, f"flow_project {dt} {H}x{W}", S, S_ref, masks,
                                   masks_ref)
        checks = []
        for tag, fl in (("smooth", smooth),
                        ("pm200", rand(B, 2, H, W, dt=dt, scale=400.0, shift=-200.0)),
                        ("all_invalid", torch.full_like(smooth, 3.0 * W))):
            got = projection.flow_project(fl, fillhole=fillhole)
            checks.append(compare([(got, projection.reference(fl, fillhole=fillhole))], 1e-3))
            if tag == "all_invalid" and got.any():
                raise CheckFailed(f"flow_project {dt} {H}x{W}: an all-invalid flow gave "
                                  "nonzero values")
        return max(checks, key=lambda c: c[1])

    def conv(dt, B, C, H, W, O, _C, K, _K, bias, relu):
        x = rand(B, C, H, W, dt=dt, scale=4.0, shift=-2.0)
        if bias:
            w = I.torch_default_uniform((O, C, K, K), wgen).to(dev).to(dt)
            b = I.torch_default_uniform((O,), wgen, fan_in=C * K * K).to(dev)
        else:
            w, b = I.resnet_msra((O, C, K, K), wgen).to(dev).to(dt), None
        got = conv_kernel.launch(x, w, b, relu=relu)
        ref = conv_kernel.reference(x, w, b, relu=relu)
        return compare([(got, ref)], 5e-4, long_sums=True) if bias else \
            compare([(got, ref)], 1e-4)

    def level_input(dt, B, _three, H, W):
        fst, snd = rand(B, 3, H, W, dt=dt), rand(B, 3, H, W, dt=dt)
        cflow = synthetic_flow(B, dev, size=(H // 2, W // 2)).to(dt)
        got = gather_kernel.launch_level_input(fst, snd, cflow)
        ref = gather_kernel.level_input_reference(fst, snd, cflow)
        for part, sl in (("fst", slice(0, 3)), ("up", slice(6, 8))):
            if not torch.equal(got[:, sl], ref[:, sl]):
                raise CheckFailed(f"spynet_level_input {dt} {H}x{W}: {part} differs from the "
                                  "plain version")
        want = gather_kernel.reference(snd, gather_kernel.warp_grid(got[:, 6:8]))
        return compare([(got[:, 3:6], want)], 1e-5)

    def grid_sample(dt, B, C, H, W, Ho, Wo):
        x = rand(B, C, H, W, dt=dt)
        grid = gather_kernel.warp_grid(synthetic_flow(B, dev, size=(Ho, Wo))).contiguous()
        return compare([(gather_kernel.launch(x, grid), gather_kernel.reference(x, grid))], 1e-5)

    def fill_tiles(dt, n, Hl, Wl, stacks, given):
        from memcnet_tpu_torch.parallel import tiling as T

        # every carry given (the mode of an axis across ranks): the carry entry's plain
        # version on random carries; else the grid of these stacks, rebuilt
        ring = axis_h = None
        if stacks[0] is not None:
            axis_h = "tile_h" if stacks[1] is not None else None
            ring = T._ring(tile_mesh(torch, "tile2x2" if axis_h else "tile4"), stacks[0][1],
                           "tile", axis_h)
            if (ring.n, ring.stacked("tile"), axis_h and ring.stacked(axis_h)) != \
                    (n, stacks[0], axis_h and stacks[1]):
                raise CheckFailed(f"fill_tiles {(n, Hl, Wl, stacks)}: no such grid here")
        elif stacks[1] is not None or not given[0]:
            raise CheckFailed(f"fill_tiles {(n, Hl, Wl, stacks, given)}: no such grid here")

        def carries(length):
            c = torch.randn((n, 3, length), generator=gen, device=dev)
            c[:, 0] = (c[:, 0] > 0).float()
            return c

        checks = []
        for density, uneven in ((0.004, False), (0.3, True)):
            cnt = (torch.rand((n, Hl, Wl), generator=gen, device=dev) < density).float()
            if uneven:
                cnt[..., -1] = 0.0
                cnt[:, -1] = 0.0
            avg = torch.randn((n, 2, Hl, Wl), generator=gen, device=dev) * (cnt > 0)[:, None]
            has = cnt > 0
            if ring is None:
                lf, rt = carries(Hl), carries(Hl)
                up = carries(Wl) if given[2] else None
                ref = P.carry_fill_reference(avg, cnt, lf, rt, up, dt)
            else:
                lf, rt = T._row_carries(avg, has, ring, "tile") if given[0] else (None, None)
                up = T._up_carry(avg, has, ring, axis_h) if given[2] else None
                ref = T.tiled_fill_reference(avg, cnt, ring, "tile", axis_h, dt)
            got, masks = P.launch_fill_tiles(avg, cnt, stacks, lf, rt, up, dt, with_masks=True)
            want = P.pack_masks(has)
            if not (torch.equal(got, ref) and torch.equal(masks.rows, want.rows)
                    and torch.equal(masks.cols, want.cols)):
                raise CheckFailed(f"fill_tiles {dt} {(n, Hl, Wl, stacks)}: not the plain "
                                  "composition's bits or masks")
            checks.append(compare([(got, ref)], 0.0))
        return max(checks, key=lambda c: c[1])

    def op_inputs(op, B, Hh, Ww, dt):
        if op == "depth":
            return ((torch.randint(1, 8, (B, 1, Hh, Ww), generator=gen, device=dev) * 0.25)
                    .to(dt),)
        f1 = rand(B, 3, Hh, Ww, dt=torch.float32)
        f2 = (f1 + 0.05 * torch.randn(f1.shape, generator=gen, device=dev)).clamp(0.0, 1.0)
        return f1.to(dt), f2.to(dt)

    def payload(dt, op, B, _two, Hh, Ww, fillhole):
        flow = synthetic_flow(B, dev, size=(Hh, Ww)).to(dt)
        ins = op_inputs(op, B, Hh, Ww, dt)
        S, out, extra, masks = P.launch_payload(op, flow, ins, 20.0 / 255.0, fillhole)
        S_ref, out_ref, extra_ref, masks_ref = P.op_stage_reference(op, flow, ins, 20.0 / 255.0,
                                                                    fillhole)
        if fillhole:
            check_projection_exact(torch, f"payload {op} {dt} {Hh}x{Ww}", S, S_ref, masks,
                                   masks_ref)
        elif not torch.equal(S[:, -1], S_ref[:, -1]):
            raise CheckFailed(f"payload {op} {dt} {Hh}x{Ww}: the last plane differs")
        return compare([(out, out_ref)] + ([(extra, extra_ref)] if extra is not None else []),
                       1e-3)

    def payload_tile(dt, op, n, _two, h, w, S, Hg, Wg):
        org = origins[("payload_tile", (op, n, _two, h, w, S, Hg, Wg))]
        flow = ((torch.rand((n, 2, h, w), generator=gen, device=dev) - 0.5) * 40.0).to(dt)
        ins = op_inputs(op, n, h, w, dt)
        if op == "gated":
            ins = (ins[0], op_inputs(op, S, Hg, Wg, dt)[1])
        got = P.launch_payload_tile(op, flow, ins, 20.0 / 255.0, org, S, Hg, Wg)
        ref = P.payload_tile_reference(op, flow, ins, 20.0 / 255.0, org, S, Hg, Wg)
        if not torch.equal(got[:, -1], ref[:, -1]):
            raise CheckFailed(f"payload_tile {op} {dt} {(n, h, w)}: the last plane differs")
        return compare([(got, ref)], 1e-5 * max(1.0, float(ref.abs().max())))

    holds = {"filter_interp_warp": warp, "flow_project": project, "conv2d_small": conv,
             "spynet_level_input": level_input, "grid_sample": grid_sample,
             "fill_tiles": fill_tiles, "payload": payload, "payload_tile": payload_tile}
    rows, lines = [], []
    for name, keys in seen.items():
        for key in sorted(keys, key=repr):
            for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                err, measure, limit, rule = holds[name](dt, *key)
                ok = bool(measure <= limit)
                rows.append(dict(kernel=name, key=list(key), dtype=dt_name, max_abs_err=err,
                                 check=rule, check_value=measure, ok=ok))
                lines.append(f"{name} {key} {dt_name}: max_abs_err {err:.3e} [{rule}: "
                             f"{measure:.3g}] {'ok' if ok else 'FAIL'}")
                if not ok:
                    with open(os.path.join(OUT_DIR, f"{tag}_shapes.log"), "w") as f:
                        f.write("\n".join(lines) + "\n")
                    raise CheckFailed(f"{name} {key} {dt_name}: kernel disagrees with its plain "
                                      f"version at a {tag} path's shape ({rule}: {measure})")
        torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, f"{tag}_shapes.log"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for name, keys in seen.items():
        mine = [r for r in rows if r["kernel"] == name]
        worst = {dt: max((r["check_value"] for r in mine if r["dtype"] == dt), default=None)
                 for dt in ("bfloat16", "float32")}
        log(f"  {name}: held at the {tag} paths' {len(keys)} shapes, bf16 and float32, worst "
            f"check value bf16 {worst['bfloat16']}, float32 {worst['float32']}")
    results[f"{tag}_shapes"] = rows


def png_read_times(results, work):
    """png.imread of one RGB frame written with libpng's adaptive filters
    (Paeth on most rows) and with filter 0, at Middlebury's 388x584 and
    Vimeo-90K's 256x448 (host ms, median of 3; the arrays read must equal
    the frame written); and of the adaptive file's rows alone, the unfilter
    in C (csrc/png.cu, what imread runs here) against the plain Python one
    it replaces where nvcc is missing, which must agree."""
    import zlib

    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.io import png

    def median_ms(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    if png._lib.nvcc_path() is None:
        raise CheckFailed("png.imread: no nvcc, so no C unfilter to time")
    res = {}
    for h, w in ((MB_H, MB_W), (VE_FRAME_H, VE_FRAME_W)):
        img = probe.moving_frames(3, 1, h, w)[0]
        row = {}
        for adaptive in (True, False):
            path = os.path.join(work, f"read_{h}x{w}_{adaptive}.png")
            png.imwrite(path, img, adaptive=adaptive)
            row["imread_adaptive_ms" if adaptive else "imread_filter0_ms"], got = median_ms(
                lambda: png.imread(path))
            if not np.array_equal(got, img):
                raise CheckFailed(f"png.imread {h}x{w} (adaptive {adaptive}): the frame read "
                                  "differs from the one written")
        with open(os.path.join(work, f"read_{h}x{w}_True.png"), "rb") as f:
            raw = zlib.decompress(b"".join(body for kind, body in png._chunks(f.read())
                                           if kind == b"IDAT"))
        row["unfilter_c_ms"], ours = median_ms(lambda: png.unfilter(raw, h, w * 3, 3))
        row["unfilter_python_ms"], plain = median_ms(lambda: png.unfilter_plain(raw, h, w * 3, 3))
        row["paeth_rows"] = int(sum(raw[y * (w * 3 + 1)] == 4 for y in range(h)))
        if not np.array_equal(ours, plain):
            raise CheckFailed(f"png.unfilter {h}x{w}: the C unfilter differs from the plain one")
        res[f"{h}x{w}"] = row
        log(f"  png.imread {w}x{h} RGB (host ms, median of 3): adaptive filters "
            f"({row['paeth_rows']} of {h} rows Paeth) {row['imread_adaptive_ms']:.3f}, filter 0 "
            f"{row['imread_filter0_ms']:.3f}; the adaptive rows' unfilter in C "
            f"{row['unfilter_c_ms']:.3f}, in Python {row['unfilter_python_ms']:.3f}")
    results.setdefault("demos", {})["png_read_ms"] = res


def phase_demos(torch, results, card):
    import tempfile

    from memcnet_tpu_torch import native

    if not native.available():  # the HD720p demo would fall back to numpy
        raise CheckFailed(f"the native YUV library did not build: {native.build_error()}")
    with tempfile.TemporaryDirectory() as work:
        png_read_times(results, work)
        with ShapeRecorder() as rec:
            src = demo_hd720p_run(torch, results, work, card)
            torch.cuda.empty_cache()
            demo_middlebury_run(torch, results, work, card)
            torch.cuda.empty_cache()
            demo_vimeo_ve_run(torch, results, work, card)
            torch.cuda.empty_cache()
            demo_card_vs_cpu(torch, results, work)
        # every launch of the demos went through the recorder, so every
        # shape launched is held below
        launched = {k: sum(d["launches"][k] for d in results["demos"].values() if "launches" in d)
                    for k in ("filter_interp_warp", "base_scatter", "conv2d_small", "grid_sample")}
        seen = {"filter_interp_warp": rec.calls["filter_interp_warp"],
                "base_scatter": rec.calls["flow_project"],
                "conv2d_small": rec.calls["conv2d_small"],
                "grid_sample": rec.calls["spynet_level_input"] + rec.calls["grid_sample"]}
        if seen != launched:
            raise CheckFailed(f"phase 5: launches {launched}, recorded {seen}")
        demo_hd720p_stages(torch, results, src)
        torch.cuda.empty_cache()
        hold_recorded_shapes(torch, results, rec.seen)


# ---------------------------------------------------------------------------
# phase 6: train steps on the card (build_interp_trainer + fit, make_ve_train_step)

TRAIN_H, TRAIN_W = 256, 448  # Vimeo-90K triplets: multiples of FlowNetS's 64, no padding
# the interpolation models train at Config().lr (2e-3, the upstream trainer's);
# MEMC_Net_VE, the 768x1344 step and the card-vs-CPU steps at the rate of the JAX
# package's VE descent test (tests/test_train.py): random kaiming EDSR weights
# put VE's outputs in the hundreds, and 2e-3 makes its loss swing
TRAIN_LR = 1e-4
# (model, dtype, steps); each step's launches are counted around the whole step
TRAIN_RUNS = (("MEMC_Net_star", "float32", 6), ("MEMC_Net_star", "bfloat16", 6),
              ("MEMC_Net", "float32", 4), ("MEMC_Net_s", "float32", 4),
              ("MEMC_Net_VE", "float32", 4))
# launches per train step: the served counts without the hole fill (K3), which
# training turns off; SPyNet has 5 levels at 256x448 (it stops halving at 16x28)
EXPECTED_PER_STEP = {
    "MEMC_Net_star": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                      "conv2d_small": 1, "grid_sample": 0, **TILE_COUNTERS},
    "MEMC_Net_s": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                   "conv2d_small": 25, "grid_sample": 5, **TILE_COUNTERS},
    "MEMC_Net": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                 "conv2d_small": 0, "grid_sample": 0, **TILE_COUNTERS},
    "MEMC_Net_VE": {"filter_interp_warp": 1, "base_scatter": 0, "fill_holes": 0,
                    "conv2d_small": 1, "grid_sample": 0, **TILE_COUNTERS},
}
# the autograd Functions whose backward is autograd of a kernel's plain version
BACKWARD_NODES = {"filter_interp_warp": "_WarpFunctionBackward",
                  "flow_project": "_ProjectFunctionBackward",
                  "conv2d_small": "_ConvFunctionBackward",
                  "spynet_level_input": "_LevelInputFunctionBackward"}
STEP_GRAD_TOL = 1e-2        # card vs CPU step: gradients, of their subnet's largest
STEP_TRUNK_GRAD_TOL = 0.1   # the same in MEMC_Net's train-mode BatchNorm trunks


class CountedStep:
    """A train step that counts each call's kernel launches (set to 0 just
    before, read just after) and records CUDA events around it; ``fit``
    reads its ``model`` and ``optimizer``."""

    def __init__(self, torch, step):
        self.torch, self.step = torch, step
        self.model, self.optimizer = step.model, step.optimizer
        self.counts, self.events, self.f32_counts = [], [], []

    def __call__(self, *inputs):
        from memcnet_tpu_torch.ops import cuda as K

        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        K.reset_counters()
        start.record()
        loss = self.step(*inputs)
        end.record()
        self.counts.append(K.launch_counts())
        self.f32_counts.append(K.body_counts()["conv2d_small[float32]"])
        self.events.append((start, end))
        return loss

    def ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def running_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running_" in k}


def profile_train_step(torch, tag, step, inputs):
    """One profiled train step: kernels by device time, the device's idle
    share over the step, device ms of the forward and the optimizer (their
    record_function ranges) and of the backward (autograd's top-level
    evaluate_function events), and each kernel's plain-version backward."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda_kind = torch.autograd.DeviceType.CUDA
    # the record_function ranges also appear on the device timeline (as
    # annotations spanning their kernels): count kernels only
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == cuda_kind and e.self_device_time_total > 0
                   and not e.key.startswith("train_step.")),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    events = prof.events()

    def device_ms(e):
        """Device ms of the kernels that ``e`` and the events under it launched."""
        own = sum(k.duration for k in e.kernels if not k.name.startswith("train_step."))
        return own / 1e3 + sum(device_ms(c) for c in e.cpu_children)

    def under_backward(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("autograd::engine::evaluate_function"):
                return True
            p = p.cpu_parent
        return False

    phases = {"forward": 0.0, "optimizer": 0.0, "backward": 0.0}
    plain_bwd = {k: 0.0 for k in BACKWARD_NODES}
    for e in events:
        if e.name in ("train_step.forward", "train_step.optimizer"):
            phases[e.name.split(".")[1]] += device_ms(e)
        elif e.name.startswith("autograd::engine::evaluate_function") and not under_backward(e):
            phases["backward"] += device_ms(e)
            for k, node in BACKWARD_NODES.items():
                if e.name.endswith(node):
                    plain_bwd[k] += device_ms(e)
    share = {k: v / busy if busy else None for k, v in plain_bwd.items()}
    log(f"  {tag}: profiled step wall {wall_ms:.3f} ms, kernels {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}; device ms forward {phases['forward']:.3f}, "
        f"backward {phases['backward']:.3f}, optimizer {phases['optimizer']:.3f}; plain-version "
        "backward " + ", ".join(f"{k} {v:.3f} ms ({100 * (share[k] or 0):.1f}%)"
                                for k, v in plain_bwd.items() if v))
    with open(os.path.join(OUT_DIR, f"profile_train_{tag}.txt"), "w") as f:
        for key, ms_, n in rows:
            f.write(f"{ms_:10.4f} ms {n:5d}x  {key}\n")
    for key, ms_, n in rows[:8]:
        log(f"    {ms_:9.4f} ms {100 * ms_ / max(busy, 1e-9):5.1f}% {n:4d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, kernel_ms=busy, idle_share=max(0.0, 1 - busy / wall_ms),
                phase_device_ms=phases, plain_backward_device_ms=plain_bwd,
                plain_backward_share=share, top=rows[:25])


def check_falling(tag, hist):
    """tests/test_train.py's rules (Adamax's first step may overshoot):
    finite, the last loss below step 1's, and the last step still falls."""
    if not all(np.isfinite(hist)) or not (hist[-1] < hist[1] and hist[-1] < hist[-2]):
        raise CheckFailed(f"{tag}: losses do not fall: {hist}")


def train_run(torch, name, dt_name, steps, root, work, results):
    """Train ``name`` in ``dt_name`` for ``steps`` steps on the card: an
    interpolation model with build_interp_trainer + fit over a VimeoTriplet
    of one fixed 256x448 triplet (a checkpoint at the end), MEMC_Net_VE with
    make_ve_train_step on one synthetic 256x448 window.  Checks the launches
    of every step, the falling losses and, with BatchNorm, that every
    running statistic moved."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.data.vimeo90k import VimeoTriplet
    from memcnet_tpu_torch.train import trainer as T
    from memcnet_tpu_torch.utils.config import Config

    tag = f"{name}_{dt_name}"
    dt = getattr(torch, dt_name)
    model = build_model(name, seed=0, dtype=dt, device="cuda")
    before = running_stats(model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if name == "MEMC_Net_VE":
        opt = T.make_optimizer(model, lr=TRAIN_LR, subnet_lr=True, plateau=True)
        step = CountedStep(torch, T.make_ve_train_step(model, opt, device="cuda"))
        window = synthetic_window(11, TRAIN_H, TRAIN_W)
        inputs = ([w[None] for w in window], window[3][None])
        hist = [float(step(*inputs)) for _ in range(steps)]
    else:
        _, tstep = T.build_interp_trainer(model, Config(), device="cuda")
        step = CountedStep(torch, tstep)
        ds = VimeoTriplet(root, seed=0)
        ds.paths = ds.paths[:1]  # overfit one fixed triplet
        ckpt = os.path.join(work, f"ckpt_{tag}")
        hist = T.fit(step, ds.batches(1, shuffle=False), steps=steps, eval_every=steps,
                     checkpoint_dir=ckpt, log=lambda m: log(f"  {tag} fit: {m}"))
        if os.listdir(ckpt) != [f"step_{steps}.pt"]:
            raise CheckFailed(f"{tag}: fit wrote {os.listdir(ckpt)}")
        inputs = next(ds.batches(1, shuffle=False))
    peak = torch.cuda.max_memory_allocated()
    ms = step.ms()
    check_falling(tag, hist)
    after = running_stats(model)
    still = [k for k in before if torch.equal(before[k], after[k])]
    if still or (name != "MEMC_Net_star") != bool(before):
        raise CheckFailed(f"{tag}: {len(still)} of {len(before)} running statistics did not move")
    per_step = float(np.median(ms[1:]))
    log(f"  {tag}: {steps} steps, losses {', '.join(f'{h:.5f}' for h in hist)}; ms/step "
        f"{', '.join(f'{m:.3f}' for m in ms)} (median after the first {per_step:.3f}); peak "
        f"memory {peak / 2 ** 30:.3f} GiB; {len(before)} running statistics moved")
    prof = profile_train_step(torch, tag, step, inputs)
    f32_per_step = EXPECTED_PER_STEP[name]["conv2d_small"] if dt_name == "float32" else 0
    for i, counts in enumerate(step.counts):  # the profiled step's too
        if counts != EXPECTED_PER_STEP[name] or step.f32_counts[i] != f32_per_step:
            raise CheckFailed(f"{tag} step {i}: launches {counts} ({step.f32_counts[i]} of the "
                              f"float32 K4 body), expected {EXPECTED_PER_STEP[name]} "
                              f"({f32_per_step})")
    log(f"  {tag}: launches per step, {len(step.counts)} steps: {step.counts[0]}")
    results.setdefault("train", {})[tag] = dict(
        losses=hist, ms=ms, ms_per_step=per_step, peak_bytes=peak, steps=len(step.counts),
        launches_per_step=step.counts[0],
        launches={k: sum(c[k] for c in step.counts) for k in step.counts[0]},
        f32_launches=sum(step.f32_counts), bn_stats_moved=len(before), profile=prof)
    del model, step
    torch.cuda.empty_cache()


def train_step_720p(torch, results):
    """One MEMC_Net_star bf16 train step at 768x1344 (1280x720 padded), the
    size at which the JAX package chunked its warp backward; the port's
    backward is not chunked.  Two steps (the first chooses cuDNN's
    algorithms): their times and the peak memory."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.data import pad_frame, pad_plan
    from memcnet_tpu_torch.train import trainer as T

    model = build_model("MEMC_Net_star", seed=0, dtype=torch.bfloat16, device="cuda")
    opt = T.make_optimizer(model, lr=TRAIN_LR, subnet_lr=True, plateau=True)
    step = CountedStep(torch, T.make_interp_train_step(model, opt, alpha=(1.0, 0.0),
                                                       device="cuda"))
    plan = pad_plan(FRAME_H, FRAME_W)
    x0, x2 = (np.ascontiguousarray(pad_frame(f, plan)[None]) for f in synthetic_frames(3))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(x0, (x0 + x2) / 2, x2)) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    ms = step.ms()
    if not all(np.isfinite(losses)) or step.counts[-1] != EXPECTED_PER_STEP["MEMC_Net_star"]:
        raise CheckFailed(f"star bf16 768x1344 step: losses {losses}, launches {step.counts}")
    log(f"  MEMC_Net_star bf16 train step at {H}x{W}: ms {', '.join(f'{m:.3f}' for m in ms)}; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; losses {losses}")
    results.setdefault("train", {})["MEMC_Net_star_bfloat16_768x1344"] = dict(
        ms=ms, peak_bytes=peak, losses=losses,
        launches={k: sum(c[k] for c in step.counts) for k in step.counts[0]})
    del model, step
    torch.cuda.empty_cache()


def card_vs_cpu_step(torch, name, results):
    """One float32 train step of ``name`` at 2x 64x128 on the card and on the
    CPU from the same weights and inputs: the loss within 1e-4 relative;
    each parameter's gradient within STEP_GRAD_TOL of the largest gradient
    magnitude in its subnet (the first component of its name), as
    tests/test_torch_train_models.py holds the port against the JAX package
    -- not of the tensor's own: FlowNetS's deepest layers, at its 0.02 / n
    init, get gradients near float32 noise (a card-vs-CPU difference of up to
    0.21 of their own largest, call 1 of PR 10) -- and within
    STEP_TRUNK_GRAD_TOL in MEMC_Net's train-mode BatchNorm trunks, whose
    backward amplifies float32 rounding (up to 5.2e-2 between the packages on
    the CPU); the running statistics after the step within 1e-4 of each
    tensor's largest magnitude; the parameters after the update within 2 lr
    of each other everywhere (Adamax's first update is about lr * sign(g))
    and within 1e-6 on at least 99% of their elements.  TF32 is off (phase 3
    turned it off)."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.train import trainer as T

    rng = np.random.RandomState(4)
    x0 = rng.rand(2, 3, 64, 128).astype(np.float32)
    x2 = np.roll(x0, (1, 2), axis=(2, 3)) * 0.9 + 0.05
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(name, seed=0, device=dev)
        opt = T.make_optimizer(model, lr=TRAIN_LR, subnet_lr=True, plateau=True)
        loss = float(T.make_interp_train_step(model, opt, device=dev)(x0, (x0 + x2) / 2, x2))
        out[dev] = (loss, {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                           .detach().cpu() for k, p in model.named_parameters()},
                    {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
    worst = {"loss": abs(lg - lc) / abs(lc), "grad": 0.0, "stats": 0.0}
    bad = []
    if not worst["loss"] <= 1e-4:
        bad.append(f"loss {lg} vs {lc}")
    subnet_max = {}
    for k, g in gc.items():
        sub = k.split(".")[0]
        subnet_max[sub] = max(subnet_max.get(sub, 0.0), float(g.abs().max()))
    for k, g in gc.items():
        sub = k.split(".")[0]
        tol = STEP_TRUNK_GRAD_TOL if sub in ("initScaleNets_filter", "initScaleNets_occlusion") \
            and name == "MEMC_Net" else STEP_GRAD_TOL
        e = float((gg[k] - g).abs().max()) / max(subnet_max[sub], 1e-30)
        worst["grad"] = max(worst["grad"], e / tol * STEP_GRAD_TOL)
        if not e <= tol:
            bad.append(f"grad {k}: {e:.3g} of its subnet's largest > {tol}")
    close_elems = total = 0
    for k, v in sc.items():
        d = (sg[k].double() - v.double()).abs()
        if "running_" in k:
            e = float(d.max()) / max(float(v.abs().max()), 1e-30)
            worst["stats"] = max(worst["stats"], e)
            if not e <= 1e-4:
                bad.append(f"{k}: {e:.3g}")
        elif k in gc:
            if float(d.max()) > 2 * TRAIN_LR * (1 + 1e-3):
                bad.append(f"param {k}: {float(d.max()):.3g} > 2 lr")
            close_elems += int((d <= 1e-6).sum())
            total += d.numel()
    worst["params_close_share"] = close_elems / total
    if close_elems < 0.99 * total:
        bad.append(f"only {close_elems / total:.4f} of parameter elements within 1e-6")
    log(f"  {name} float32 2x 64x128 step, card vs CPU: loss {lg:.6f} vs {lc:.6f}; worst "
        f"gradient {worst['grad']:.3g} (of {STEP_GRAD_TOL}), running stats {worst['stats']:.3g}, "
        f"parameters within 1e-6: {worst['params_close_share']:.5f}")
    results.setdefault("train_card_vs_cpu", {})[name] = worst
    if bad:
        raise CheckFailed(f"{name}: the card's train step disagrees with the CPU's: "
                          + "; ".join(bad[:8]))


def hold_gradients(torch, results, seen):
    """The card's step gradients against the plain versions': at the largest
    shape the train paths launched each kernel at, the kernel's
    autograd.Function (kernel forward, backward = autograd of the plain
    version) and the plain version alone, on the same inputs and cotangent,
    in bf16 and float32, under phase 2's rules.  Deterministic algorithms
    are on, so that the plain backward's atomic sums run in one order."""
    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.probe import synthetic_flow

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    wgen = torch.Generator().manual_seed(9)

    def rand(*shape, dt, scale=1.0, shift=0.0):
        return (torch.rand(shape, generator=gen, device=dev) * scale + shift).to(dt)

    def grads(fn, plain, inputs, dt):
        inputs = [x.detach().requires_grad_() for x in inputs]
        got = fn(*inputs)
        got = got if isinstance(got, tuple) else (got,)
        cot = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype) for o in got]
        g_card = torch.autograd.grad(got, inputs, cot, allow_unused=True)
        want = plain(*inputs)
        want = want if isinstance(want, tuple) else (want,)
        g_plain = torch.autograd.grad(want, inputs, cot, allow_unused=True)
        return [(a, b) for a, b in zip(g_card, g_plain) if b is not None]

    def warp(dt, B, chans, H, W, fs):
        images = [rand(B, c, H, W, dt=dt) for c in chans]
        flow = synthetic_flow(B, dev, size=(H, W)) * 0.1
        filt = rand(B, fs * fs, H, W, dt=dt, scale=1.0 / 8.0)
        return compare(grads(lambda f, fi, *im: warp_kernel.warp(im, f, fi, fs),
                             lambda f, fi, *im: warp_kernel.reference(im, f, fi, fs),
                             [flow, filt, *images], dt), 1e-4)

    def project(dt, B, two, H, W, fillhole):
        flow = (synthetic_flow(B, dev, size=(H, W)) * 0.1).to(dt)
        return compare(grads(lambda f: P.flow_project(f, fillhole),
                             lambda f: P.reference(f, fillhole), [flow], dt), 1e-3)

    def conv(dt, B, C, H, W, O, _C, K, _K, bias, relu):
        x = rand(B, C, H, W, dt=dt, scale=4.0, shift=-2.0)
        w = I.torch_default_uniform((O, C, K, K), wgen).to(dev).to(dt)
        b = I.torch_default_uniform((O,), wgen, fan_in=C * K * K).to(dev) if bias else None
        ins = [x, w] + ([b] if bias else [])
        return compare(grads(lambda *a: conv_kernel.conv2d_small(*a[:2], a[2] if bias else None,
                                                                 relu=relu),
                             lambda *a: conv_kernel.reference(*a[:2], a[2] if bias else None,
                                                              relu=relu), ins, dt),
                       5e-4, long_sums=True)

    def level_input(dt, B, _three, H, W):
        fst, snd = rand(B, 3, H, W, dt=dt), rand(B, 3, H, W, dt=dt)
        cflow = synthetic_flow(B, dev, size=(H // 2, W // 2)).to(dt)
        return compare(grads(gather_kernel.level_input, gather_kernel.level_input_reference,
                             [fst, snd, cflow], dt), 1e-5)

    holds = {"filter_interp_warp": warp, "flow_project": project, "conv2d_small": conv,
             "spynet_level_input": level_input}
    rows = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, keys in seen.items():
            if not keys:
                continue
            key = max(keys, key=lambda k: np.prod([v for v in k if type(v) is int]))
            for dt_name in ("bfloat16", "float32"):
                err, measure, limit, rule = holds[name](getattr(torch, dt_name), *key)
                ok = bool(measure <= limit)
                rows.append(dict(kernel=name, key=list(key), dtype=dt_name, max_abs_err=err,
                                 check=rule, check_value=measure, ok=ok))
                log(f"  {name} gradient at {key} {dt_name}: max_abs_err {err:.3e} "
                    f"[{rule}: {measure:.3g}] {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise CheckFailed(f"{name} {key} {dt_name}: the step's gradient disagrees "
                                      f"with the plain version's ({rule}: {measure})")
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    results["train_gradients"] = rows


def phase_train(torch, results):
    import tempfile

    from memcnet_tpu_torch import probe

    with tempfile.TemporaryDirectory() as work:
        root = probe.write_vimeo(os.path.join(work, "vimeo"), 2, TRAIN_H, TRAIN_W, seed=5)
        with ShapeRecorder() as rec:
            for name, dt_name, steps in TRAIN_RUNS:
                train_run(torch, name, dt_name, steps, root, work, results)
        # the recorder saw every launch of the runs, the profiled steps too
        launched = {k: sum(r["launches"][k] for r in results["train"].values())
                    for k in ("filter_interp_warp", "base_scatter", "conv2d_small",
                              "grid_sample")}
        seen = {"filter_interp_warp": rec.calls["filter_interp_warp"],
                "base_scatter": rec.calls["flow_project"],
                "conv2d_small": rec.calls["conv2d_small"],
                "grid_sample": rec.calls["spynet_level_input"] + rec.calls["grid_sample"]}
        if seen != launched:
            raise CheckFailed(f"phase 6: launches {launched}, recorded {seen}")
    if any(key[-1] for key in rec.seen["flow_project"]):
        raise CheckFailed("phase 6: a train step ran the projection with the hole fill")
    train_step_720p(torch, results)
    for name in ("MEMC_Net", "MEMC_Net_star"):
        card_vs_cpu_step(torch, name, results)
    hold_recorded_shapes(torch, results, rec.seen, tag="train")
    hold_gradients(torch, results, rec.seen)


# Phase 7: the op library (memcnet_tpu_torch.ops, the 13 names of the JAX
# package's ops.__all__) at full width: the projections, the warps and
# separable_conv at B = 2, 768x1344; the MC ops at B = 1, C = 3, 768x1344
OPLIB_SEPCONV_FS = 11       # separable_conv's 1-D kernel length
OPLIB_CTX_C = 16            # bilinear_warp_ch's channels
# the op library's run: launches of each kernel over one call of each op
EXPECTED_OPLIB = {"filter_interp_warp": 1, "base_scatter": 3, "fill_holes": 3,
                  "conv2d_small": 0, "grid_sample": 0, **TILE_COUNTERS}
# ops whose backward is the reference's hand rule: held backward too
HAND_BACKWARD = ("depth_flow_project", "occlusion_weight", "pixel_splat", "pixel_value",
                 "pixel_weight", "reliable_weight")


def oplib_inputs(torch, dev):
    """Seeded full-width inputs (float32, on ``dev``): textured frame pairs
    2-12 px apart (probe.moving_frames), the +-20 px flows of phase 2 with
    their out-of-frame blocks, depths in quarters from 0.5 to 1.5 (so their
    sums are exact in any order) and the other planes uniform."""
    from memcnet_tpu_torch.probe import moving_frames, synthetic_flow

    frames = [torch.from_numpy(f.transpose(2, 0, 1).astype(np.float32) / 255.0)
              for f in moving_frames(7, 3, H, W)]
    gen = torch.Generator().manual_seed(11)

    def u(*shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev)

    fs = OPLIB_SEPCONV_FS
    return dict(
        frame1=torch.stack(frames[:2]).to(dev), frame2=torch.stack(frames[1:]).to(dev),
        flow=synthetic_flow(2, dev),
        depth=(torch.randint(0, 5, (2, 1, H, W), generator=gen) * 0.25 + 0.5).to(dev),
        filt=u(2, 16, H, W, hi=0.125), ctx=u(2, OPLIB_CTX_C, H, W, lo=-1.0),
        vert=u(2, fs, H - fs + 1, W - fs + 1), horiz=u(2, fs, H - fs + 1, W - fs + 1),
        fw=u(1, 1, H, W))


def oplib_calls(ops, x):
    """(name, fn, inputs) of each of the 13 ops; the MC ops on the first
    sample (B = 1)."""
    f1, f2, flow = x["frame1"], x["frame2"], x["flow"]
    return [
        ("filter_interp_warp", lambda a, f, k: ops.filter_interp_warp(a, f, k),
         [f1, flow, x["filt"]]),
        ("bilinear_warp", ops.bilinear_warp, [f1, flow]),
        ("bilinear_warp_ch", ops.bilinear_warp_ch, [x["ctx"], flow]),
        ("flow_project", lambda f: ops.flow_project(f, fillhole=True, fix_down_scan_bug=True),
         [flow]),
        ("depth_flow_project", lambda f, d: ops.depth_flow_project(f, d, fillhole=True),
         [flow, x["depth"]]),
        ("weighted_flow_project",
         lambda f, a, b: ops.weighted_flow_project(f, a, b, fillhole=True), [flow, f1, f2]),
        ("separable_conv", ops.separable_conv, [f1, x["vert"], x["horiz"]]),
        ("separable_conv_flow", ops.separable_conv_flow, [x["vert"], x["horiz"]]),
        ("occlusion_weight", ops.occlusion_weight, [f1[:1], f2[:1], flow[:1]]),
        ("pixel_splat", ops.pixel_splat, [f1[:1], flow[:1], x["fw"]]),
        ("pixel_value", ops.pixel_value, [f1[:1], flow[:1], x["fw"]]),
        ("pixel_weight", ops.pixel_weight, [flow[:1], x["fw"]]),
        ("reliable_weight", ops.reliable_weight, [flow[:1]]),
    ]


def oplib_kernels(torch, x, rows):
    """K2's payload entry (N7's payload built from the depth, P = 3, and
    N8's from the frames, P = 4) and K3's down search against their plain
    versions under phase 2's rules, in bf16 and float32; then the
    depth-weighted and gated projections and flow_project with the down
    search whole, against their plain compositions, with their launches and
    device operations per call (at most 4 with the fill, 3 without)."""
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.probe import device_ops

    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    B, HW = 2, H * W
    threshold = 20.0 / 255.0
    launches = {}
    for dtype_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        esize = torch.tensor([], dtype=dt).element_size()
        flow = x["flow"].to(dt)
        f1, f2, depth = x["frame1"].to(dt), x["frame2"].to(dt), x["depth"].to(dt)
        cases = {3: ("depth", (depth,)), 4: ("gated", (f1, f2))}
        gated = float((P.op_payload("gated", flow, (f1, f2), threshold)[:, 3] > 0).float().mean())
        for planes, (op, ins) in cases.items():
            name = f"base_scatter[payload P={planes}]"
            for fillhole in (True, False):
                S, out, extra, masks = P.launch_payload(op, flow, ins, threshold, fillhole)
                S_ref, out_ref, extra_ref, masks_ref = P.op_stage_reference(
                    op, flow, ins, threshold, fillhole)
                if fillhole:
                    check_projection_exact(torch, f"{name} {dtype_name}", S, S_ref, masks,
                                           masks_ref)
                pairs = [(out, out_ref)] + ([(extra, extra_ref)] if extra is not None else [])
                check = compare(pairs, 1e-3)
                if not check[1] <= check[2]:
                    raise CheckFailed(f"{name} {dtype_name} fill {fillhole}: kernel disagrees "
                                      f"with its plain version ({check[3]}: {check[1]})")
            valid, ixL, iyT = P.landing_cells(flow.float())
            cell = (torch.where(valid, iyT * W + ixL, 0).long()
                    + (torch.arange(B, device=dev) * HW).view(B, 1, 1)).reshape(-1)
            payload = P.op_payload(op, flow, ins, threshold)
            src = torch.where(valid[:, None], payload, 0.0).permute(0, 2, 3, 1).reshape(B * HW,
                                                                                     planes)

            def lib_scatter():  # the same P-plane base scatter of the built payload, one call
                return torch.zeros(B * HW, planes, device=dev).index_add_(0, cell, src)

            def entry(fill):
                return P.launch_payload(op, flow, ins, threshold, fill)

            n_ops, dev_ms, by_kernel = device_ops(lambda: entry(False))
            # reads the flow and the op's inputs, writes the result and the extra planes
            record_row(rows, name, dtype_name, check,
                       timed_ms(torch, lambda: entry(False), flush=flush),
                       timed_ms(torch, lambda: P.op_stage_reference(op, flow, ins, threshold,
                                                                    False), flush=flush),
                       timed_ms(torch, lib_scatter, flush=flush),
                       nbytes=B * HW * (2 + sum(t.shape[1] for t in ins) + planes - 1) * esize,
                       flops=0, op_dtype="float32",
                       extra=dict(valid_pixels=int(valid.sum()), gated_share=gated,
                                  device_ops=n_ops, device_ms=dev_ms, by_kernel=by_kernel,
                                  fill_ms=timed_ms(torch, lambda: entry(True), flush=flush)))
            del S, S_ref, out, out_ref, extra, extra_ref, src, cell, payload

        # K3 with the down search, on the flow projection's average and masks
        _, avg_ref, masks_ref = P.sums_stage_reference(flow, True)
        mask_bytes = 4 * sum(m.numel() for m in masks_ref)
        got = P.launch_fill(avg_ref, masks_ref, dt, down=True)
        ref = P.fill_stage_reference(avg_ref, masks_ref, dt, down=True)
        if torch.equal(got, P.fill_stage_reference(avg_ref, masks_ref, dt)):
            raise CheckFailed("fill_holes[down]: the down search changed no hole")
        if not torch.equal(got, ref):
            raise CheckFailed(f"fill_holes[down] {dtype_name}: not the plain version's bits")
        record_row(rows, "fill_holes[down]", dtype_name, compare([(got, ref)], 1e-5),
                   timed_ms(torch, lambda: P.launch_fill(avg_ref, masks_ref, dt, down=True),
                            flush=flush),
                   timed_ms(torch, lambda: P.fill_stage_reference(avg_ref, masks_ref, dt,
                                                                  down=True), flush=flush),
                   None, nbytes=B * HW * (2 * 4 + 2 * esize) + mask_bytes, flops=0,
                   op_dtype="float32",
                   extra=dict(no_down_ms=timed_ms(
                       torch, lambda: P.launch_fill(avg_ref, masks_ref, dt), flush=flush)))
        del avg_ref, masks_ref, got, ref

        # the whole ops: launches per call, device operations, against the plain
        # compositions; bytes = each input read once and each output written once
        whole = [
            ("depth_flow_project", lambda fl: projection.depth_flow_project(flow, depth,
                                                                           fillhole=fl),
             lambda fl: projection.depth_reference(flow, depth, fillhole=fl),
             B * HW * (2 + 1 + 2) * esize),
            ("weighted_flow_project",
             lambda fl: projection.weighted_flow_project(flow, f1, f2, fillhole=fl),
             lambda fl: projection.weighted_reference(flow, f1, f2, fillhole=fl),
             B * HW * (2 + 3 + 3 + 2 + 1) * esize),
            ("flow_project[down]",
             lambda fl: projection.flow_project(flow, fillhole=True, fix_down_scan_bug=True),
             lambda fl: projection.reference(flow, fillhole=True, fix_down_scan_bug=True),
             B * HW * (2 + 2) * esize),
        ]
        for name, fn, ref_fn, nbytes in whole:
            per = {}
            for fillhole in (True, False) if name != "flow_project[down]" else (True,):
                K.reset_counters()
                got = fn(fillhole)
                counts = K.launch_counts()
                want = {"base_scatter": 1, "fill_holes": int(fillhole)}
                if {k: counts[k] for k in want} != want or any(
                        counts[k] for k in counts if k not in want):
                    raise CheckFailed(f"{name} {dtype_name} fill {fillhole}: launches {counts}, "
                                      f"expected {want}")
                got = got if isinstance(got, tuple) else (got,)
                ref = ref_fn(fillhole)
                ref = ref if isinstance(ref, tuple) else (ref,)
                check = compare(list(zip(got, ref)), 1e-3)
                n_ops, dev_ms, by_kernel = device_ops(lambda: fn(fillhole))
                most = 4 if fillhole else 3  # memset, scatter, fold (, fill): no payload glue
                log(f"  {name:<19} {dtype_name:<8} fill {fillhole}: max_abs_err {check[0]:.3e} "
                    f"[{check[3]}: {check[1]:.3g}]; launches {want}; device ops per call "
                    f"{n_ops}, device ms {dev_ms:.4f}: "
                    + ", ".join(f"{k[:40]} {v:.4f}" for k, v in by_kernel.items()))
                if not check[1] <= check[2]:
                    raise CheckFailed(f"{name} {dtype_name} fill {fillhole}: the card disagrees "
                                      f"with the plain composition ({check[3]}: {check[1]})")
                if n_ops > most:
                    raise CheckFailed(f"{name} {dtype_name} fill {fillhole}: {n_ops} device "
                                      f"operations per call, at most {most} expected")
                per[fillhole] = dict(check=check, device_ops=n_ops, device_ms=dev_ms,
                                     device_ms_by_kernel=by_kernel, launches=want)
                launches[name] = want
            fl = name == "flow_project[down]"
            record_row(rows, name, dtype_name, per[fl]["check"],
                       timed_ms(torch, lambda: fn(fl), flush=flush),
                       timed_ms(torch, lambda: ref_fn(fl), flush=flush), None,
                       nbytes=nbytes, flops=0, op_dtype="float32",
                       extra=dict(fillhole=fl, device_ops=per[fl]["device_ops"],
                                  device_ms=per[fl]["device_ms"],
                                  by_fill={str(k): {kk: vv for kk, vv in v.items()
                                                    if kk != "check"}
                                           for k, v in per.items()}))
        del cases, flow, f1, f2, depth
        torch.cuda.empty_cache()
    return launches


def phase_oplib(torch, results):
    """Phase 7: the kernels of the op library against their plain versions
    (oplib_kernels); then the op library's run -- each of the 13 ops once on
    the card, float32, the launch counts set to 0 just before and read just
    after -- each op's result (and, for the hand backwards, its VJP of a
    seeded cotangent) against the port's CPU result on the same inputs,
    within 1e-4 of the output's scale (float atomics and index_add in a
    run-dependent order); each op's device ms from one profiled call."""
    from memcnet_tpu_torch import ops
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.probe import device_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    dev = torch.device("cuda")
    x = oplib_inputs(torch, dev)
    per_call = oplib_kernels(torch, x, rows)

    calls = oplib_calls(ops, x)
    cot_gen = torch.Generator().manual_seed(12)
    card, op_launches = {}, {}
    K.reset_counters()
    for name, fn, inputs in calls:
        xs = [t.requires_grad_(name in HAND_BACKWARD) for t in
              (a.detach().clone() for a in inputs)]
        before = K.launch_counts()
        out = fn(*xs)
        op_launches[name] = {k: v - before[k] for k, v in K.launch_counts().items()}
        out = out if isinstance(out, tuple) else (out,)
        grads = []
        if name in HAND_BACKWARD:
            cts = [torch.randn(o.shape, generator=cot_gen).to(dev) for o in out]
            grads = list(torch.autograd.grad(out, xs, cts))
        else:
            cts = []
        card[name] = ([o.detach().cpu() for o in out], [g.cpu() for g in grads],
                      [c.cpu() for c in cts])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"  op library run (13 ops, float32): launches {counts}")
    if counts != EXPECTED_OPLIB:
        raise CheckFailed(f"phase 7: launches {counts}, expected {EXPECTED_OPLIB}")

    per_op = {}
    for name, fn, inputs in calls:
        xs = [t.requires_grad_(name in HAND_BACKWARD) for t in
              (a.detach().cpu().clone() for a in inputs)]
        t0 = time.perf_counter()
        out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        got_out, got_grads, cts = card[name]
        grads = list(torch.autograd.grad(out, xs, cts)) if cts else []
        cpu_s = time.perf_counter() - t0
        worst = 0.0
        for a, b in zip(got_out + got_grads, [o.detach() for o in out] + grads):
            scale = max(1.0, float(b.abs().max()))
            worst = max(worst, float((a - b).abs().max()) / scale)
        n_ops, dev_ms, by_kernel = device_ops(lambda: fn(*inputs))
        ev_ms = timed_ms(torch, lambda: fn(*inputs), reps=5)
        per_op[name] = dict(rel_err=worst, backward=bool(cts), device_ops=n_ops,
                            device_ms=dev_ms if n_ops else None, device_ms_by_kernel=by_kernel,
                            ms=ev_ms, cpu_s=cpu_s, shapes=[list(a.shape) for a in inputs])
        log(f"  {name:<22} card vs CPU{' (+ VJP)' if cts else ''}: max err {worst:.3e} of the "
            f"output's scale (tol 1e-4); device ops {n_ops}, device ms "
            f"{f'{dev_ms:.4f}' if n_ops else 'not measured (the profiler kept no record)'}; "
            f"{ev_ms:.4f} ms by events (median of 5, L2 warm); CPU {cpu_s:.2f} s")
        if not worst <= 1e-4:
            raise CheckFailed(f"{name}: the card's result disagrees with the CPU's ({worst} of "
                              f"the output's scale)")
        finite = all(bool(torch.isfinite(o).all()) for o in got_out)
        if not finite:
            raise CheckFailed(f"{name}: the card's result is not finite")
    for name, got in op_launches.items():
        per_op[name]["launches"] = got
    results["oplib"] = dict(kernels=rows, launches=counts, per_call=per_call, ops=per_op)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the parallel layer on the one card

TILE_HALO = 64               # the served tiles' halo: 336-column tiles at 1344
TILE_GRIDS = (("tile4", None), ("tile2x2", "tile_h"))  # (data 1, tile 4), (1, 2, 2)
TILED_PAIRS = 2
EXPECTED_TILED_FRAME = {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                        "conv2d_small": 1, "grid_sample": 0, "filter_interp_warp_tile": 2,
                        "base_scatter_tile": 1, "fill_holes_carry": 1, "level_input_tile": 0,
                        "base_scatter_payload_tile": 0}
TILED_SERVE_TOL = 1e-2       # of the output's scale: bf16 flows the two sums may round apart
TILED_FLOW_PX = 8.0          # star's flows scaled to about this, inside the halo budget
NCCL_H, NCCL_W = 256, 448    # the one-rank NCCL step (Vimeo-90K's size)
MH_GOP_LEN = 4               # phase 5's 9-frame stream in 4 GOPs of one pair
MH_TIMEOUT = 300             # seconds for each demo process


def tile_mesh(torch, grid):
    from memcnet_tpu_torch.parallel import make_mesh, make_mesh_2d

    devs = [torch.device("cuda")] * 4
    return make_mesh(4, devices=devs) if grid == "tile4" else make_mesh_2d(4, devices=devs)


def tile_inputs(torch, mesh, axis_h, images, flow, filt):
    """What the tiled ops hand the tile entries: halo-extended sources, the
    tiles' flows and filters, and their origins."""
    from memcnet_tpu_torch.parallel import tiling as T

    B = images[0].shape[0]
    ring = T._ring(mesh, B, "tile", axis_h)
    Wl, Hl, hh = T._grid(mesh, images[0].shape, "tile", axis_h, TILE_HALO, None)
    exts = []
    for im in images:
        e = T._exchange_halo(ring.split(im), ring, "tile", TILE_HALO, -1)
        exts.append(T._exchange_halo(e, ring, axis_h, hh, -2) if axis_h else e)
    origins = T._origins(ring, "tile", axis_h, Wl, Hl, flow.device)
    return ring, exts, ring.split(flow), None if filt is None else ring.split(filt), origins, hh


def level_input_tile_rows(torch, rows, dt, dtype_name, gen, flush):
    """K5's tile entry (SPyNet's level input on partitioned frames) on the
    tiles of 768x1344 at three levels of each grid, B = 2, the coarse flow of
    probe.level_flow clipped to +-10 px (+-20 px upsampled, sampling tiles
    away): merged, its fst and up equal the untiled kernel's bit for bit;
    against its plain version fst exactly and up within phase 2's rules; its
    warp against the plain grid sample of its own up (the level input's
    rule).  The row, (1, 4) at the top level, is timed beside its plain
    version and F.grid_sample of the same sample."""
    import torch.nn.functional as F

    from memcnet_tpu_torch.ops.cuda import gather_kernel as G
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling
    from memcnet_tpu_torch.probe import device_ops, level_flow

    dev = torch.device("cuda")
    esize = torch.tensor([], dtype=dt).element_size()
    cases = []
    for grid, axis_h in TILE_GRIDS:
        mesh = tile_mesh(torch, grid)
        for lvl in (5, 3, 0):
            h, w_ = H >> lvl, W >> lvl
            fst, snd = (torch.rand((2, 3, h, w_), generator=gen, device=dev).to(dt)
                        for _ in range(2))
            cflow = level_flow(2, lvl, dev).clamp(-10.0, 10.0).to(dt)
            with spatial_tiling(mesh, halo=TILE_HALO, axis_h=axis_h):
                shard_frames(mesh, torch.zeros((1, 1, H, W), device=dev))
                p = active_partition()
                ft = p.split(fst)
                window, origins, level = p.level_input_window(p.split(cflow), ft)
                args = (ft, p.gather(p.split(snd)), window, origins, *level)
            got = G.launch_level_input_tile(*args)
            ref = G.level_input_tile_reference(*args)
            untiled = G.launch_level_input(fst, snd, cflow)
            merged = p.merge(got)
            for part, sl in (("fst", slice(0, 3)), ("up", slice(6, 8))):
                n_bad = int((merged[:, sl] != untiled[:, sl]).sum())
                if n_bad:
                    raise CheckFailed(f"level_input_tile {grid} {dtype_name} {h}x{w_}: {n_bad} "
                                      f"{part} values differ from the untiled kernel's")
            if not torch.equal(got[:, :3], ref[:, :3]):
                raise CheckFailed(f"level_input_tile {grid} {dtype_name} {h}x{w_}: fst differs "
                                  "from the plain version")
            up_check = compare([(got[:, 6:8], ref[:, 6:8])], 1e-4)
            want = G.reference(snd, G.warp_grid(merged[:, 6:8]))
            check = compare([(merged[:, 3:6], want)], 1e-5)
            warp_equal = bool(torch.equal(merged[:, 3:6], untiled[:, 3:6]))
            cases.append(dict(grid=grid, shape=f"{h}x{w_}", max_abs_err=check[0],
                              check_value=check[1], up_max_abs_err=up_check[0],
                              up_check_value=up_check[1], warp_equals_untiled_kernel=warp_equal))
            log(f"  level_input_tile    {dtype_name:<8} {grid} {h}x{w_}: fst, up equal to the "
                f"untiled kernel's, warp {'equal' if warp_equal else 'not equal'}; up against "
                f"the plain version max_abs_err {up_check[0]:.3e} [{up_check[3]}: "
                f"{up_check[1]:.3g}]; warp max_abs_err {check[0]:.3e} [{check[3]}: "
                f"{check[1]:.3g}]")
            if not (up_check[1] <= up_check[2] and check[1] <= check[2]):
                raise CheckFailed(f"level_input_tile {grid} {dtype_name} {h}x{w_}: disagrees "
                                  "with its plain version")
            if not (grid == "tile4" and lvl == 0):
                continue
            n_ops = device_ops(lambda: G.launch_level_input_tile(*args))
            if n_ops[0] != 1:
                raise CheckFailed(f"level_input_tile {dtype_name}: {n_ops[0]} device operations "
                                  "per call, 1 expected")
            n, S = ft.shape[0], args[1].shape[0]
            th, tw = ft.shape[2:]
            src = G.tile_sources(args[1], n)
            grid_lib = G.tile_grid(got[:, 6:8], origins, *level).to(dt)
            row = (check, timed_ms(torch, lambda: G.launch_level_input_tile(*args), flush=flush),
                   timed_ms(torch, lambda: G.level_input_tile_reference(*args), flush=flush),
                   timed_ms(torch, lambda: F.grid_sample(src, grid_lib, mode="bilinear",
                                                         padding_mode="zeros",
                                                         align_corners=True), flush=flush))
            nbytes = ((n * 3 * th * tw + S * 3 * h * w_ + window.numel() + n * 8 * th * tw)
                      * esize + origins.numel() * 4)
            extra = dict(device_ops=n_ops[0], device_ms=n_ops[1], tiles=n, tile=f"{th}x{tw}",
                         whole_level=f"{S}x3x{h}x{w_}", window=f"{tuple(window.shape)}")
            del src, grid_lib
        del fst, snd, cflow, got, ref, untiled, merged, want, args
    record_row(rows, "level_input_tile", dtype_name, *row, nbytes=nbytes,
               # per pixel: 2 x 6 for the upsample, 8 for the grid, 3 x 8 for the taps
               flops=2 * H * W * 44, op_dtype="float32", extra=dict(extra, cases=cases))


def payload_tile_rows(torch, rows, dt, dtype_name, flush):
    """K2's payload entry on tile origins (the depth-weighted and gated
    projections on partitioned frames), the payload built inside its
    scatter, on the tiles of (data 1, tile 4) at 768x1344, B = 2, phase 2's
    +-20 px flows in ``dt`` with their out-of-frame blocks: N7's depth tiles
    (P = 3, depths in quarters) and N8's frame1 tiles and frame2's whole
    level (P = 4, the gate at 20/255).  Against its plain version the last
    plane exactly (the depth sums; the gate's counts, every gate decision)
    and the sums within 1e-5 of their scale, and the last plane against the
    untiled payload entry's folded one exactly; at most 3 device operations
    per call; timed beside its plain version and index_add_ of the same
    payload, built beforehand, into a whole-frame buffer."""
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling
    from memcnet_tpu_torch.probe import device_ops, synthetic_flow

    dev = torch.device("cuda")
    esize = torch.tensor([], dtype=dt).element_size()
    gen = torch.Generator().manual_seed(13)
    flow = synthetic_flow(2, dev).to(dt)
    depth = (torch.randint(0, 5, (2, 1, H, W), generator=gen) * 0.25 + 0.5).to(dev)
    f1 = torch.rand((2, 3, H, W), generator=gen).to(dev)
    f2 = (f1 + 0.05 * torch.randn((2, 3, H, W), generator=gen).to(dev)).clamp(0.0, 1.0)
    threshold = 20.0 / 255.0
    mesh = tile_mesh(torch, "tile4")
    with spatial_tiling(mesh, halo=TILE_HALO):
        shard_frames(mesh, torch.zeros((1, 1, H, W), device=dev))
        p = active_partition()
        ft = p.split(flow)
        n = ft.shape[0]
        S, (th, tw) = p.samples(n), ft.shape[2:]
        org = p.origins((H, W), n, dev)
        keep = p.mask(ft)
        cases = {3: ("depth", (depth,), (p.split(depth),)),
                 4: ("gated", (f1, f2), (p.split(f1), p.gather(p.split(f2), (H, W))))}
    # the library call's cells: each owned tile pixel's landing in the frame
    o = org.long()
    x2 = (o[:, 1].view(n, 1, 1) + torch.arange(tw, device=dev).view(1, 1, tw)).float() \
        + ft[:, 0].float()
    y2 = (o[:, 0].view(n, 1, 1) + torch.arange(th, device=dev).view(1, th, 1)).float() \
        + ft[:, 1].float()
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    if keep is not None:
        valid &= keep[:, 0] > 0
    cell = ((torch.arange(n, device=dev) % S).view(n, 1, 1) * (H * W)
            + y2.to(torch.int32).clamp(0, H - 1).long() * W
            + x2.to(torch.int32).clamp(0, W - 1).long())
    cell = torch.where(valid, cell, 0).reshape(-1)
    for planes, (op, ins, tins) in cases.items():
        name = f"base_scatter_payload_tile[P={planes}]"

        def entry():
            return P.launch_payload_tile(op, ft, tins, threshold, org, S, H, W)

        got = entry()
        ref = P.payload_tile_reference(op, ft, tins, threshold, org, S, H, W)
        untiled = P.fold(P.launch_payload(op, flow, ins, threshold, False)[0])
        if not torch.equal(got[:, -1], ref[:, -1]):
            raise CheckFailed(f"{name} {dtype_name}: the last plane differs from the plain "
                              "version's (a depth sum or a gate decision)")
        if not torch.equal(got[:, -1], untiled[:, -1]):
            raise CheckFailed(f"{name} {dtype_name}: the last plane differs from the untiled "
                              "entry's")
        scale = max(1.0, float(ref.abs().max()))
        check = compare([(got, ref)], 1e-5 * scale)
        n_ops, dev_ms, by_kernel = device_ops(entry)
        if not 1 <= n_ops <= 3:
            raise CheckFailed(f"{name} {dtype_name}: {n_ops} device operations per call, at "
                              "most 3 expected")
        pt = P.op_payload(op, ft, tins, threshold, org)
        src = torch.where(valid[:, None], pt, 0.0).permute(0, 2, 3, 1).reshape(-1, planes)

        def lib_scatter():  # the same payload into a whole-frame buffer, one PyTorch call
            return torch.zeros(S * H * W, planes, device=dev).index_add_(0, cell, src)

        log(f"  {name} {dtype_name}: device ops per call {n_ops}, device ms {dev_ms:.4f}: "
            + ", ".join(f"{k[:40]} {v:.4f}" for k, v in by_kernel.items()))
        # reads the flow tiles and the op's inputs (N7: the depth tiles; N8: the frame1
        # tiles and frame2's whole level), writes the samples' whole-frame sums
        in_bytes = sum(t.numel() * t.element_size() for t in tins)
        record_row(rows, name, dtype_name, check,
                   timed_ms(torch, entry, flush=flush),
                   timed_ms(torch, lambda: P.payload_tile_reference(op, ft, tins, threshold, org,
                                                                    S, H, W), flush=flush),
                   timed_ms(torch, lib_scatter, flush=flush),
                   nbytes=n * th * tw * 2 * esize + in_bytes + S * planes * H * W * 4
                   + org.numel() * 4, flops=0, op_dtype="float32",
                   extra=dict(device_ops=n_ops, device_ms=dev_ms, by_kernel=by_kernel, tiles=n,
                              tile=f"{th}x{tw}", scale=scale, valid_pixels=int(valid.sum())))
        del got, ref, untiled, src, pt
    del cases, flow, ft, cell


def phase_tile_entries(torch, results):
    """The tile entries against their plain versions, and the tiled ops
    against the global ones, at star's 768x1344 (see the module docstring)."""
    from memcnet_tpu_torch import ops
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.ops.cuda import project_kernel as P
    from memcnet_tpu_torch.ops.cuda import warp_kernel
    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.parallel import tiling as T
    from memcnet_tpu_torch.probe import device_ops

    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    flows = probe.tile_flows(dev)
    rows, whole = {}, {}
    for dtype_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        esize = torch.tensor([], dtype=dt).element_size()
        frame = torch.rand((1, 3, H, W), generator=gen, device=dev).to(dt)
        ctx = torch.randn((1, 64, H, W), generator=gen, device=dev).to(dt)
        filt = (torch.rand((1, 16, H, W), generator=gen, device=dev) / 8.0).to(dt)
        # K1's tile entry on tiles whose width (330) is a multiple of neither
        # its block's 16 columns nor 32: the frame 24 columns narrower, (1, 4)
        wc = W - 24
        ring, exts, fl, fi, org, hh = tile_inputs(
            torch, tile_mesh(torch, "tile4"), None,
            (frame[..., :wc].contiguous(), ctx[..., :wc].contiguous()),
            flows["pm20"][:1, :, :, :wc].contiguous(), filt[..., :wc].contiguous())
        geom = (TILE_HALO, hh, 4, wc, H)
        got = warp_kernel.launch_tile(exts, fl, fi, org, *geom)
        ref = warp_kernel.tile_reference(exts, fl, fi, org, *geom)
        n, _, He, We = exts[0].shape
        nvalid = int(warp_kernel.tile_taps(fl, org, TILE_HALO, hh, 4, wc, H)[0].sum())
        record_row(rows, f"filter_interp_warp_tile[tile4 w{fl.shape[3]} pm20]", dtype_name,
                   compare(list(zip(got, ref)), 1e-4), None, None, None,
                   nbytes=n * (He * We * 67 * esize + H * wc // n * (2 * 4 + 16 * esize
                                                                      + 67 * esize)),
                   flops=nvalid * 2 * 16 * 67, op_dtype="float32",
                   extra=dict(valid_pixels=nvalid, tiles=n))
        for grid, axis_h in TILE_GRIDS:
            mesh = tile_mesh(torch, grid)
            for fname, flow2 in flows.items():
                tag = f"{grid} {fname}"
                timed = grid == "tile4" and fname == "pm20"
                f1 = flow2[:1].contiguous()
                flow_dt = flow2.to(dt)
                # --- K1's tile entry
                ring, exts, fl, fi, org, hh = tile_inputs(torch, mesh, axis_h, (frame, ctx), f1,
                                                          filt)
                geom = (TILE_HALO, hh, 4, W, H)
                got = warp_kernel.launch_tile(exts, fl, fi, org, *geom)
                ref = warp_kernel.tile_reference(exts, fl, fi, org, *geom)
                check = compare(list(zip(got, ref)), 1e-4)
                n, _, He, We = exts[0].shape
                nvalid = int(warp_kernel.tile_taps(fl, org, TILE_HALO, hh, 4, W, H)[0].sum())
                k_ms = p_ms = None
                if timed:
                    k_ms = timed_ms(torch, lambda: warp_kernel.launch_tile(exts, fl, fi, org,
                                                                           *geom), flush=flush)
                    p_ms = timed_ms(torch, lambda: warp_kernel.tile_reference(exts, fl, fi, org,
                                                                              *geom),
                                    reps=3, flush=flush)
                record_row(rows, f"filter_interp_warp_tile[{tag}]", dtype_name, check,
                           k_ms, p_ms, None,
                           nbytes=n * (He * We * 67 * esize + H * W // n * (2 * 4 + 16 * esize
                                                                              + 67 * esize)),
                           flops=nvalid * 2 * 16 * 67, op_dtype="float32",
                           extra=dict(valid_pixels=nvalid, tiles=n))
                # --- K2's tile entry
                ring, _, fl2, _, org2, hh = tile_inputs(torch, mesh, axis_h, (flow_dt,), flow_dt,
                                                        None)
                got = P.launch_tile_sums(fl2, org2, TILE_HALO, hh, W, H)
                ref = P.tile_sums_reference(fl2, org2, TILE_HALO, hh, W, H)
                if not torch.equal(got[:, 2], ref[:, 2]):
                    raise CheckFailed(f"base_scatter_tile {tag} {dtype_name}: counts differ from "
                                      "the plain version")
                n2, _, He2, We2 = got.shape
                lib_ms = k_ms = p_ms = None
                if timed:
                    k_ms = timed_ms(torch, lambda: P.launch_tile_sums(fl2, org2, TILE_HALO, hh, W,
                                                                      H), flush=flush)
                    p_ms = timed_ms(torch, lambda: P.tile_sums_reference(fl2, org2, TILE_HALO,
                                                                         hh, W, H),
                                    reps=3, flush=flush)
                    lib_ms = tile_scatter_library_ms(torch, P, fl2, org2, hh, flush)
                # float32 sums of up to ~10 values of |f| <= 20 in a run-dependent order;
                # reads each tile's flow (its own Hl x Wl) and writes the extended sums
                record_row(rows, f"base_scatter_tile[{tag}]", dtype_name,
                           compare([(got, ref)], 1e-3), k_ms, p_ms, lib_ms,
                           nbytes=n2 * (fl2.shape[2] * fl2.shape[3] * 2 * esize
                                        + 3 * He2 * We2 * 4), flops=0,
                           op_dtype="float32")
                # --- K3's tile entry, on the plain pipeline's average and counts: bits and
                # masks exact, on its own (the tiles stacked) and with every carry given
                avg, cnt, ring = T._tiled_average(mesh, flow_dt, TILE_HALO, "tile", axis_h,
                                                  None)
                stacks = (ring.stacked("tile"), ring.stacked(axis_h) if axis_h else None)
                got, masks = P.launch_fill_tiles(avg, cnt, stacks, None, None, None, dt,
                                                 with_masks=True)
                ref = T.tiled_fill_reference(avg, cnt, ring, "tile", axis_h, dt)
                has = cnt > 0.0
                want = P.pack_masks(has)
                if not (torch.equal(masks.rows, want.rows) and torch.equal(masks.cols,
                                                                           want.cols)):
                    raise CheckFailed(f"fill_holes_carry {tag} {dtype_name}: masks differ from "
                                      "the plain version's")
                left, right = T._row_carries(avg, has, ring, "tile")
                up = T._up_carry(avg, has, ring, axis_h) if axis_h else None
                given = P.launch_fill_tiles(avg, cnt, (None, None), left, right, up, dt)
                for mode, out in (("stacked", got), ("carries given", given)):
                    if not torch.equal(out, ref):
                        raise CheckFailed(f"fill_holes_carry {tag} {dtype_name} ({mode}): not "
                                          "the plain composition's bits")
                holes = int((~has).sum())
                carried = int(((left[:, 0] > 0) | (right[:, 0] > 0)).sum())
                if fname == "invalid" and not axis_h and (holes != has.numel() or got.any()):
                    raise CheckFailed(f"fill_holes_carry {tag} {dtype_name}: an all-invalid "
                                      f"flow left {has.numel() - holes} projected pixels or a "
                                      "nonzero fill")
                fill_ops = fill_count(torch, lambda: T._tiled_fill(avg, cnt, ring, "tile",
                                                                    axis_h, dt),
                                      f"the tiled fill {tag} {dtype_name}")
                k_ms = p_ms = None
                if timed:
                    k_ms = timed_ms(torch, lambda: P.launch_fill_tiles(
                        avg, cnt, stacks, None, None, None, dt), flush=flush)
                    p_ms = timed_ms(torch, lambda: T.tiled_fill_reference(
                        avg, cnt, ring, "tile", axis_h, dt), reps=3, flush=flush)
                Hl, Wl = avg.shape[2:]
                # reads the average and the counts, writes the filled tiles
                record_row(rows, f"fill_holes_carry[{tag}]", dtype_name,
                           compare([(got, ref)], 0.0), k_ms, p_ms, None,
                           nbytes=avg.shape[0] * Hl * Wl * (2 * 4 + 4 + 2 * esize),
                           flops=0, op_dtype="float32",
                           extra=dict(holes=holes, rows_with_a_carry=carried, **fill_ops))
                # --- the tiled ops against the global ones (within the halo budget)
                if fname == "invalid" and axis_h:
                    continue  # the vertical clamp moves these landings by contract
                kw = dict(halo=TILE_HALO, axis_h=axis_h)
                w_t = T.tiled_filter_interp_warp_split(mesh, (frame, ctx), f1, filt, **kw)
                w_g = ops.filter_interp_warp_split((frame, ctx), f1, filt)
                p_t = T.tiled_flow_project(mesh, flow_dt, fillhole=True, **kw)
                p_g = ops.flow_project(flow_dt, fillhole=True)
                wc = compare(list(zip(w_t, w_g)), 1e-4)
                # the spill bands add in another order than the global fold: float32
                # sums of values |f| <= 40 that may nearly cancel, then one rounding
                pc = compare([(p_t, p_g)], 1e-4, long_sums=True)
                entry = dict(warp_max_abs_err=wc[0], warp_check=wc[1], project_max_abs_err=pc[0],
                             project_check=pc[1])
                log(f"  tiled vs global {tag} {dtype_name}: warp max_abs_err {wc[0]:.3e} "
                    f"[{wc[3]}: {wc[1]:.3g}], flow_project max_abs_err {pc[0]:.3e} "
                    f"[{pc[3]}: {pc[1]:.3g}]")
                if not (wc[1] <= wc[2] and pc[1] <= pc[2]):
                    raise CheckFailed(f"tiled ops {tag} {dtype_name}: differ from the global ops")
                if fname == "pm20":
                    calls = {
                        "warp tiled": lambda: T.tiled_filter_interp_warp_split(
                            mesh, (frame, ctx), f1, filt, **kw),
                        "warp global": lambda: ops.filter_interp_warp_split((frame, ctx), f1,
                                                                            filt),
                        "flow_project tiled": lambda: T.tiled_flow_project(
                            mesh, flow_dt, fillhole=True, **kw),
                        "flow_project global": lambda: ops.flow_project(flow_dt, fillhole=True)}
                    for cname, fn in calls.items():
                        K.reset_counters()
                        fn()
                        launched = {k: v for k, v in K.launch_counts().items() if v}
                        n_ops, dev_ms, _ = device_ops(fn)
                        entry[cname] = dict(launches=launched, device_ops=n_ops,
                                            device_ms=dev_ms,
                                            ms=timed_ms(torch, fn, reps=5, flush=flush))
                        log(f"    {cname:<20} launches {launched}, {n_ops} device operations, "
                            f"device ms {dev_ms:.4f}, {entry[cname]['ms']:.4f} ms by events")
                whole[f"{tag} {dtype_name}"] = entry
    results["tile_entries"] = dict(kernels=rows, tiled_vs_global=whole)
    torch.cuda.empty_cache()


def tile_scatter_library_ms(torch, P, flow, origins, hh, flush):
    """One PyTorch call for the tile entry's base scatter: scatter_add_ of
    the (-fx, -fy, 1) payload at the landing cells of the extended buffer."""
    n, _, Hl, Wl = flow.shape
    He, We = Hl + 2 * hh, Wl + 2 * TILE_HALO
    f = flow.float()
    fx = f[:, 0].clamp(-(TILE_HALO - 1), TILE_HALO - 1)
    fy = f[:, 1].clamp(-(hh - 1), hh - 1) if hh else f[:, 1]
    xo = origins[:, 0].long().view(n, 1, 1)
    yo = origins[:, 1].long().view(n, 1, 1)
    x2 = (xo + torch.arange(Wl, device=f.device).view(1, 1, Wl)).float() + fx
    y2 = (yo + torch.arange(Hl, device=f.device).view(1, Hl, 1)).float() + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= W - 1) & (y2 <= H - 1)
    ix = x2.to(torch.int32).clamp(0, W - 1).long() - xo + TILE_HALO
    iy = y2.to(torch.int32).clamp(0, H - 1).long() - yo + hh
    lin = torch.where(valid, iy * We + ix, 0).view(n, 1, -1).expand(n, 3, Hl * Wl)
    payload = torch.where(valid[:, None], torch.stack([-fx, -fy, torch.ones_like(fx)], 1), 0.0)
    payload = payload.reshape(n, 3, -1).contiguous()
    return timed_ms(torch, lambda: torch.zeros(n, 3, He * We, device=f.device).scatter_add_(
        2, lin, payload), flush=flush)


def phase_tiled_serve(torch, results):
    """MEMC_Net_star served at 720p in bf16 under spatial_tiling (tile 4,
    halo 64) through PaddedInterp, against the untiled forward on the same
    pairs (see TILED_SERVE_TOL).  Random weights give flows of about 1e-8
    px, so FlowNetS's last conv (the flow is linear in it) is scaled first to
    give flows of about TILED_FLOW_PX, which the halos must then carry."""
    from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.parallel import spatial_tiling

    model = build_model("MEMC_Net_star", seed=0, dtype=torch.bfloat16, device="cuda")
    interp = PaddedInterp(model, dtype=torch.bfloat16, device="cuda")
    mesh = tile_mesh(torch, "tile4")
    pairs = [synthetic_frames(10 + s) for s in range(TILED_PAIRS)]
    raw = max(float(np.abs(o).max()) for o in interp(*pairs[0])[1]["offsets"])
    with torch.no_grad():
        model.flownets.predict_flow2.weight.mul_(TILED_FLOW_PX / raw)
    untiled, ms_untiled = [], []
    for x0, x2 in [pairs[0]] + pairs:  # the first is a warm-up
        t0 = time.perf_counter()
        untiled.append(interp(x0, x2))
        ms_untiled.append((time.perf_counter() - t0) * 1e3)
    untiled, ms_untiled = untiled[1:], ms_untiled[1:]
    with spatial_tiling(mesh, halo=TILE_HALO):
        interp(*pairs[0])  # warm-up, not counted
        torch.cuda.synchronize()
        K.reset_counters()
        outs, ms = [], []
        for x0, x2 in pairs:
            t0 = time.perf_counter()
            outs.append(interp(x0, x2))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
    expect = {k: v * TILED_PAIRS for k, v in EXPECTED_TILED_FRAME.items()}
    worst, flow_max = 0.0, 0.0
    for (out, aux), (ref, ref_aux) in zip(outs, untiled):
        if out.shape != (3, FRAME_H, FRAME_W) or not np.isfinite(out).all():
            raise CheckFailed(f"tiled star: output shape {out.shape}, finite "
                              f"{np.isfinite(out).all()}")
        worst = max(worst, float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max())))
        flow_max = max(flow_max, *(float(np.abs(o).max()) for o in ref_aux["offsets"]))
    log(f"  MEMC_Net_star bf16 720p under spatial_tiling (tile 4, halo {TILE_HALO}): "
        f"{TILED_PAIRS} pairs, ms/frame {', '.join(f'{m:.3f}' for m in ms)} (untiled "
        f"{', '.join(f'{m:.3f}' for m in ms_untiled)}); launches {counts}; against the untiled "
        f"forward: max err {worst:.3e} of the output's scale (tol {TILED_SERVE_TOL}); largest "
        f"projected flow {flow_max:.3f} px (halo budget {TILE_HALO - 4}; random weights gave "
        f"{raw:.3e} px before FlowNetS's last conv was scaled)")
    results["tiled_serve"] = dict(ms_per_frame=ms, untiled_ms_per_frame=ms_untiled,
                                  launches=counts, rel_err=worst, flow_max=flow_max,
                                  flow_max_random=raw)
    if counts != expect:
        raise CheckFailed(f"tiled star: launches {counts}, expected {expect}")
    if not worst <= TILED_SERVE_TOL or not 1.0 <= flow_max <= TILE_HALO - 4:
        raise CheckFailed(f"tiled star: differs from the untiled forward ({worst}) or its flows "
                          f"leave the halo budget ({flow_max})")
    del model, interp
    torch.cuda.empty_cache()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_nccl_step(torch, results):
    """One float32 MEMC_Net_star step at 256x448 on a one-rank NCCL group
    through DataParallelStep (DDP) and ZeroAdamax, against TrainStep and
    Adamax on the same card: the loss within 1e-6 relative, the parameters
    within 1e-6 on at least 99.9% of their elements and within 2 lr
    everywhere (the projection's atomics sum in a run-dependent order, and
    Adamax's first update is about lr * sign(g))."""
    import torch.distributed as dist

    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.parallel import make_mesh
    from memcnet_tpu_torch.parallel.step import DataParallelStep
    from memcnet_tpu_torch.train.trainer import interp_loss_fn
    from memcnet_tpu_torch.parallel.zero import ZeroAdamax
    from memcnet_tpu_torch.train.trainer import Adamax, TrainStep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    x = [rng.rand(1, 3, NCCL_H, NCCL_W).astype(np.float32) for _ in range(3)]
    ref_model = build_model("MEMC_Net_star", seed=0, device="cuda")
    ref_loss = TrainStep(ref_model, Adamax(ref_model, lr=TRAIN_LR), interp_loss_fn(ref_model),
                         "cuda")(*x)
    want = {k: v.detach().clone() for k, v in ref_model.named_parameters()}
    del ref_model
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(group=dist.group.WORLD)
        model = build_model("MEMC_Net_star", seed=0, device="cuda")
        opt = ZeroAdamax(model, mesh.group, lr=TRAIN_LR)
        step = DataParallelStep(model, opt, interp_loss_fn(model), mesh.axis_group("data"),
                                "cuda")
        loss = step(*x)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    total = close = 0
    worst = 0.0
    for k, p in model.named_parameters():
        d = (p.detach() - want[k]).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        close += int((d <= 1e-6).sum())
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    log(f"  one-rank {backend} step, MEMC_Net_star float32 {NCCL_H}x{NCCL_W}: loss "
        f"{float(loss):.6f} against {float(ref_loss):.6f} (rel {rel:.2e}); parameters within "
        f"1e-6 on {close / total:.6f} of elements, max {worst:.3e} (2 lr = {2 * TRAIN_LR:.1e})")
    results["nccl_step"] = dict(backend=backend, loss=float(loss), ref_loss=float(ref_loss),
                                loss_rel=rel, params_close_share=close / total,
                                params_max_abs=worst, mesh=dict(mesh.shape))
    if not (rel <= 1e-6 and close >= 0.999 * total and worst <= 2 * TRAIN_LR * (1 + 1e-3)):
        raise CheckFailed("one-rank NCCL step: differs from TrainStep with Adamax")
    del model, opt, step
    torch.cuda.empty_cache()


def phase_multihost(torch, results, work):
    """demo_hd720p --multihost as two processes on the one card (a gloo host
    group from MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK)
    over phase 5's synthetic stream in 4 GOPs, against one process."""
    from memcnet_tpu_torch import probe
    from memcnet_tpu_torch.cli import demo_hd720p
    from memcnet_tpu_torch.parallel.gop import split_gops, stitch_parts

    src = probe.write_yuv(os.path.join(work, "mh.yuv"),
                          probe.moving_frames(0, HD_FRAMES + 1, FRAME_H, FRAME_W))

    def argv(out, journal):
        return ["--yuv", src, "--height", str(FRAME_H), "--width", str(FRAME_W), "--frames",
                str(HD_FRAMES), "--out-dir", out, "--gop-len", str(MH_GOP_LEN), "--net-name",
                "MEMC_Net_star", "--dtype", "bfloat16", "--uid", "mh", "--journal", journal]

    base_out, mh_out = os.path.join(work, "mh_base"), os.path.join(work, "mh_two")
    pairs = len([p for g in split_gops(HD_FRAMES + 1, MH_GOP_LEN) for p in g.pairs()])
    run_demo(torch, results, "demo_hd720p_one_process", demo_hd720p.main,
             argv(base_out, os.path.join(work, "mh_base.journal")), pairs,
             EXPECTED_PER_FRAME["MEMC_Net_star"])
    journal = os.path.join(work, "mh_two.journal")
    port = str(free_port())
    logs = [open(os.path.join(OUT_DIR, f"multihost_rank{r}.log"), "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "memcnet_tpu_torch.cli.demo_hd720p", *argv(mh_out, journal),
         "--multihost"], cwd=HERE, stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="localhost", MASTER_PORT=port,
                 WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    try:
        rcs = [p.wait(timeout=MH_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall_s = time.perf_counter() - t0
    texts = [open(os.path.join(OUT_DIR, f"multihost_rank{r}.log")).read() for r in range(2)]
    if rcs != [0, 0]:
        raise CheckFailed(f"demo_hd720p --multihost: exit codes {rcs}:\n{texts[0][-2000:]}\n"
                          f"{texts[1][-2000:]}")
    gen_dir = os.path.join(mh_out, "mh")
    parts = [os.path.join(gen_dir, f"mh.yuv.part{r}") for r in range(2)]
    sizes = [os.path.getsize(p) if os.path.exists(p) else 0 for p in parts]
    gids = sorted(int(x) for x in open(journal).read().split())
    want_gids = [g.gop_id for g in split_gops(HD_FRAMES + 1, MH_GOP_LEN)]
    stitched = stitch_parts(parts, os.path.join(gen_dir, "stitched.yuv"),
                            n_frames=HD_FRAMES + 1, height=FRAME_H, width=FRAME_W,
                            gop_len=MH_GOP_LEN)
    base = open(os.path.join(base_out, "mh", "mh.yuv"), "rb").read()
    equal = open(stitched, "rb").read() == base
    both = all(f"process {r}/2" in texts[r] for r in range(2))
    log(f"  demo_hd720p --multihost, 2 processes on one card, {len(want_gids)} GOPs: part bytes "
        f"{sizes}, journal {gids}, stitched stream byte-equal to one process {equal}; "
        f"wall {wall_s:.1f} s (logs in chiprun_out/chip_smoke/multihost_rank*.log)")
    results["multihost"] = dict(part_bytes=sizes, journal=gids, byte_equal=equal, wall_s=wall_s,
                                gops=len(want_gids))
    if not (both and all(sizes) and sum(sizes) == len(base) and gids == want_gids and equal):
        raise CheckFailed("demo_hd720p --multihost: both processes must work, the journal hold "
                          "every GOP once and the stitched stream equal one process's")


def phase_parallel(torch, results):
    """Phase 8: the tile entries, star tiled, the NCCL step, the multihost demo."""
    import tempfile

    phase_tile_entries(torch, results)
    phase_tiled_serve(torch, results)
    phase_nccl_step(torch, results)
    with tempfile.TemporaryDirectory() as work:
        phase_multihost(torch, results, work)


# ---------------------------------------------------------------------------
# phase 9: partitioned convolutions (parallel/partition.py)

PART_MODELS = ("MEMC_Net_star", "MEMC_Net", "MEMC_Net_s", "MEMC_Net_VE")
PART_PAIRS = 2               # pairs (VE: windows) per model and grid
PART_REPS = 5                # forwards timed by CUDA events (median)
# per frame (VE: per window); MEMC_Net_s: SPyNet's 6 levels at 720p, 5 K4 and one
# K5 tile entry each
EXPECTED_PART_FRAME = {
    name: {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
           "conv2d_small": {"MEMC_Net_star": 1, "MEMC_Net_s": 30, "MEMC_Net_VE": 1}.get(name, 0),
           "grid_sample": 0, "filter_interp_warp_tile": 2, "base_scatter_tile": 1,
           "fill_holes_carry": 1, "level_input_tile": 6 if name == "MEMC_Net_s" else 0,
           "base_scatter_payload_tile": 0}
    for name in PART_MODELS}
EXPECTED_PART_FRAME["MEMC_Net_VE"].update(filter_interp_warp_tile=1, base_scatter_tile=0,
                                          fill_holes_carry=0)
# the serving checks: float32, the 99.9th percentile of |partitioned - untiled|
# within PART_F32_TOL of each output's scale (a few landing cells may flip on
# float32 noise); bf16, no further from the float32 forward of the same weights
# than the untiled bf16 forward is (PART_BF16_RATIO on the mean and the 99.9th
# percentile): the convs of a tile round in another order than the whole
# frame's, which on an H100 moves bf16 outputs by more than 1e-2 of their scale
# on about 1.6% of star's values (PERF.md, phase 9)
PART_F32_TOL = 1e-4
PART_BF16_RATIO = 1.25
PART_STEP_H, PART_STEP_W = 256, 448   # the sharded step's frames (Vimeo-90K's size)
PART_STEP_TOL = 1e-5                  # the step's loss, relative
# the step's parameters: within 1e-6 on at least 99.9% of elements and within 2
# lr everywhere, phase 8's rule (Adamax's first update is about lr * sign(g): an
# element whose gradient float32 noise moves across 0 moves by 2 lr); within
# 1e-5 of each tensor's largest is reported beside it (0.999290 on an H100,
# near the 0.999 bound, PERF.md)
PART_PARAM_TOL = 1e-6
EXPECTED_PART_STEP = {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                      "conv2d_small": 1, "grid_sample": 0, "filter_interp_warp_tile": 2,
                      "base_scatter_tile": 1, "fill_holes_carry": 0, "level_input_tile": 0,
                      "base_scatter_payload_tile": 0}


def peak_bytes(torch, fn):
    """max_memory_allocated over one call (weights and inputs included)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())


def profile_partitioned(torch, fn):
    """(device operations, device ms, halo gathers' device ms, whole-level
    gathers' device ms, top kernels, whole-level reductions' device ms) of
    one call after a warm-up: kernels and memsets, and the device time of
    the kernels under parallel.partition's HALO_RANGE, GATHER_RANGE and
    REDUCE_RANGE."""
    from torch.profiler import ProfilerActivity, profile

    from memcnet_tpu_torch.parallel.partition import GATHER_RANGE, HALO_RANGE, REDUCE_RANGE

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    evs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in evs if e.device_type == cuda and e.self_device_time_total > 0
           and e.key not in (HALO_RANGE, GATHER_RANGE, REDUCE_RANGE)]

    def range_ms(key):
        return max((e.device_time_total for e in evs if e.key == key and e.device_type != cuda),
                   default=0.0) / 1e3

    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return (sum(e.count for e in dev), sum(e.self_device_time_total for e in dev) / 1e3,
            range_ms(HALO_RANGE), range_ms(GATHER_RANGE),
            {e.key[:80]: round(e.self_device_time_total / 1e3, 4) for e in top},
            range_ms(REDUCE_RANGE))


def out_errs(torch, got, want):
    """|got - want| over want's scale (its largest |value|, at least 1):
    the largest, the mean, the 99.9th percentile and the share beyond 1e-2."""
    d = (got.float() - want.float()).abs().flatten() / max(1.0, float(want.float().abs().max()))
    k = max(1, int(0.999 * d.numel()))
    return dict(max=float(d.max()), mean=float(d.mean()), p999=float(d.kthvalue(k).values),
                share_1e2=float((d > 1e-2).float().mean()))


def worst(errs, key):
    return max(e[key] for e in errs.values())


def scale_part_flows(torch, model, flow_max):
    """Scale the flow net's last conv so that ``flow_max()`` (the largest
    served flow, px) reaches about TILED_FLOW_PX: FlowNetS's predict_flow2
    (the flow is linear in it), or SPyNet's coarsest level's last conv, whose
    residual doubles at every finer level (three rounds: the finer levels'
    warps move with it).  Returns the flow of the random weights."""
    raw = flow_max()
    with torch.no_grad():
        if hasattr(model.flownets, "moduleBasic"):
            top = model.flownets.moduleBasic[0].moduleBasic[8]
            k = TILED_FLOW_PX / raw
            for _ in range(3):
                top.weight.mul_(k)
                top.bias.mul_(k)
                k = TILED_FLOW_PX / flow_max()
        else:
            model.flownets.predict_flow2.weight.mul_(TILED_FLOW_PX / raw)
    return raw


def part_serve(torch, name, items, results):
    """One model: the untiled forward, then the partitioned one on each grid,
    against it (see the module docstring).  ``items``: frame pairs, or
    seven-frame windows for MEMC_Net_VE."""
    from memcnet_tpu_torch.cli.runner import PaddedInterp, PaddedVE, _padded, build_model
    from memcnet_tpu_torch.data import pad_plan
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling
    from memcnet_tpu_torch.parallel import partition

    ve = name == "MEMC_Net_VE"
    bf16, dev = torch.bfloat16, torch.device("cuda")
    fh, fw = (VE_FRAME_H, VE_FRAME_W) if ve else (FRAME_H, FRAME_W)
    model = build_model(name, seed=0, dtype=bf16, device="cuda")
    Padded = PaddedVE if ve else PaddedInterp
    serve = Padded(model, dtype=bf16, device="cuda")
    plan = pad_plan(fh, fw)

    def inputs(item, dt):
        return [_padded(x, plan, dev, dt) for x in item]

    def run(m, xs):
        return m(list(xs), debug=True) if ve else m(*xs)

    def outputs(out):
        if ve:
            return dict(rectified=out[0], flow=out[1], filt=out[2])
        (interp_, rectified), offs, filts, occs = out
        return dict(rectified=rectified, interp=interp_, off0=offs[0], off1=offs[1],
                    filt0=filts[0], filt1=filts[1], occ0=occs[0], occ1=occs[1])

    def flow_max():
        with torch.inference_mode():
            out = outputs(run(model, inputs(items[0], bf16)))
        return max(float(out[k].float().abs().max()) for k in (("flow",) if ve else
                                                                ("off0", "off1")))

    raw = scale_part_flows(torch, model, flow_max)
    # the float32 forward of the same (bf16) weights: the reference of the bf16 check
    model32 = build_model(name, seed=0, device="cuda")
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})

    def served(item):
        got = serve(item) if ve else serve(*item)
        return (got, {}) if ve else got

    served(items[0])  # warm-up
    untiled = [served(item) for item in items]
    xp, xf = inputs(items[0], bf16), inputs(items[0], torch.float32)

    def measure(fwd):
        n_ops, dev_ms, halo_ms, gather_ms, top, _ = profile_partitioned(torch, fwd)
        return dict(ms=timed_ms(torch, fwd, reps=PART_REPS), device_ops=n_ops,
                    device_ms=dev_ms, halo_device_ms=halo_ms, gather_device_ms=gather_ms,
                    peak_bytes=peak_bytes(torch, fwd), top_kernels=top)

    def forward(xs):
        def fwd():
            with torch.inference_mode():
                run(model, xs)
        return fwd

    with torch.inference_mode():
        ref32 = outputs(run(model32, xf))
        ref_bf = outputs(run(model, xp))
    base = {k: out_errs(torch, ref_bf[k], ref32[k]) for k in ref32}
    entry = {"untiled": measure(forward(xp)), "flow_max_random": raw,
             "untiled_bf16_vs_float32": base}
    flow_max = flow_max()
    entry["flow_max"] = flow_max
    u = entry["untiled"]
    size = f"{VE_H}x{VE_W} window" if ve else "720p"
    log(f"  {name} bf16 {size} untiled: forward {u['ms']:.3f} ms by events, {u['device_ops']} "
        f"device operations, device ms {u['device_ms']:.3f}, peak {u['peak_bytes'] / 2**30:.3f} "
        f"GiB; largest flow {flow_max:.3f} px (random weights gave {raw:.3e}); against the "
        f"float32 forward: mean {worst(base, 'mean'):.3e}, p99.9 {worst(base, 'p999'):.3e}, "
        f"max {worst(base, 'max'):.3e} of the output's scale")
    if not 1.0 <= flow_max <= TILE_HALO - 4:
        raise CheckFailed(f"partitioned {name}: flows leave the halo budget ({flow_max})")
    sharded = Padded(model, dtype=bf16, device="cuda", sharded=True)
    for grid, axis_h in TILE_GRIDS:
        mesh = tile_mesh(torch, grid)
        with spatial_tiling(mesh, halo=TILE_HALO, axis_h=axis_h):
            sharded(items[0]) if ve else sharded(*items[0])  # warm-up, not counted
            torch.cuda.synchronize()
            K.reset_counters()
            partition.gathers.reset()
            outs = [(sharded(item), {}) if ve else sharded(*item) for item in items]
            counts = K.launch_counts()
            gathers = partition.gathers.count
            tp = shard_frames(mesh, *xp)
            m = measure(forward(tp))
            with torch.inference_mode():
                part_bf = {k: gather_frames(mesh, v) for k, v in outputs(run(model, tp)).items()}
                part32 = {k: gather_frames(mesh, v) for k, v in
                          outputs(run(model32, shard_frames(mesh, *xf))).items()}
        err = 0.0
        for (out, aux), (ref, ref_aux) in zip(outs, untiled):
            if out.shape != (3, fh, fw) or not np.isfinite(out).all():
                raise CheckFailed(f"partitioned {name} {grid}: output shape {out.shape}, "
                                  f"finite {np.isfinite(out).all()}")
            pairs = [(out, ref)]
            if not ve:
                pairs += [(aux["interp"], ref_aux["interp"]),
                          *zip(aux["offsets"], ref_aux["offsets"])]
            err = max(err, *(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                             for a, b in pairs))
        direct = {k: out_errs(torch, part_bf[k], ref_bf[k]) for k in ref_bf}
        f32 = {k: out_errs(torch, part32[k], ref32[k]) for k in ref32}
        anchored = {k: out_errs(torch, part_bf[k], ref32[k]) for k in ref32}
        expect = {k: v * PART_PAIRS for k, v in EXPECTED_PART_FRAME[name].items()}
        m.update(launches=counts, whole_level_gathers=gathers, served_max_err=err,
                 bf16_vs_untiled=direct, float32_vs_untiled=f32, bf16_vs_float32=anchored,
                 tiles=int(tp[0].shape[0]))
        entry[grid] = m
        log(f"  {name} bf16 {size} partitioned on {grid} (halo {TILE_HALO}): {PART_PAIRS} "
            f"{'windows' if ve else 'pairs'}, launches {counts}, whole-level gathers {gathers}; "
            f"forward {m['ms']:.3f} ms by events (untiled {u['ms']:.3f}), "
            f"{m['device_ops']} device operations ({u['device_ops']}), device ms "
            f"{m['device_ms']:.3f} ({u['device_ms']:.3f}), of which halo gathers "
            f"{m['halo_device_ms']:.3f}, whole-level gathers {m['gather_device_ms']:.3f}; peak "
            f"{m['peak_bytes'] / 2**30:.3f} GiB ({u['peak_bytes'] / 2**30:.3f})")
        log(f"    against the untiled forward, of each output's scale: bf16 served max {err:.3e}"
            f", all outputs max {worst(direct, 'max'):.3e}, mean {worst(direct, 'mean'):.3e}, "
            f"share beyond 1e-2 {worst(direct, 'share_1e2'):.3e}; float32 max "
            f"{worst(f32, 'max'):.3e}, p99.9 {worst(f32, 'p999'):.3e} (tol {PART_F32_TOL}); "
            f"bf16 against the float32 forward mean {worst(anchored, 'mean'):.3e}, p99.9 "
            f"{worst(anchored, 'p999'):.3e} (untiled {worst(base, 'mean'):.3e}, "
            f"{worst(base, 'p999'):.3e})")
        if counts != expect:
            raise CheckFailed(f"partitioned {name} {grid}: launches {counts}, expected {expect}")
        want_gathers = PART_PAIRS * EXPECTED_PART_FRAME[name]["level_input_tile"]
        if gathers != want_gathers:
            raise CheckFailed(f"partitioned {name} {grid}: {gathers} whole-level gathers, "
                              f"expected {want_gathers} (one per SPyNet level)")
        for k in ref32:
            if not f32[k]["p999"] <= PART_F32_TOL:
                raise CheckFailed(f"partitioned {name} {grid}: float32 {k} differs from the "
                                  f"untiled forward ({f32[k]})")
            for key, floor in (("mean", 1e-3), ("p999", 1e-2)):
                if not anchored[k][key] <= max(PART_BF16_RATIO * base[k][key], floor):
                    raise CheckFailed(f"partitioned {name} {grid}: bf16 {k} is further from the "
                                      f"float32 forward than the untiled bf16 forward "
                                      f"({anchored[k]} against {base[k]})")
    results["partition"]["serve"][name] = entry
    del model, model32, serve, sharded
    torch.cuda.empty_cache()


def part_step(torch, results):
    """One float32 MEMC_Net_star step at 256x448 on (1, 4), halo 16, its
    frames sharded (sharded_train_step), against TrainStep on the whole
    frames (see the module docstring)."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.parallel.step import SHARDED_HALO, sharded_train_step
    from memcnet_tpu_torch.train.trainer import Adamax, TrainStep, interp_loss_fn

    rng = np.random.RandomState(5)
    frames = [rng.rand(1, 3, PART_STEP_H, PART_STEP_W).astype(np.float32) for _ in range(3)]
    ref = build_model("MEMC_Net_star", seed=0, device="cuda")
    ref_loss = float(TrainStep(ref, Adamax(ref, lr=TRAIN_LR), interp_loss_fn(ref), "cuda")(
        *frames))
    want = {k: v.detach().clone() for k, v in ref.named_parameters()}
    del ref
    torch.cuda.synchronize()
    K.reset_counters()
    loss, model, _ = sharded_train_step(tile_mesh(torch, "tile4"), None, frames, lr=TRAIN_LR,
                                        device="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    total = close = close_rel = 0
    worst = 0.0
    for k, p in model.named_parameters():
        d = (p.detach() - want[k]).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        close += int((d <= PART_PARAM_TOL).sum())
        close_rel += int((d <= PART_STEP_TOL * float(want[k].abs().max())).sum())
    rel = abs(float(loss) - ref_loss) / abs(ref_loss)
    log(f"  sharded MEMC_Net_star step, float32 {PART_STEP_H}x{PART_STEP_W} on (1, 4), halo "
        f"{SHARDED_HALO}: loss {float(loss):.6f} against TrainStep's {ref_loss:.6f} (rel "
        f"{rel:.2e}); parameters within {PART_PARAM_TOL} on {close / total:.6f} of elements "
        f"(within {PART_STEP_TOL} of each tensor's largest on {close_rel / total:.6f}), max "
        f"{worst:.3e} (2 lr = {2 * TRAIN_LR:.1e}); launches {counts}")
    results["partition"]["step"] = dict(loss=float(loss), ref_loss=ref_loss, loss_rel=rel,
                                        params_close_share=close / total,
                                        params_close_share_rel=close_rel / total,
                                        params_max_abs=worst, launches=counts)
    if counts != EXPECTED_PART_STEP:
        raise CheckFailed(f"sharded step: launches {counts}, expected {EXPECTED_PART_STEP}")
    if not (rel <= PART_STEP_TOL and close >= 0.999 * total
            and worst <= 2 * TRAIN_LR * (1 + 1e-3)):
        raise CheckFailed("sharded step: differs from TrainStep on the whole frames")
    del model
    torch.cuda.empty_cache()


def phase_partition(torch, results):
    """Phase 9: the four models served partitioned, the sharded step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results["partition"] = {"serve": {}}
    pairs = [synthetic_frames(10 + s) for s in range(PART_PAIRS)]
    windows = [synthetic_window(20 + s) for s in range(PART_PAIRS)]
    for name in PART_MODELS:
        part_serve(torch, name, windows if name == "MEMC_Net_VE" else pairs, results)
    part_step(torch, results)


# ---------------------------------------------------------------------------
# phase 10: the op library on partitioned frames

PART_OPS_B = 2
PART_OPS_PAD = (2, 3, 1, 2)           # replication_pad2d's (left, right, top, bottom)
PART_OPS_GRID_CUT = (16, 32)          # the sample grid: (H - 16, W - 32), a derived extent
PART_OPS_TOL = 1e-4                   # of each output's (and gradient's) scale
# the ops whose flows have a halo budget (parallel/tiling.py): +-20 px only
HALO_BUDGET_OPS = ("filter_interp_warp", "filter_interp_warp_split", "flow_project")
# launches per call (the rest zero): N7 and N8 on K2's payload entry on tile
# origins and K3's carry entry, the grid sample on K5's general entry, the
# filter warps and flow_project on their tile entries
PART_OPS_LAUNCHES = {
    "filter_interp_warp": {"filter_interp_warp_tile": 1},
    "filter_interp_warp_split": {"filter_interp_warp_tile": 1},
    "flow_project": {"base_scatter_tile": 1, "fill_holes_carry": 1},
    "depth_flow_project": {"base_scatter_payload_tile": 1, "fill_holes_carry": 1},
    "weighted_flow_project": {"base_scatter_payload_tile": 1, "fill_holes_carry": 1},
    "grid_sample_bilinear": {"grid_sample": 1},
}
# the ops whose fill is parallel/tiling.py's tiled fill: at most 2 device operations
# from avg, cnt to the filled tiles on one card
PART_OPS_FILL = ("flow_project", "depth_flow_project", "weighted_flow_project")
# device operations of a partitioned N7 or N8 call with the fill, at most: K2's payload
# entry (3), the whole-level gather (N8), the reduction, the divide and the fill (2) --
# no PyTorch operation builds a payload (the last PyTorch-built gate took 153)
PART_OPS_PAYLOAD_MAX = 30
# and at least: the payload entry (3), the reduction, the divide and the fill (2); an
# untiled call (4) would pass the cap, not this
PART_OPS_PAYLOAD_MIN = 7
# whole-level (gathers, reductions) per call, forward and backward
PART_OPS_WHOLE = {
    "bilinear_warp": ((1, 0), (0, 0)), "bilinear_warp_ch": ((1, 0), (0, 0)),
    "depth_flow_project": ((0, 1), (1, 0)), "weighted_flow_project": ((1, 1), (1, 0)),
    "occlusion_weight": ((1, 0), (0, 0)), "pixel_splat": ((0, 1), (1, 0)),
    "pixel_value": ((0, 1), (1, 0)), "pixel_weight": ((0, 1), (1, 0)),
    "reliable_weight": ((0, 1), (1, 0)), "grid_sample_bilinear": ((1, 0), (0, 0)),
}
# what falls exactly: zeros where nothing lands or the landing is out of the
# frame, 1e-4 where occlusion_weight's landing is
PART_OPS_MASKS = {"bilinear_warp": 0.0, "bilinear_warp_ch": 0.0, "pixel_splat": 0.0,
                  "pixel_value": 0.0, "pixel_weight": 0.0, "reliable_weight": 0.0,
                  "occlusion_weight": 1e-4, "grid_sample_bilinear": 0.0}


def profile_best(torch, fn, tries=3):
    """``profile_partitioned`` of the profiled call, of up to ``tries``, that
    kept the most device operations (the profiler drops the records of short
    calls late in a run, PERF.md §7; a lost record only lowers a count), or
    None where none kept any."""
    best = None
    for _ in range(tries):
        got = profile_partitioned(torch, fn)
        if best is None or got[0] > best[0]:
            best = got
    return best if best[0] else None


class WholeLevelCalls:
    """Records each ``Partition.gather`` and ``reduce`` of the calls made
    inside it, to time them alone by CUDA events afterwards (``calls``:
    functions that repeat each one)."""

    def __enter__(self):
        from memcnet_tpu_torch.parallel.partition import Partition

        self.orig = (Partition.gather, Partition.reduce)
        self.calls = {"gather": [], "reduce": []}
        gather, reduce = self.orig

        def rec_gather(part, x, size=None):
            self.calls["gather"].append(lambda: gather(part, x.detach(), size))
            return gather(part, x, size)

        def rec_reduce(part, s):
            self.calls["reduce"].append(lambda: reduce(part, s.detach()))
            return reduce(part, s)

        Partition.gather, Partition.reduce = rec_gather, rec_reduce
        return self

    def __exit__(self, *exc):
        from memcnet_tpu_torch.parallel.partition import Partition

        Partition.gather, Partition.reduce = self.orig


def part_ops_calls():
    """(name, fn, input keys) of every name of ops.__all__ and the grid
    sample and replication pad layers; the projections with the fill."""
    from memcnet_tpu_torch import ops
    from memcnet_tpu_torch.nn import layers as L

    calls = {
        "filter_interp_warp": (ops.filter_interp_warp, ("frame1", "flow", "filt")),
        "filter_interp_warp_split": (
            lambda a, c, f, k: ops.filter_interp_warp_split((a, c), f, k),
            ("frame1", "ctx", "flow", "filt")),
        "bilinear_warp": (ops.bilinear_warp, ("frame1", "flow")),
        "bilinear_warp_ch": (ops.bilinear_warp_ch, ("ctx", "flow")),
        "flow_project": (lambda f: ops.flow_project(f, fillhole=True), ("flow",)),
        "depth_flow_project": (lambda f, d: ops.depth_flow_project(f, d, fillhole=True),
                               ("flow", "depth")),
        "weighted_flow_project": (
            lambda f, a, b: ops.weighted_flow_project(f, a, b, fillhole=True),
            ("flow", "frame1", "frame2")),
        "separable_conv": (ops.separable_conv, ("frame1", "vert", "horiz")),
        "separable_conv_flow": (ops.separable_conv_flow, ("vert", "horiz")),
        "occlusion_weight": (ops.occlusion_weight, ("frame1", "frame2", "flow")),
        "pixel_splat": (ops.pixel_splat, ("frame1", "flow", "fw")),
        "pixel_value": (ops.pixel_value, ("frame1", "flow", "fw")),
        "pixel_weight": (ops.pixel_weight, ("flow", "fw")),
        "reliable_weight": (ops.reliable_weight, ("flow",)),
        "replication_pad2d": (lambda a: L.replication_pad2d(a, PART_OPS_PAD), ("frame1",)),
        "grid_sample_bilinear": (L.grid_sample_bilinear, ("frame1", "grid")),
    }
    if set(ops.__all__) - set(calls):
        raise CheckFailed(f"phase 10 misses {set(ops.__all__) - set(calls)}")
    return [(name, fn, keys) for name, (fn, keys) in calls.items()]


def part_ops_inputs(torch, dev):
    """Phase 7's full-width inputs at B = 2 (its fw made B = 2), with
    phase 8's +-20 px flow (within the halo budget, a band landing left of
    the frame), a +-200 px one and a grid of the derived extent
    (H - 16, W - 32), float32 on ``dev``."""
    from memcnet_tpu_torch import probe

    x = oplib_inputs(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    x["fw"] = torch.rand((PART_OPS_B, 1, H, W), generator=gen, device=dev)
    gh, gw = H - PART_OPS_GRID_CUT[0], W - PART_OPS_GRID_CUT[1]
    x["grid"] = torch.rand((PART_OPS_B, gh, gw, 2), generator=gen, device=dev) * 2.2 - 1.1
    flows = {"pm20": probe.tile_flows(dev)["pm20"],
             "pm200": torch.rand((PART_OPS_B, 2, H, W), generator=gen, device=dev) * 400.0
             - 200.0}
    del x["flow"]
    return x, flows


def part_ops_shard(mesh, key, t):
    from memcnet_tpu_torch.parallel import shard_frames

    if key == "grid":  # channels-last: tiled over its dims 1 and 2
        return shard_frames(mesh, t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return shard_frames(mesh, t)


def part_ops_run(torch, name, fn, keys, x, flow, grid, axis_h, cot_seed, profile):
    """One op untiled and partitioned on the card: the launches, gathers
    and reductions of the partitioned call, its outputs gathered whole and
    the VJP of a seeded cotangent, each against the untiled op's; the
    profiled device ms and operations and the peak memory of both."""
    from memcnet_tpu_torch.ops import cuda as K
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling
    from memcnet_tpu_torch.parallel import partition as PT
    from memcnet_tpu_torch.parallel import tiling as T
    from memcnet_tpu_torch.probe import graph_ops

    dev = torch.device("cuda")
    args = [flow if k == "flow" else x[k] for k in keys]

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    xs = [a.detach().clone().requires_grad_(True) for a in args]
    want = as_tuple(fn(*xs))
    gen = torch.Generator(device=dev).manual_seed(cot_seed)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in want]
    want_grads = torch.autograd.grad(want, xs, cots)
    want = [o.detach() for o in want]
    mesh = tile_mesh(torch, grid)
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    with spatial_tiling(mesh, halo=TILE_HALO, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1, H, W), device=dev))
        tiles = [part_ops_shard(mesh, k, t) for k, t in zip(keys, ts)]
        torch.cuda.synchronize()
        K.reset_counters()
        PT.gathers.reset()
        PT.reductions.reset()
        fills, tiled_fill = [], T._tiled_fill

        def spy(*a):  # the tiled fill's arguments, to count its device operations after
            fills.append(a)
            return tiled_fill(*a)

        T._tiled_fill = spy
        try:
            out = as_tuple(fn(*tiles))
        finally:
            T._tiled_fill = tiled_fill
        torch.cuda.synchronize()
        launches = K.launch_counts()
        fwd = (PT.gathers.count, PT.reductions.count)
        got = [gather_frames(mesh, o) for o in out]
        PT.gathers.reset()
        PT.reductions.reset()
        grads = torch.autograd.grad(got, ts, cots)
        bwd = (PT.gathers.count, PT.reductions.count)
        flat = [t.detach() for t in tiles]
        if profile:
            prof = profile_best(torch, lambda: fn(*flat))
            # N7's and N8's device operations on the tiles, counted as CUDA-graph nodes
            n_graph = graph_ops(lambda: fn(*flat)) if name in PART_OPS_FILL[1:] else None
            ms = timed_ms(torch, lambda: fn(*flat), reps=5)
            with WholeLevelCalls() as rec:
                fn(*flat)
            whole_ms = {k: sum(timed_ms(torch, c, reps=5) for c in v)
                        for k, v in rec.calls.items()}
            peak = peak_bytes(torch, lambda: fn(*flat))
    res = dict(launches={k: v for k, v in launches.items() if v}, whole_fwd=list(fwd),
               whole_bwd=list(bwd))
    if (name in PART_OPS_FILL) != bool(fills):
        raise CheckFailed(f"partitioned {name} {grid}: {len(fills)} tiled fills")
    for avg, cnt, *rest in fills:
        n_fill = fill_count(torch, lambda: tiled_fill(avg.detach(), cnt.detach(), *rest),
                            f"partitioned {name} {grid}: the tiled fill")
        res.update(fill_device_ops=n_fill["device_ops"], fill_device_ms=n_fill["device_ms"])
    want_launch = dict.fromkeys(launches, 0)
    want_launch.update(PART_OPS_LAUNCHES.get(name, {}))
    if launches != want_launch:
        raise CheckFailed(f"partitioned {name} {grid}: launches {launches}, expected "
                          f"{want_launch}")
    if (fwd, bwd) != PART_OPS_WHOLE.get(name, ((0, 0), (0, 0))):
        raise CheckFailed(f"partitioned {name} {grid}: whole-level (gathers, reductions) "
                          f"{fwd} forward and {bwd} backward, expected "
                          f"{PART_OPS_WHOLE.get(name, ((0, 0), (0, 0)))}")
    errs = []
    for o, w in zip(got, want):
        errs.append(float((o.detach() - w).abs().max()) / max(1.0, float(w.abs().max())))
        if name in PART_OPS_MASKS:
            v = PART_OPS_MASKS[name]
            if not torch.equal(o.detach() == v, w == v):
                raise CheckFailed(f"partitioned {name} {grid}: where the output is {v} differs "
                                  "from the untiled op")
        if not bool(torch.isfinite(o).all()):
            raise CheckFailed(f"partitioned {name} {grid}: not finite")
    gerrs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
             for g, w in zip(grads, want_grads)]
    res.update(rel_err=max(errs), grad_rel_err=max(gerrs))
    if not (res["rel_err"] <= PART_OPS_TOL and res["grad_rel_err"] <= PART_OPS_TOL):
        raise CheckFailed(f"partitioned {name} {grid}: differs from the untiled op "
                          f"({res['rel_err']:.3e} forward, {res['grad_rel_err']:.3e} VJP, "
                          f"of the scale)")
    if profile:
        if n_graph is not None:
            res.update(graph_device_ops=n_graph)
            if not PART_OPS_PAYLOAD_MIN <= n_graph <= PART_OPS_PAYLOAD_MAX:
                raise CheckFailed(f"partitioned {name} {grid}: {n_graph} device operations a "
                                  f"call, {PART_OPS_PAYLOAD_MIN} to {PART_OPS_PAYLOAD_MAX}")
        if prof and n_graph is not None and prof[0] < n_graph:
            prof = None  # the profiler lost records of this call: not measured
        plain = [a.detach() for a in args]
        u = profile_best(torch, lambda: fn(*plain))
        res.update(ms=ms, gathers_ms=whole_ms["gather"], reductions_ms=whole_ms["reduce"],
                   peak_bytes=peak, untiled_ms=timed_ms(torch, lambda: fn(*plain), reps=5),
                   untiled_peak_bytes=peak_bytes(torch, lambda: fn(*plain)),
                   device_ops=prof and prof[0], device_ms=prof and prof[1],
                   top_kernels=prof and prof[4], untiled_device_ops=u and u[0],
                   untiled_device_ms=u and u[1])
    return res


def phase_partition_ops(torch, results):
    """Phase 10: every op of the library and the grid sample and replication
    pad layers, float32, B = 2, 768x1344, on (data 1, tile 4) and (1, 2, 2),
    halo 64, on the +-20 px flow and (the ops with no halo budget) the
    +-200 px flow, against the same op untiled on the card (see the module
    docstring)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    x, flows = part_ops_inputs(torch, dev)
    calls = part_ops_calls()
    out, totals = {}, {}
    for grid, axis_h in TILE_GRIDS:
        for tag, flow in flows.items():
            for i, (name, fn, keys) in enumerate(calls):
                if tag == "pm200" and name in HALO_BUDGET_OPS:
                    continue
                uses_flow = "flow" in keys
                if tag == "pm200" and not uses_flow:
                    continue
                r = part_ops_run(torch, name, fn, keys, x, flow if uses_flow else None, grid,
                                 axis_h, 100 + i, profile=tag == "pm20")
                out.setdefault(grid, {}).setdefault(tag, {})[name] = r
                for k, v in r["launches"].items():
                    totals[k] = totals.get(k, 0) + v
                line = (f"  {name:<25} {grid:<7} {tag:<5}: max err {r['rel_err']:.3e}, VJP "
                        f"{r['grad_rel_err']:.3e} of the scale; launches {r['launches']}; "
                        f"whole-level (gathers, reductions) {tuple(r['whole_fwd'])} forward, "
                        f"{tuple(r['whole_bwd'])} backward")
                if "fill_device_ops" in r:
                    line += (f"; tiled fill {r['fill_device_ops']} device ops, device ms "
                             + ("not measured (the profiler lost records)"
                                if r["fill_device_ms"] is None else
                                f"{r['fill_device_ms']:.4f}"))
                if "ms" in r:
                    def dev(ms, n):
                        return ("not measured (the profiler kept no record)" if ms is None
                                else f"{ms:.4f} in {n} ops")

                    line += (f"; {r['ms']:.4f} ms by events (median of 5), untiled "
                             f"{r['untiled_ms']:.4f}; whole-level gathers {r['gathers_ms']:.4f} "
                             f"and reductions {r['reductions_ms']:.4f} ms alone by events; "
                             f"device ms {dev(r['device_ms'], r['device_ops'])}, untiled "
                             f"{dev(r['untiled_device_ms'], r['untiled_device_ops'])}; peak "
                             f"{r['peak_bytes'] / 2 ** 30:.3f} GiB, untiled "
                             f"{r['untiled_peak_bytes'] / 2 ** 30:.3f}")
                log(line)
        torch.cuda.empty_cache()
    log(f"  phase 10 launches: {totals}")
    results["partition_ops"] = dict(ops=out, launches=totals)


def part_launches(results, name):
    """Phase 9's launches of a kernel: the partitioned serving of both models
    on both grids, and the sharded step."""
    part = results["partition"]
    return sum(e[grid]["launches"][name] for e in part["serve"].values()
               for grid, _ in TILE_GRIDS) + part["step"]["launches"][name]


def oplib_part_launches(results, name):
    """Phase 10's launches of a kernel: every op of the library and the two
    layers on both grids."""
    return results["partition_ops"]["launches"].get(name, 0)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from memcnet_tpu_torch.ops.cuda import _lib
    except ImportError as e:
        print(f"chip_smoke: the memcnet_tpu_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = {"card": card, "kind": kind}
    try:
        log("phase 1: build kernels")
        t0 = time.perf_counter()
        _lib.lib()
        build_s = time.perf_counter() - t0
        blog = os.path.join(_lib.build_info["dir"], "build.log")
        if os.path.exists(blog):
            text = open(blog).read()
            with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
                f.write(text)
            for line in text.splitlines():  # only the instances that spill
                if "spill" in line and " 0 bytes spill stores" not in line:
                    log("    " + line.strip())
        log(f"  built in {build_s:.2f} s (cached: {_lib.build_info['cached']})")
        results["build_s"] = build_s

        log("phase 2: kernels vs plain versions at the 720p paths' shapes")
        phase_kernels(torch, results)
        log("phase 3: serve 1280x720 through PaddedInterp, 256x448 windows through PaddedVE")
        served = {}
        for name, n_pairs in SERVED:
            served[name] = phase_serve(torch, name, n_pairs, results)
        served["MEMC_Net_VE"] = phase_serve_ve(torch, results)
        log("phase 4: where the time of one frame goes")
        for name, _ in SERVED:
            phase_profile(torch, name, *served[name], results)
            del served[name]
            torch.cuda.empty_cache()
        phase_profile_ve(torch, *served.pop("MEMC_Net_VE"), results)
        torch.cuda.empty_cache()
        log("  MEMC_Net_s served in float32 (the default type)")
        phase_serve_f32(torch, results)
        log("phase 5: serve through the demos' entry points")
        phase_demos(torch, results, card)
        torch.cuda.empty_cache()
        log("phase 6: train steps on the card")
        phase_train(torch, results)
        torch.cuda.empty_cache()
        log("phase 7: the op library on the card")
        phase_oplib(torch, results)
        torch.cuda.empty_cache()
        log("phase 8: the parallel layer on the one card")
        phase_parallel(torch, results)
        torch.cuda.empty_cache()
        # phase 8 holds its own shapes; the recorder stays out of its timed calls
        with ShapeRecorder(only=PARALLEL_SHAPE_ROWS) as rec:
            log("phase 9: partitioned convolutions")
            phase_partition(torch, results)
            torch.cuda.empty_cache()
            log("phase 10: the op library on partitioned frames")
            phase_partition_ops(torch, results)
        log("  K3's tile entry and K2's payload entries at every shape phases 9-10 launched "
            "them at")
        hold_recorded_shapes(torch, results, rec.seen, tag="parallel", origins=rec.origins)
    except Exception:  # every failure ends the run with no result line
        traceback.print_exc()
        with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
            json.dump(results, f, indent=1)
        return 1

    # the row that matches bf16 serving: K2 reads the bf16 flows, K3 writes
    # the bf16 projected flow; K4's main row is the ctx conv, its SPyNet
    # shapes are listed beside it; K2 and K3 carry the whole op beside them;
    # K5's row is the fused SPyNet level input its served launches run, its
    # general grid-sample entry beside it
    main_dtype = {"filter_interp_warp": "bfloat16", "base_scatter": "bfloat16",
                  "fill_holes": "bfloat16", "conv2d_small": "bfloat16", "grid_sample": "bfloat16"}
    krows = results["kernels"]
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        dt = main_dtype[name]
        other = "float32" if dt == "bfloat16" else "bfloat16"
        by_path = {m: results["serve"][m]["launches"][name] for m in EXPECTED_PER_FRAME}
        by_path.update({path: results["demos"][path]["launches"][name]
                        for path in ("demo_hd720p", "demo_middlebury", "demo_vimeo_ve")})
        by_path.update({f"train_{tag}": r["launches"][name]
                        for tag, r in results["train"].items()})
        by_path["oplib"] = results["oplib"]["launches"][name]
        by_path["serve_tiled"] = results["tiled_serve"]["launches"][name]
        by_path["serve_partitioned"] = part_launches(results, name)
        by_path["oplib_partitioned"] = oplib_part_launches(results, name)
        if name == "grid_sample":  # K5's tile entry, on MEMC_Net_s's partitioned path
            by_path["serve_partitioned_tile_entry"] = part_launches(results, "level_input_tile")

        def row(key):
            r, o = krows[key][dt], krows[key][other]
            return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "dtype": dt,
                    "other_dtype_max_abs_err": o["max_abs_err"], "other_dtype_ms": o["ms"],
                    "other_dtype_library_ms": o["library_ms"]}

        key = "spynet_level_input" if name == "grid_sample" else name
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path, **row(key)}
        if name == "grid_sample":
            top = krows[key][dt]
            entry.update(entry="memc_spynet_level_input", device_ops_per_call=top["device_ops"],
                         parent_prologue={k: v for k, v in top["parent_prologue"].items()
                                          if k != "by_kernel"},
                         general_entry={"entry": "memc_grid_sample", **row(name)})
        if name in ("base_scatter", "fill_holes"):
            entry["whole_op"] = {"name": "flow_project", **row("flow_project"),
                                 "device_ops_per_call": krows["flow_project"][dt]["device_ops"]}
        if name == "conv2d_small":
            entry["spynet_shapes"] = [
                {"shape": key.split("spynet ")[1].rstrip("]"), **row(key)}
                for key in krows if key.startswith("conv2d_small[spynet")]
        ve_rows = [key for key in krows if key.startswith(f"{name}[ve ")]
        if ve_rows:  # K1 and K4 at MEMC_Net_VE's shapes
            entry["ve_shapes"] = [{"case": key.split("[ve ")[1].rstrip("]"),
                                   "shape": krows[key][dt]["shape"], **row(key)}
                                  for key in ve_rows]
        # every shape the demos launched this kernel at, held in phase 5
        held = [r for r in results["demo_shapes"] if r["kernel"] in DEMO_SHAPE_ROWS[name]
                and (name != "fill_holes" or r["key"][-1])]
        entry["demo_shapes_held"] = {
            "shapes": len({tuple(map(str, r["key"])) + (r["kernel"],) for r in held}),
            **{f"max_abs_err_{d}": max((r["max_abs_err"] for r in held if r["dtype"] == d),
                                       default=None) for d in ("bfloat16", "float32")}}
        kernels.append(entry)
    # K4's float32 body (csrc/conv_f32.cu), launched by MEMC_Net_s served in
    # float32 (phase 4) and the float32 train steps; its row SPyNet's widest
    # conv, 32 -> 64 at 768x1344, with the 30 convs of a 720p frame summed
    spy = [k for k in krows if k.startswith("conv2d_small[spynet")]
    top = krows["conv2d_small[spynet 32->64]"]["float32"]
    by_path = {"serve_f32_MEMC_Net_s": results["serve_f32"]["f32_launches"]}
    by_path.update({f"train_{tag}": r["f32_launches"] for tag, r in results["train"].items()
                    if "f32_launches" in r})  # the bf16 768x1344 step records none
    kernels.append({
        "name": "conv2d_small[float32]", "route": "cuda",
        "source": "memcnet_tpu_torch/csrc/conv_f32.cu", "replaces": TPU_KERNELS["conv2d_small"][1],
        "entry": "memc_conv2d_small (3xTF32)", "launches": sum(by_path.values()),
        "launches_by_path": by_path, "dtype": "float32",
        **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "bound_cuda_cores_ms")},
        "spynet_30": {k: sum(krows[key]["float32"][k] for key in spy)
                      for k in ("ms", "library_ms", "bound_ms", "bound_cuda_cores_ms")},
        "spynet_max_abs_err": max(krows[key]["float32"]["max_abs_err"] for key in spy),
        "ctx": {k: krows["conv2d_small"]["float32"][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "serve_f32": {k: results["serve_f32"][k]
                      for k in ("forward_ms", "k4_f32_device_ms", "k4_f32_profiled_launches")}})
    # phase 7's entries: K2's payload entry (the depth payload's row, the gated
    # one beside it) and K3's down search, launched in the op library's run by
    # depth_flow_project and weighted_flow_project (K2), and flow_project with
    # fix_down_scan_bug (K3)
    orows = results["oplib"]["kernels"]
    oplaunch = {k: v["launches"] for k, v in results["oplib"]["ops"].items()}
    payload_launches = {k: oplaunch[k]["base_scatter"]
                        for k in ("depth_flow_project", "weighted_flow_project")}
    down_launches = oplaunch["flow_project"]["fill_holes"]

    def orow(key, dt="bfloat16"):
        r, o = orows[key][dt], orows[key]["float32"]
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "dtype": dt,
                "other_dtype_max_abs_err": o["max_abs_err"], "other_dtype_ms": o["ms"],
                "other_dtype_library_ms": o["library_ms"]}

    kernels.append({"name": "base_scatter[payload]", "route": "cuda",
                    "source": TPU_KERNELS["base_scatter"][0],
                    "replaces": TPU_KERNELS["base_scatter"][1],
                    "entry": "memc_project_payload", "launches": sum(payload_launches.values()),
                    "launches_by_path": {"oplib": payload_launches},
                    **orow("base_scatter[payload P=3]"),
                    "payload_p4": orow("base_scatter[payload P=4]"),
                    "whole_ops": {k: orow(k) for k in ("depth_flow_project",
                                                       "weighted_flow_project")}})
    kernels.append({"name": "fill_holes[down]", "route": "cuda",
                    "source": TPU_KERNELS["fill_holes"][0],
                    "replaces": TPU_KERNELS["fill_holes"][1],
                    "entry": "memc_project_fill(down=1)", "launches": down_launches,
                    "launches_by_path": {"oplib": {"flow_project": down_launches}},
                    **orow("fill_holes[down]"),
                    "whole_op": {"name": "flow_project[down]", **orow("flow_project[down]")}})
    # phase 8's entries: the tile entries of K1, K2 and K3, launched by star's
    # tiled 720p serving and phase 9's partitioned serving and step; their rows
    # at (data 1, tile 4) on the +-20 px flows
    trows = results["tile_entries"]["kernels"]
    for name, (source, replaces, computes) in TILE_ENTRIES.items():
        key = f"{name}[tile4 pm20]"
        r, o = trows[key]["bfloat16"], trows[key]["float32"]
        held = {k: max(v[d]["max_abs_err"] for d in v) for k, v in trows.items()
                if k.startswith(name + "[")}
        by_path = {"serve_tiled": results["tiled_serve"]["launches"][name],
                   "serve_partitioned": part_launches(results, name),
                   "oplib_partitioned": oplib_part_launches(results, name)}
        held_at = [r for r in results["parallel_shapes"] if r["kernel"] == "fill_tiles"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "computes": computes, "entry": TILE_ENTRY_NAMES[name],
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "device_ops_per_call": r.get("device_ops"),
                        **({"phases_9_10_shape_rows_held": len(held_at)}
                           if name == "fill_holes_carry" else {}),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "dtype": "bfloat16",
                        "other_dtype_max_abs_err": o["max_abs_err"], "other_dtype_ms": o["ms"],
                        "other_dtype_library_ms": o["library_ms"], "cases_held": held})
    # K5's tile entry: SPyNet's level input on partitioned frames, launched by
    # MEMC_Net_s's partitioned serving in phase 9; its row from phase 2, (1, 4)
    # at the top level
    r, o = krows["level_input_tile"]["bfloat16"], krows["level_input_tile"]["float32"]
    by_path = {"serve_partitioned": part_launches(results, "level_input_tile"),
               "oplib_partitioned": oplib_part_launches(results, "level_input_tile")}
    kernels.append({"name": "level_input_tile", "route": "cuda",
                    "source": TPU_KERNELS["grid_sample"][0],
                    "replaces": TPU_KERNELS["grid_sample"][1],
                    "computes": "SPyNet's level input on the tiles of a partitioned frame "
                                "(memcnet_tpu/models/spynet.py:104-109 under frame_sharding)",
                    "entry": "memc_spynet_level_input_tile",
                    "launches": sum(by_path.values()), "launches_by_path": by_path,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "dtype": "bfloat16",
                    "device_ops_per_call": r["device_ops"],
                    "other_dtype_max_abs_err": o["max_abs_err"], "other_dtype_ms": o["ms"],
                    "other_dtype_library_ms": o["library_ms"],
                    "cases_held": {f"{c['grid']} {c['shape']} {d}": c["max_abs_err"]
                                   for d in ("bfloat16", "float32")
                                   for c in krows["level_input_tile"][d]["cases"]}})
    # K2's payload entry on tile origins: the depth-weighted and gated
    # projections on partitioned frames, launched in phase 10; its row from
    # phase 2, (1, 4) at 768x1344, float32 flows (phase 10's type), P = 3
    r, o = krows["base_scatter_payload_tile[P=3]"]["float32"], \
        krows["base_scatter_payload_tile[P=3]"]["bfloat16"]
    by_path = {"oplib_partitioned": oplib_part_launches(results, "base_scatter_payload_tile")}
    kernels.append({"name": "base_scatter_payload_tile", "route": "cuda",
                    "source": TPU_KERNELS["base_scatter"][0],
                    "replaces": TPU_KERNELS["base_scatter"][1],
                    "computes": "N7's and N8's scatters on the tiles of a partitioned frame "
                                "(memcnet_tpu/ops/projection.py:_scatter4 under "
                                "frame_sharding, whose scatter GSPMD reduces over the frame)",
                    "entry": "memc_project_payload_tile",
                    "launches": sum(by_path.values()), "launches_by_path": by_path,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "dtype": "float32",
                    "device_ops_per_call": r["device_ops"],
                    "other_dtype_max_abs_err": o["max_abs_err"], "other_dtype_ms": o["ms"],
                    "other_dtype_library_ms": o["library_ms"],
                    "payload_p4": {k: krows["base_scatter_payload_tile[P=4]"]["float32"][k]
                                   for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "device_ops")}})
    with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
