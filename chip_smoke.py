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
     768x1344 down to 24x42 (MEMC_Net_s), and K1 and K4 at MEMC_Net_VE's
     320x512 window (K1 over six neighbours and their contexts on the smooth
     flow and on +-20 px noise, K4 over seven frames); the projection's K2
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
     operations, and the same with the separate-op level input it replaced.
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32: CUDA cores
# launches per served frame (SPyNet: 6 levels of 5 convs and 1 warp at 720p)
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


def check_projection_exact(torch, what, S, S_ref, masks, masks_ref):
    """The projection's counts (base and folded) and its has-value masks
    are sums of 1.0 and bits: the kernel must match its plain version
    exactly."""
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    if not torch.equal(S[:, 2], S_ref[:, 2]) or not torch.equal(
            P.fold(S)[:, 2], P.fold(S_ref)[:, 2]):
        raise CheckFailed(f"{what}: counts differ from the plain version")
    for name, m, r in zip(masks._fields, masks, masks_ref):
        if not torch.equal(m, r):
            raise CheckFailed(f"{what}: mask {name} differs from the plain version")


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

    def record(name, dtype, check, k_ms, p_ms, lib_ms, nbytes, flops, op_dtype, extra=None):
        err, measure, limit, rule = check
        b_ms, b_by = bound(nbytes, flops, op_dtype)
        ok = bool(measure <= limit)
        rows.setdefault(name, {})[dtype] = dict(
            max_abs_err=err, check=rule, check_value=measure, ok=ok, ms=k_ms, plain_ms=p_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
            **(extra or {}))
        log(f"  {name:<19} {dtype:<8} max_abs_err {err:.3e} [{rule}: {measure:.3g}] "
            f"{'ok' if ok else 'FAIL'}  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise CheckFailed(f"{name} {dtype}: kernel disagrees with its plain version "
                              f"({rule}: {measure})")

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
               flops=2 * 2 * H * W * 64 * 3 * 49, op_dtype=dtype_name)
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
               flops=2 * 7 * VE_H * VE_W * 64 * 3 * 49, op_dtype=dtype_name,
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
                       flops=2 * 2 * h * w_ * cout * cin * 49, op_dtype=dtype_name)
                del x, w, b, got, ref
        torch.cuda.empty_cache()
    results["kernels"] = rows


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


def synthetic_frames(seed):
    """A textured 1280x720 frame and the same scene moved a few pixels."""
    rng = np.random.RandomState(seed)
    img = texture(rng, FRAME_H + 40, FRAME_W + 40)
    dx, dy = rng.randint(2, 12), rng.randint(2, 8)
    x0 = img[:, 20:20 + FRAME_H, 20:20 + FRAME_W]
    x2 = img[:, 20 + dy:20 + dy + FRAME_H, 20 + dx:20 + dx + FRAME_W]
    return np.ascontiguousarray(x0), np.ascontiguousarray(x2)


def synthetic_window(seed, h=VE_FRAME_H, w=VE_FRAME_W):
    """Seven textured h x w frames of one scene: the center (frame 3) and six
    neighbours, each moved 2-12 px across and 0-8 px down or up from it."""
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
    for kname, per in EXPECTED_PER_FRAME[name].items():
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
    for kname, per in EXPECTED_PER_FRAME[name].items():
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


def profile_forward(torch, name, fwd, results):
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
    log(f"  {name} forward alone (bf16, device time, 5 runs median): {fwd_ms:.3f} ms; profiled "
        f"forward: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}; port kernels {ours:.3f} ms")
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        for key, ms_, n in rows:
            f.write(f"{ms_:10.4f} ms {n:5d}x  {key}\n")
    for key, ms_, n in rows[:12]:
        log(f"    {ms_:9.4f} ms {100 * ms_ / max(busy, 1e-9):5.1f}% {n:4d}x  {key[:90]}")
    res = results.setdefault("profile", {})[name] = dict(
        forward_ms=fwd_ms, wall_ms=wall_ms, kernel_ms=busy, port_kernel_ms=ours, top=rows[:25])
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
        kernels.append(entry)
    with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
