"""Streaming HD 2x interpolation over YUV420 files (port of
memcnet_tpu/cli/demo_hd720p.py; the reference's demo_HD720p.py): read frames
0..100 step 2, interpolate the mid frame, write GT + reconstructed frames to
an output stream, Y-channel PSNR/SSIM per frame with per-file logs.  Runs on
the CUDA device unless --device says otherwise.

  python -m memcnet_tpu_torch.cli.demo_hd720p --yuv input.yuv --height 720 \\
      --width 1280 --out-dir ./HD-results --net-name MEMC_Net_star

The stream is cut into GOPs (parallel.gop.GopScheduler): independent,
journaled, restartable work units; `--journal` makes completions durable so
an interrupted run can be resumed.  `--trace-dir` wraps the run in a
torch.profiler trace (trace.json) and writes the model's stage spans and
counters beside it (stages.json, utils/tracing.py), and StageTimers report
proc/total per item (the reference's AverageMeter protocol,
demo_Vimeo_VE.py:97-98).  Frames are read by the native C++ prefetching
reader (native.NativeYUVReader, stride 2) when its library builds, else by
data.yuv.YUVRead, as the JAX demo does.

``--multihost`` joins a process group from torch's own environment contract
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as ``torchrun`` sets them):
the GOPs are split round-robin across the processes (parallel.gop), each
writes its own ``.partN`` stream segment and the journal is shared, and
parallel.gop.stitch_parts merges the parts into the one-process stream.  The
group only coordinates hosts, so its backend is gloo whatever the device;
each process serves on ``cuda:{LOCAL_RANK % device count}`` unless
``--device cpu`` is given:

  torchrun --nproc-per-node 2 -m memcnet_tpu_torch.cli.demo_hd720p --multihost \
      --yuv input.yuv --height 720 --width 1280 --journal run.journal
"""

import argparse
import os
import random
import sys

from memcnet_tpu_torch import native
from memcnet_tpu_torch.cli.runner import PaddedInterp, build_from_config, cfg_torch_dtype
from memcnet_tpu_torch.data import YUVRead, YUVWrite
from memcnet_tpu_torch.metrics import (AverageMeter, interp_error, psnr, ssim, to_uint8_frame,
                                       y_channel_u8)
from memcnet_tpu_torch.parallel.gop import GopScheduler
from memcnet_tpu_torch.utils.config import add_config_args, config_from_args
from memcnet_tpu_torch.utils.tracing import StageTimers, device_trace


def read_triple(reader, i0, i2, imid):
    """Frames ``i0`` and ``i2`` and the ground truth ``imid``, (H, W, 3)
    uint8 each, or None past the stream's end."""
    f0, ok0 = reader.read(i0)
    f2, ok2 = reader.read(i2)
    gt, okg = reader.read(imid)
    return (f0, f2, gt) if ok0 and ok2 and okg else None


def to_input(frame):
    """(H, W, 3) uint8 -> the model's (3, H, W) float32 in [0, 1]."""
    return frame.transpose(2, 0, 1).astype("float32") / 255.0


def score_y(rec_u8, gt):
    """(IE, PSNR, SSIM) of the Y channels of the reconstruction and the
    ground truth."""
    rec_y = y_channel_u8(rec_u8)
    gt_y = y_channel_u8(gt)
    return interp_error(rec_y, gt_y), psnr(rec_y, gt_y), ssim(rec_y, gt_y, multichannel=False)


def run(cfg, yuv_path, height, width, out_dir, frames=100, step=2, *,
        gop_len=16, journal=None, trace_dir=None, uid=None, device="cuda"):
    model = build_from_config(cfg, device=device)
    fwd = PaddedInterp(model, save_which=cfg.save_which, dtype=cfg_torch_dtype(cfg),
                       device=device)

    sched = GopScheduler(frames + 1, gop_len=gop_len, step=step, journal_path=journal)
    uid = uid or str(random.randint(0, 100000))
    gen_dir = os.path.join(out_dir, uid)
    os.makedirs(gen_dir, exist_ok=True)
    name = os.path.basename(yuv_path)

    # the native prefetching reader when its library is built; numpy otherwise
    if native.available():
        reader = native.NativeYUVReader(yuv_path, height, width, stride=step)
    else:
        reader = YUVRead(yuv_path, height, width)
    # each process writes its own stream segment file (GOPs are disjoint)
    suffix = f".part{sched.process_index}" if sched.process_count > 1 else ""
    writer = YUVWrite(os.path.join(gen_dir, name + suffix))

    ie_m, psnr_m, ssim_m = AverageMeter(), AverageMeter(), AverageMeter()
    timers = StageTimers()
    pending = sched.pending()
    done0, total0 = sched.progress()
    print(f"process {sched.process_index}/{sched.process_count}: "
          f"{len(pending)} pending GOPs ({done0}/{total0} journaled done)",
          file=sys.stderr)

    try:
        with device_trace(trace_dir):
            for gop in pending:
                for i0, i2, imid in gop.pairs():
                    with timers.item():
                        frames = read_triple(reader, i0, i2, imid)
                        if frames is None:
                            break
                        f0, f2, gt = frames
                        x0, x2 = to_input(f0), to_input(f2)
                        with timers.model():
                            out, _ = fwd(x0, x2)
                        rec_u8 = to_uint8_frame(out)
                        writer.write(f0)
                        writer.write(rec_u8)
                        ie, p, s = score_y(rec_u8, gt)
                        ie_m.update(ie)
                        psnr_m.update(p)
                        ssim_m.update(s)
                        print(f"frame {imid}: interpolation error / PSNR : {round(ie, 4)} ,\t "
                              f"psnr {round(p, 4)},\t ssim {round(s, 5)}")
                        with open(os.path.join(gen_dir, name + "_psnr_Y.txt"), "a+") as fh:
                            fh.write(f"{p}\n")
                        with open(os.path.join(gen_dir, name + "_ssim_Y.txt"), "a+") as fh:
                            fh.write(f"{s}\n")
                sched.mark_done(gop)
    finally:
        reader.close()
        writer.close()
    print(f"The average interpolation error / PSNR for all images are : "
          f"{round(ie_m.avg, 4)},\t psnr {round(psnr_m.avg, 4)},\t ssim {round(ssim_m.avg, 4)}")
    print(timers.summary(), file=sys.stderr)
    return psnr_m.avg, ssim_m.avg


def join_process_group(device):
    """Initialise the gloo process group from MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK; returns the device this process serves on."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://")
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(device)  # the kernels launch on the current device
    print(f"process group up: process {dist.get_rank()}/{dist.get_world_size()}, "
          f"serving on {device}", file=sys.stderr)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_config_args(ap)
    ap.add_argument("--yuv", required=True)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out-dir", default="./HD720p-results")
    ap.add_argument("--gop-len", type=int, default=16,
                    help="frames per restartable GOP work unit")
    ap.add_argument("--journal", default=None,
                    help="completion journal path (enables crash restart)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace (trace.json) and the model's "
                         "stage spans and counters (stages.json) here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--multihost", action="store_true",
                    help="join a process group from MASTER_ADDR, MASTER_PORT, WORLD_SIZE and "
                         "RANK (torchrun's environment) and split the GOPs across it")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    device = join_process_group(args.device) if args.multihost else args.device
    try:
        return run(cfg, args.yuv, args.height, args.width, args.out_dir,
                   args.frames, gop_len=args.gop_len, journal=args.journal,
                   trace_dir=args.trace_dir, uid=cfg.uid, device=device)
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
