"""Vimeo-90K video-enhancement demo (port of memcnet_tpu/cli/demo_vimeo_ve.py;
the reference's demo_Vimeo_VE.py): 7-frame windows -> enhanced im4;
per-image PSNR/SSIM (RGB, multichannel) + timers; metrics.txt summary.  Runs
on the CUDA device unless --device says otherwise.

  python -m memcnet_tpu_torch.cli.demo_vimeo_ve --root .../vimeo_test --task denoise
"""

import argparse
import os
import time

from memcnet_tpu_torch.cli.runner import PaddedVE, build_from_config, cfg_torch_dtype
from memcnet_tpu_torch.data import Vimeo90K
from memcnet_tpu_torch.io.png import imwrite
from memcnet_tpu_torch.metrics import AverageMeter, interp_error, psnr, ssim, to_uint8_frame
from memcnet_tpu_torch.utils.config import add_config_args, config_from_args
from memcnet_tpu_torch.utils.tracing import device_trace


def run(cfg, root, out_dir, limit=None, trace_dir=None, device="cuda"):
    model = build_from_config(cfg, device=device)
    fwd = PaddedVE(model, dtype=cfg_torch_dtype(cfg), device=device)

    ie_m, psnr_m, ssim_m = AverageMeter(), AverageMeter(), AverageMeter()
    proc_t, tot_t = AverageMeter(), AverageMeter()
    ds = Vimeo90K(root, cfg.task or "denoise")
    end = time.time()
    metrics = ""
    with device_trace(trace_dir):
        for i, (frames, target, path) in enumerate(ds):
            if limit is not None and i >= limit:
                break
            t0 = time.time()
            out = fwd(frames)
            proc_t.update(time.time() - t0)
            tot_t.update(time.time() - end)
            end = time.time()

            rec_u8 = to_uint8_frame(out)
            if out_dir:
                d = os.path.join(out_dir, path)
                os.makedirs(d, exist_ok=True)
                imwrite(os.path.join(d, "im4.png"), rec_u8)
            gt_u8 = to_uint8_frame(target)
            ie = interp_error(rec_u8, gt_u8)
            p = psnr(rec_u8, gt_u8)
            s = ssim(rec_u8, gt_u8, multichannel=True)
            ie_m.update(ie)
            psnr_m.update(p)
            ssim_m.update(s)
            print(f"{path}: interpolation error / PSNR : {round(ie, 4)} ,\t psnr {round(p, 4)},\t "
                  f"ssim {round(s, 5)}")
            print(f"Per Image Processing Total time (I/O + processing) : {tot_t.avg}")
            print(f"Per Image Processing Total time (processing) : {proc_t.avg}")
            metrics = (f"The average interpolation error / PSNR for all images are : "
                       f"{round(ie_m.avg, 4)},\t  psnr {round(psnr_m.avg, 4)},\t  "
                       f"ssim {round(ssim_m.avg, 4)}")
            print(metrics)
    if out_dir and metrics:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write(metrics + "\n")
    return psnr_m.avg, ssim_m.avg


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_config_args(ap)
    ap.add_argument("--root", required=True, help="the Vimeo-90K test folder")
    ap.add_argument("--out-dir", default="./Vimeo-VE-results")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace (trace.json) here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_from_args(args, net_name="MEMC_Net_VE")
    return run(cfg, args.root, args.out_dir, args.limit, trace_dir=args.trace_dir,
               device=args.device)


if __name__ == "__main__":
    main()
