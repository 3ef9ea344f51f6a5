"""Middlebury 'other' interpolation demo (port of
memcnet_tpu/cli/demo_middlebury.py; the reference's demo_MiddleBury.py):
per-sequence frame10/frame11 -> frame10i11, pad-to-x128, per-image
interpolation error + PSNR against ground truth, running averages,
diff-image artifacts.  Runs on the CUDA device unless --device says otherwise.

Usage:
  python -m memcnet_tpu_torch.cli.demo_middlebury --data-dir .../other-data \\
      --gt-dir .../other-gt-interp --out-dir ./results \\
      --net-name MEMC_Net_star --pretrained MEMC-Net_star_best.pth
"""

import argparse
import os
import random
import sys
import time

import numpy as np

from memcnet_tpu_torch.cli.runner import PaddedInterp, build_from_config, cfg_torch_dtype
from memcnet_tpu_torch.data import MiddleburyOther
from memcnet_tpu_torch.io.png import imwrite
from memcnet_tpu_torch.metrics import AverageMeter, interp_error, psnr, to_uint8_frame
from memcnet_tpu_torch.utils.config import add_config_args, config_from_args
from memcnet_tpu_torch.utils.tracing import StageTimers, device_trace


def run(cfg, data_dir, gt_dir, out_dir, trace_dir=None, device="cuda"):
    model = build_from_config(cfg, device=device)
    fwd = PaddedInterp(model, save_which=cfg.save_which, dtype=cfg_torch_dtype(cfg),
                       device=device)

    uid = str(random.randint(0, 100000))
    gen_dir = os.path.join(out_dir, uid)
    os.makedirs(gen_dir, exist_ok=True)
    print(f"The unique id for current testing is: {uid}")

    meter = AverageMeter()
    timers = StageTimers()
    results = []
    with device_trace(trace_dir):
        for x0, x1, gt, name in MiddleburyOther(data_dir, gt_dir):
            t_item = time.time()
            with timers.model():
                out, _aux = fwd(x0, x1)
            rec_u8 = to_uint8_frame(out)
            os.makedirs(os.path.join(gen_dir, name), exist_ok=True)
            imwrite(os.path.join(gen_dir, name, "frame10i11.png"), rec_u8)
            if gt is None:
                continue
            gt_u8 = to_uint8_frame(gt)
            ie = interp_error(rec_u8, gt_u8)
            p = psnr(rec_u8, gt_u8)
            meter.update(ie, 1)
            results.append((name, ie, p))
            print(f"{name}: interpolation error / PSNR : {round(ie, 4)} / {round(p, 4)}")
            print(f"The average interpolation error for all images is : {round(meter.avg, 4)}")
            diff = (128.0 + rec_u8.astype(np.float64) - gt_u8.astype(np.float64)).astype("uint8")
            imwrite(os.path.join(gen_dir, name, f"frame10i11_diff{ie:.4f}.png"), diff)
            timers.total.update(time.time() - t_item)
    print(timers.summary(), file=sys.stderr)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_config_args(ap)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--gt-dir", default=None)
    ap.add_argument("--out-dir", default="./MiddleBury-results")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace (trace.json) and the model's "
                         "stage spans and counters (stages.json) here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.net_name == "MEMC_Net_VE":
        sys.exit("use demo_vimeo_ve for the enhancement model")
    return run(cfg, args.data_dir, args.gt_dir, args.out_dir,
               trace_dir=args.trace_dir, device=args.device)


if __name__ == "__main__":
    main()
