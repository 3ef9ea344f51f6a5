"""Host metrics of the demos (ports of memcnet_tpu/metrics): numpy only."""

from memcnet_tpu_torch.metrics.meter import AverageMeter
from memcnet_tpu_torch.metrics.quality import (
    interp_error,
    psnr,
    rgb2yuv,
    ssim,
    to_uint8_frame,
    y_channel_u8,
    yuv2rgb,
)

__all__ = (
    "AverageMeter", "interp_error", "psnr", "rgb2yuv", "ssim",
    "to_uint8_frame", "y_channel_u8", "yuv2rgb",
)
