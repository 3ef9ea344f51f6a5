"""Quality metrics reproducing the reference demos' measurement protocol
(a copy of memcnet_tpu/metrics/quality.py: the port imports nothing of the
JAX package, and its values equal that module's bit for bit).

  * interpolation error + PSNR over uint8 RGB with the 128-offset diff trick
    (demo_MiddleBury.py:164-175, demo_Vimeo_VE.py:157-167).
  * SSIM reproducing skimage.measure.compare_ssim defaults used by the demos
    (demo_HD720p.py:177 grayscale, demo_Vimeo_VE.py:168 multichannel):
    uniform 7x7 window, K1=0.01, K2=0.03, sample covariance, edge crop,
    data_range from the uint8 dtype.
  * Y-channel extraction for the HD720p protocol (demo_HD720p.py:152-160).

All metrics run on host numpy, outside the model's compute path.
"""

import numpy as np
from scipy.ndimage import uniform_filter

# skimage.color.rgb2yuv's matrix (the demos import it from skimage, demo_HD720p.py:15)
_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]]
)


def to_uint8_frame(y):
    """(C,H,W) float [0,1] -> (H,W,C) uint8 via the demos' save path
    (255*clip, np.round, uint8 — demo_MiddleBury.py:148,159)."""
    arr = np.transpose(255.0 * np.clip(np.asarray(y, np.float64), 0.0, 1.0), (1, 2, 0))
    return np.round(arr).astype(np.uint8)


def interp_error(rec_u8, gt_u8):
    diff = 128.0 + rec_u8.astype(np.float64) - gt_u8.astype(np.float64)
    return float(np.mean(np.abs(diff - 128.0)))


def psnr(rec_u8, gt_u8):
    diff = 128.0 + rec_u8.astype(np.float64) - gt_u8.astype(np.float64)
    mse = np.mean((diff - 128.0) ** 2)
    if mse == 0:
        return 100.0  # demo_Vimeo_VE.py:163-164
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def _ssim_single(x, y, data_range, win_size=7, k1=0.01, k2=0.03):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    npts = win_size ** x.ndim
    cov_norm = npts / (npts - 1.0)

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, dim - pad) for dim in s.shape)
    return float(s[crop].mean())


def ssim(rec, gt, multichannel=False, data_range=None):
    rec = np.asarray(rec)
    gt = np.asarray(gt)
    if data_range is None:
        if rec.dtype == np.uint8:
            data_range = 255.0
        else:
            data_range = float(gt.max() - gt.min())
    if multichannel:
        return float(np.mean([
            _ssim_single(rec[..., c], gt[..., c], data_range) for c in range(rec.shape[-1])
        ]))
    return _ssim_single(rec, gt, data_range)


def rgb2yuv(rgb01):
    """(H,W,3) float [0,1] -> YUV with skimage.color.rgb2yuv's exact matrix."""
    return rgb01 @ _RGB2YUV.T


def yuv2rgb(yuv):
    return yuv @ np.linalg.inv(_RGB2YUV).T


def y_channel_u8(rgb_u8):
    """uint8 RGB -> uint8 Y plane (demo_HD720p.py:152-160)."""
    yuv = rgb2yuv(rgb_u8.astype(np.float64) / 255.0)
    return (yuv[:, :, 0] * 255.0).astype("uint8")
