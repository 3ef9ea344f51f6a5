"""The moving clip every cell interpolates, made on the device from the seed.

One textured scene (four plane waves a channel, waves and phases drawn from
the seed) seen through a window that moves 1-6 px across and 0-4 px down
from one frame to the next, so that frames two apart, an interpolated pair,
lie 2-12 px apart.  Frames are rounded to 8 bits, as video is, and padded by
replication as the serving path pads a frame (``pad_plan``).  This is the
program's ``probe.moving_frames`` made in torch on the card.
"""

import torch
import torch.nn.functional as F


def pad_plan(height, width, multiple=128, border=32):
    """(left, right, top, bottom): up to the next multiple of ``multiple``,
    centred; a side already a multiple gets ``border`` each way
    (data/padding.py of the program, demo_MiddleBury.py of the reference)."""
    def side(n):
        if n % multiple:
            total = (n // multiple + 1) * multiple - n
            return total // 2, total - total // 2
        return border, border

    (left, right), (top, bottom) = side(width), side(height)
    return left, right, top, bottom


def make(seed, n, height, width, device):
    """(n, 3, H', W') float32 frames in [0, 1], padded by ``pad_plan``."""
    gen = torch.Generator().manual_seed(int(seed))
    waves = torch.rand((3, 4, 3), generator=gen, dtype=torch.float64)
    kx = 0.005 + 0.045 * waves[..., 0]
    ky = 0.005 + 0.045 * waves[..., 1]
    ph = 6.3 * waves[..., 2]
    dy = torch.randint(0, 5, (n,), generator=gen)
    dx = torch.randint(1, 7, (n,), generator=gen)
    h, w = height + 4 * n, width + 6 * n
    ys = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    img = torch.zeros((3, h, w), dtype=torch.float32, device=device)
    for c in range(3):
        for k in range(4):
            img[c] += torch.sin(float(kx[c, k]) * xs[0] + float(ky[c, k]) * ys[0]
                                + float(ph[c, k]))
    img = (img - img.min()) / (img.max() - img.min())
    y = torch.cumsum(dy, 0) - dy
    x = torch.cumsum(dx, 0) - dx
    frames = torch.stack([img[:, int(y[i]):int(y[i]) + height, int(x[i]):int(x[i]) + width]
                          for i in range(n)])
    frames = torch.round(255.0 * frames) / 255.0
    left, right, top, bottom = pad_plan(height, width)
    return F.pad(frames, (left, right, top, bottom), mode="replicate")
