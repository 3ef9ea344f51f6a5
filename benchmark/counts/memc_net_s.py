"""MEMC_Net_s's operations and its kernels' launches (counts/__init__.py)."""

from benchmark.counts import conv, k1, k4, unet, unet_convs
from benchmark.reference import layers as R

RECTIFY_IN = 3 + 4 + 2 * 16 + 2  # MEMC_Net.py:32


def spynet_convs(b, H, W):
    """(b, cin, cout, k, h, w) of SPyNet's 7x7 convs, coarsest level first."""
    return [(b, cin, cout, 7, h, w) for h, w in R.spynet_levels(H, W)
            for cin, cout in R.SPYNET_BASIC]


def walker_convs(b, H, W):
    """(b, cin, cout, k, h, w) of the 3x3 convs the spec walkers run: the
    thin trunk's 12, both filter branches' 2 each, RectifyNet2's 8."""
    branches = 2 * [(b, 16, 16, 3, H, W), (b, 16, 16, 3, H, W)]
    rectify = [(b, RECTIFY_IN, 64, 3, H, W)] + 6 * [(b, 64, 64, 3, H, W)] + [(b, 64, 3, 3, H, W)]
    return unet_convs(R.MONONET_THIN, H, W, b) + branches + rectify


def flops(H, W):
    total = sum(conv(*c) for c in spynet_convs(2, H, W))  # both directions
    total += unet(R.MONONET_THIN, H, W)
    total += 2 * (conv(1, 16, 16, 3, H, W) + conv(1, 16, 16, 3, H, W))  # filter branches
    total += conv(1, RECTIFY_IN, 64, 3, H, W) + 6 * conv(1, 64, 64, 3, H, W)
    return total + conv(1, 64, 3, 3, H, W)


def kernels(B, H, W, esize):
    """K4: a float32 forward on the card runs every conv on K4's float32
    body, SPyNet's in both directions at 2B and the walkers' at B."""
    peak = "bfloat16" if esize == 2 else "tf32"
    convs = spynet_convs(2 * B, H, W) + walker_convs(B, H, W)
    return {
        "k1": [k1(B, H, W, 3, esize)] * 2,
        "k4": [k4(*c, esize, peak) for c in convs],
    }
