"""MEMC_Net_star's operations and its kernels' launches (counts/__init__.py)."""

from benchmark.counts import conv, conv_out, deconv, k1, k4, unet
from benchmark.reference import layers as R

EDSR_FEATS, EDSR_BLOCKS = 128, 10
EDSR_IN = 3 + 2 * 2 + 2 * 16 + 64 * 2 + 2  # MEMC_Net_star.py:35


def flownets(b, h, w):
    total, sizes = 0, {}
    for name, cin, cout, k, s in R.FLOWNETS_ENC:
        p = (k - 1) // 2
        h, w = conv_out(h, k, s, p), conv_out(w, k, s, p)
        total += conv(b, cin, cout, k, h, w)
        sizes[name] = (h, w)
    for (_dn, dci, dco, _pn, pci, _un), skip in zip(R.FLOWNETS_DEC,
                                                  ("conv6_1", "conv5_1", "conv4_1", "conv3_1")):
        hi, wi = sizes[skip]
        total += conv(b, pci, 2, 3, hi, wi)            # predict_flow at this level
        total += deconv(b, 2, 2, 4, hi, wi)            # its upsampled flow
        total += deconv(b, dci, dco, 4, hi, wi)        # the deconv
    h2, w2 = sizes["conv2"]
    return total + conv(b, R.FLOWNETS_LAST[1], 2, 3, h2, w2)


def flops(H, W):
    total = flownets(2, H, W)                          # both directions
    total += 2 * unet(R.MONONET_FULL, H, W)            # filter and occlusion trunks
    total += 2 * (conv(1, 16, 16, 3, H, W) + conv(1, 16, 16, 3, H, W))  # filter branches
    total += 2 * (conv(1, 16, 16, 3, H, W) + conv(1, 16, 1, 3, H, W))   # occlusion branches
    total += conv(2, 3, 64, 7, H, W)                   # ctx of both frames
    total += conv(1, EDSR_IN, EDSR_FEATS, 3, H, W)
    total += (2 * EDSR_BLOCKS + 1) * conv(1, EDSR_FEATS, EDSR_FEATS, 3, H, W)
    return total + conv(1, EDSR_FEATS, 3, 3, H, W)


def kernels(B, H, W, esize):
    return {
        "k1": [k1(B, H, W, 3 + 64, esize)] * 2,        # (frame, context) of each frame
        "k4": [k4(2 * B, 3, 64, 7, H, W, esize, "bfloat16" if esize == 2 else "tf32")],
    }
