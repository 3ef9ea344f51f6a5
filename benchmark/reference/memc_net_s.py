"""MEMC_Net_s in plain float32 (MEMC_Net_s.py:62-145, eval mode).

flow: SPyNet on (x0, x2) and (x2, x0), halved, projected to the middle time
with the hole fill; filters: one thin MonoNet5 trunk with BatchNorm on its
running statistics and two 16-tap filter branches; the pseudo-occlusions are
channel 0 of filter branch 1 (:111-114); the filter warp of each frame; the
blend w0 / 2 + w1 / 2 (:264); the rectified frame: blend + the 8-conv
RectifyNet over (blend, offsets, filters, occlusions).
"""

import torch

from benchmark.reference import layers as R


def forward(p, x0, x2):
    """(B, 3, H, W) float32 pairs -> the rectified middle frames."""
    B = x0.shape[0]
    flows = R.spynet(p, torch.cat((x0, x2), 0), torch.cat((x2, x0), 0)) / 2.0
    off0, off1 = R.project(flows, fillhole=True).split(B)
    t = R.unet(p, "initScaleNets_filter", R.MONONET_THIN, True, torch.cat((x0, x2), 1))
    f0 = R.branch(p, "initScaleNets_filter1", t)
    f1 = R.branch(p, "initScaleNets_filter2", t)
    occ = f0[:, :1]
    w0, = R.filter_warp((x0,), off0, f0)
    w1, = R.filter_warp((x2,), off1, f1)
    blended = w0 / 2.0 + w1 / 2.0
    rin = torch.cat((blended, off0, off1, f0, f1, occ, occ), 1)
    return blended + R.rectify_net(p, rin)
