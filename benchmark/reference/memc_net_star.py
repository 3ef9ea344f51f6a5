"""MEMC_Net_star in plain float32 (MEMC_Net_star.py:78-169, eval mode).

flow: FlowNetS on (x0, x2) and (x2, x0), times 20/2, bilinear x4, projected
to the middle time with the hole fill; filters and occlusions: two MonoNet5
trunks without BatchNorm, two 16-tap filter branches and two occlusion
branches (0.5 + each); contexts: ResNet conv1 of each frame; the filter warp
of (frame, context) by its projected flow and filter; the blend occ0 * w0 +
occ1 * w1; the rectified frame: blend + EDSR(169 channels, 10 resblocks, 128
features) over (blend, offsets, filters, occlusions, warped contexts).
"""

import torch

from benchmark.reference import layers as R

DIV_FLOW = 20.0


def forward(p, x0, x2):
    """(B, 3, H, W) float32 pairs -> the rectified middle frames."""
    B = x0.shape[0]
    flows = R.flownets(p, torch.cat((torch.cat((x0, x2), 1), torch.cat((x2, x0), 1)), 0))
    flows = R.upsample(flows * (DIV_FLOW / 2.0), 4)
    off0, off1 = R.project(flows, fillhole=True).split(B)
    pair = torch.cat((x0, x2), 1)
    t_f = R.unet(p, "initScaleNets_filter", R.MONONET_FULL, False, pair)
    t_o = R.unet(p, "initScaleNets_occlusion", R.MONONET_FULL, False, pair)
    f0 = R.branch(p, "initScaleNets_filter1", t_f)
    f1 = R.branch(p, "initScaleNets_filter2", t_f)
    o0 = 0.5 + R.branch(p, "initScaleNets_occlusion1", t_o)
    o1 = 0.5 + R.branch(p, "initScaleNets_occlusion2", t_o)
    c0, c1 = R.context(p, torch.cat((x0, x2), 0)).split(B)
    w0, ctx0 = R.filter_warp((x0, c0), off0, f0)
    w1, ctx1 = R.filter_warp((x2, c1), off1, f1)
    blended = o0 * w0 + o1 * w1
    pieces = (blended, off0, off1, f0, f1, o0, o1, ctx0, ctx1)  # MEMC_Net_star.py:142-147
    return blended + R.edsr(p, torch.cat(pieces, 1))
