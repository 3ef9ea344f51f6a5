"""MEMC_Net_VE: the 7-frame video-enhancement model (port of
memcnet_tpu/models/memc_net_ve.py; reference networks/MEMC_Net_VE.py:129-290).

Pipeline, for frames f0..f6 with the center f3:
  pairs:     the 6 (center, neighbour) pairs, sample-major (B, 6, ...) -> 6B
  flow:      FlowNetS over the 6B pairs, x 20 (no /2: the warp target is the
             full neighbour offset, :292-296), bilinear x4 upsample; no
             projection
  filter:    one BN MonoNet5 trunk -> one fs^2-channel branch
  context:   ResNet conv1 (3 -> 64, 7x7) of the six neighbours and the
             center, sample-major (B, 7, ...) -> 7B, in one call (K4)
  warp:      one 6B filter_interp_warp of (neighbours, their contexts) (K1);
             the warped contexts are detached (:474)
  rectify:   center + EDSR(577 ch, 10 resblocks, 128 feats) over the
             contexts (7), flows (6), filters (6) and frames (7), in temporal
             order with the center passed through (:208-260)

``model.train()`` switches to train mode: BatchNorm on batch statistics
(running statistics updated in its buffers), the forward returns the warped
neighbours too, and ``train_residuals`` gives the seven loss residuals.
Every batch of frames is sample-major, so on partitioned frames
(``parallel.partition``) the tile index stays outermost in it and each
layer's halos come from the tile's own neighbours.
Module attribute names make the state-dict keys equal the JAX flat-dict keys.
"""

import torch
from torch import nn

from memcnet_tpu_torch.models import ctx as ctx_mod
from memcnet_tpu_torch.models import edsr, flownets
from memcnet_tpu_torch.models.memc_net import DIV_FLOW
from memcnet_tpu_torch.models.mononet import (
    branch_specs,
    build_modulelist,
    forward_single_path,
    init_specs,
    mononet5_specs,
)
from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn.layers import upsample_bilinear
from memcnet_tpu_torch.ops import filter_interp_warp_split

NEIGHBOURS = (0, 1, 2, 4, 5, 6)


class MEMCNetVE(nn.Module):
    """FlowNetS flow, a BN MonoNet5 filter net with one branch, the ctx conv,
    the split warp and the EDSR rectifier; kaiming init."""

    def __init__(self, filter_size=4, channel=3):
        super().__init__()
        self.filter_size = filter_size
        fs2 = filter_size * filter_size
        self.trunk_specs = mononet5_specs(channel, True, variant="full")
        self.filter_branch_specs = branch_specs(fs2)
        self.initScaleNets_filter = build_modulelist(self.trunk_specs)
        self.initScaleNets_filter1 = build_modulelist(self.filter_branch_specs)
        self.flownets = flownets.FlowNetS()
        self.ctxNet = ctx_mod.ContextNet()
        self.rectify_in = 3 * 7 + 64 * 7 + 2 * 6 + fs2 * 6  # MEMC_Net_VE.py:77
        self.rectifyNet = edsr.EDSR(self.rectify_in, n_resblocks=10, n_feats=128)

    def init_params(self, generator):
        """Seeded init with the reference's rules, in the JAX init order
        (trunk, filter branch, EDSR, FlowNetS, ctx)."""
        init_specs(self.initScaleNets_filter, self.trunk_specs, I.kaiming_uniform, generator)
        init_specs(self.initScaleNets_filter1, self.filter_branch_specs, I.kaiming_uniform,
                   generator)
        self.rectifyNet.init_params(generator, init_fn=I.kaiming_uniform)
        self.flownets.init_params(generator)
        self.ctxNet.init_params(generator)
        return self

    def forward(self, frames, debug=False):
        """frames: 7 tensors (B, 3, H, W), H divisible by 64 and W by 64
        (padded upstream).  Returns the rectified center frame (B, 3, H, W);
        with ``debug=True`` also the (6B, 2, H, W) flow and (6B, fs^2, H, W)
        filter, sample-major, as the JAX forward does.  In train mode it
        returns (outs, rectified): the six warped neighbours, not detached,
        in temporal order with the center frame at slot 3."""
        if len(frames) != 7:
            raise ValueError(f"MEMC_Net_VE takes 7 frames, got {len(frames)}")
        B = frames[0].shape[0]
        center = frames[3]
        neighbours = [frames[i] for i in NEIGHBOURS]
        hw = center.shape[2:]

        pairs = torch.stack([torch.cat((center, n), dim=1) for n in neighbours],
                            dim=1).reshape((6 * B, 6) + hw)
        flow = upsample_bilinear(self.flownets(pairs) * DIV_FLOW, 4)
        t = forward_single_path(self.initScaleNets_filter, self.trunk_specs, pairs)
        filt = forward_single_path(self.initScaleNets_filter1, self.filter_branch_specs, t)

        neigh = torch.stack(neighbours, dim=1).reshape((6 * B,) + center.shape[1:])
        ctx_all = self.ctxNet(torch.stack(neighbours + [center], dim=1).reshape(
            (7 * B,) + center.shape[1:])).reshape((B, 7, 64) + hw)
        ctx_n, ctx_c = ctx_all[:, :6].reshape((6 * B, 64) + hw), ctx_all[:, 6]

        def nb(x, k):  # neighbour k of the sample-major (B, 6, ...) layout
            return x.reshape((B, 6) + x.shape[1:])[:, k]

        w_all, cw_all = filter_interp_warp_split((neigh, ctx_n), flow, filt,
                                                 filter_size=self.filter_size)
        cw_all = cw_all.detach()  # MEMC_Net_VE.py:474
        warped = [nb(w_all, k) for k in range(6)]
        ctx_warped = [nb(cw_all, k) for k in range(6)]
        outs = warped[:3] + [center] + warped[3:]
        ctxs = ctx_warped[:3] + [ctx_c] + ctx_warped[3:]
        flows6 = [nb(flow, k) for k in range(6)]
        filts6 = [nb(filt, k) for k in range(6)]
        rectified = center + self.rectifyNet.forward_pieces(ctxs + flows6 + filts6 + outs)
        if self.training:
            return outs, rectified
        if debug:
            return rectified, flow, filt
        return rectified

    def train_residuals(self, frames, y):
        """MEMC_Net_VE.py:270-275: the six warped neighbours' residuals
        against the target y, with the rectified frame's in slot 3.  The
        BatchNorm running statistics are updated in their buffers (the JAX
        function returns them as ``bn_updates``)."""
        if not self.training:
            raise RuntimeError("train_residuals runs the train-mode forward: call model.train()")
        outs, rectified = self(frames)
        return [(rectified if i == 3 else outs[i]) - y for i in range(7)]
