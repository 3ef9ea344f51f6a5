"""The three frame-interpolation models: MEMC_Net, MEMC_Net_s and
MEMC_Net_star (port of memcnet_tpu/models/memc_net.py; reference
MEMC_Net.py:69-146, MEMC_Net_s.py:62-145, MEMC_Net_star.py:78-169).

Pipeline, for frames x0 and x2:
  flow:      FlowNetS on both directions batched, x (20/2), bilinear x4 upsample
             [_s: SPyNet(first, second) / 2, at full resolution already],
             flow_project to the middle time, with the hole fill in eval
             mode only (memc_net.py:152)
  filter:    MonoNet5 trunk -> two fs^2-channel branches
  occlusion: MonoNet5 trunk -> 0.5 + two 1-channel branches
             (filter and occlusion nets: two walks or one groups=2 walk,
              as mononet.on_k4 decides)
             [_s: one thin trunk; occlusions = filter branch 0, channel 0]
  [star]:    ResNet conv1 (3 -> 64, 7x7) contexts of both frames, one call
  warp:      filter_interp_warp per frame [star: of (frame, context)]
  blend:     occ0 * w0 + occ1 * w1  [_s: w0 / 2 + w1 / 2]
  rectify:   blend + 8-conv RectifyNet over (blend, offsets, filters,
             occlusions)  [star: EDSR(169 ch, 10 resblocks, 128 feats) with
             the warped contexts, detached]

``model.train()`` switches to train mode: no hole fill, BatchNorm on batch
statistics with the running statistics updated in its buffers, and
``train_residuals`` gives the loss residuals.  MEMC_Net_VE is in
models/memc_net_ve.py.  Module attribute names make the state-dict keys equal
the JAX flat-dict keys.
"""

import torch
from torch import nn

from memcnet_tpu_torch.models import ctx as ctx_mod
from memcnet_tpu_torch.models import edsr, flownets, spynet
from memcnet_tpu_torch.models.mononet import (
    branch_specs,
    build_modulelist,
    forward_dual_path,
    forward_single_path,
    init_specs,
    mononet5_specs,
    rectify_specs,
)
from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn.layers import upsample_bilinear
from memcnet_tpu_torch.ops import filter_interp_warp, filter_interp_warp_split, flow_project
from memcnet_tpu_torch.utils import tracing

DIV_FLOW = 20.0


class MEMCNet(nn.Module):
    """MEMC_Net: FlowNetS flow, paired BN MonoNet5 filter / occlusion nets,
    the occlusion-weighted blend and the 8-conv RectifyNet; kaiming init.
    Subclasses change the flow net, trunk, rectifier and blend."""

    variant = "full"
    with_bn = True
    init_fn = staticmethod(I.kaiming_uniform)
    has_occlusion_net = True
    flow_net = flownets.FlowNetS

    def __init__(self, filter_size=4, channel=3):
        super().__init__()
        self.filter_size = filter_size
        fs2 = filter_size * filter_size
        self.trunk_specs = mononet5_specs(channel, self.with_bn, variant=self.variant)
        self.filter_branch_specs = branch_specs(fs2)
        self.occ_branch_specs = branch_specs(1)
        self.initScaleNets_filter = build_modulelist(self.trunk_specs)
        self.initScaleNets_filter1 = build_modulelist(self.filter_branch_specs)
        self.initScaleNets_filter2 = build_modulelist(self.filter_branch_specs)
        if self.has_occlusion_net:
            self.initScaleNets_occlusion = build_modulelist(self.trunk_specs)
            self.initScaleNets_occlusion1 = build_modulelist(self.occ_branch_specs)
            self.initScaleNets_occlusion2 = build_modulelist(self.occ_branch_specs)
        self.flownets = self.flow_net()
        self._build_rectify()

    def _build_rectify(self):
        fs2 = self.filter_size * self.filter_size
        self.rectify_in = 3 + 4 + 2 * fs2 + 2  # MEMC_Net.py:32
        self.rectify_specs = rectify_specs(self.rectify_in)
        self.rectifyNet = build_modulelist(self.rectify_specs)

    def _mononet_parts(self):
        parts = [
            (self.initScaleNets_filter, self.trunk_specs),
            (self.initScaleNets_filter1, self.filter_branch_specs),
            (self.initScaleNets_filter2, self.filter_branch_specs),
        ]
        if self.has_occlusion_net:
            parts += [
                (self.initScaleNets_occlusion, self.trunk_specs),
                (self.initScaleNets_occlusion1, self.occ_branch_specs),
                (self.initScaleNets_occlusion2, self.occ_branch_specs),
            ]
        return parts

    def init_params(self, generator):
        """Seeded init with the reference's rules, in the JAX init order
        (MonoNets, rectifier, flow net, then the rest)."""
        for modules, specs in self._mononet_parts():
            init_specs(modules, specs, self.init_fn, generator)
        self._init_rectify(generator)
        self.flownets.init_params(generator)
        self._init_extra(generator)
        return self

    def _init_rectify(self, generator):
        init_specs(self.rectifyNet, self.rectify_specs, self.init_fn, generator)

    def _init_extra(self, generator):
        pass

    def _flow(self, x0, x2):
        """Both directions' flows, batched sample-major as (2B, 2, H, W)
        (memc_net.py:94-108): FlowNetS x (20/2), bilinear x4 upsample."""
        B = x0.shape[0]
        p01 = torch.cat((x0, x2), dim=1)
        p10 = torch.cat((x2, x0), dim=1)
        pairs = torch.stack((p01, p10), dim=1).reshape((2 * B,) + p01.shape[1:])
        return upsample_bilinear(self.flownets(pairs) * (DIV_FLOW / 2.0), 4)

    def _flows(self, x0, x2, fillhole):
        with tracing.span("flow"):
            f = self._flow(x0, x2)
        with tracing.span("project"):
            off = flow_project(f, fillhole=fillhole).reshape((x0.shape[0], 2, 2) + f.shape[2:])
        return off[:, 0], off[:, 1]

    def _filters_and_occlusions(self, pair):
        t_f, t_o = forward_dual_path(self.initScaleNets_filter, self.initScaleNets_occlusion,
                                     self.trunk_specs, pair)
        filters = forward_dual_path(self.initScaleNets_filter1, self.initScaleNets_filter2,
                                    self.filter_branch_specs, t_f)
        o0, o1 = forward_dual_path(self.initScaleNets_occlusion1, self.initScaleNets_occlusion2,
                                   self.occ_branch_specs, t_o)
        return filters, (0.5 + o0, 0.5 + o1)

    def _blend(self, warped0, warped1, occ):
        return occ[0] * warped0 + occ[1] * warped1  # MEMC_Net.py:263

    def _contexts(self, x0, x2):
        """What the warp carries beside the frames: nothing here."""
        return None

    def _warp(self, x0, x2, offs, filters, ctx):
        """Both frames warped (K1), and the warped contexts (none here)."""
        fs = self.filter_size
        w0 = filter_interp_warp(x0, offs[0], filters[0], filter_size=fs)
        w1 = filter_interp_warp(x2, offs[1], filters[1], filter_size=fs)
        return w0, w1, None

    def _rectify(self, blended, offs, filters, occs, ctxs):
        rin = torch.cat((blended, offs[0], offs[1], filters[0], filters[1], occs[0], occs[1]),
                        dim=1)
        return blended + forward_single_path(self.rectifyNet, self.rectify_specs, rin)

    def forward(self, x0, x2):
        """x0, x2: (B, 3, H, W), H and W multiples of 128 (padded upstream).
        Returns ((interp, rectified), (off0, off1), (filt0, filt1),
        (occ0, occ1)), as the JAX forward in the module's mode.  Each stage
        runs in its span (``utils/tracing.py``)."""
        with tracing.span("forward", x0):
            offs = self._flows(x0, x2, fillhole=not self.training)
            with tracing.span("filters"):
                filters, occs = self._filters_and_occlusions(torch.cat((x0, x2), dim=1))
            ctx = self._contexts(x0, x2)
            with tracing.span("warp"):
                w0, w1, ctxs = self._warp(x0, x2, offs, filters, ctx)
            with tracing.span("blend"):
                blended = self._blend(w0, w1, occs)
            with tracing.span("rectify"):
                rectified = self._rectify(blended, offs, filters, occs, ctxs)
            return (blended, rectified), offs, filters, occs

    def train_residuals(self, x0, x1, x2):
        """Train-mode loss residuals (MEMC_Net.py:132-137): returns
        ([interp - x1, rectified - x1], offsets, filters, occlusions) for the
        middle frame x1.  The BatchNorm running statistics are updated in
        their buffers (the JAX function returns them as ``bn_updates``)."""
        if not self.training:
            raise RuntimeError("train_residuals runs the train-mode forward: call model.train()")
        (blended, rectified), offs, filters, occs = self(x0, x2)
        return [blended - x1, rectified - x1], offs, filters, occs


class MEMCNetS(MEMCNet):
    """MEMC_Net_s: SPyNet flow at full resolution halved (MEMC_Net_s.py:147-156),
    one thin BN MonoNet5 trunk with the paired filter branches, no occlusion
    net (pseudo-occlusions from filter branch 0, channel 0, :111-114) and the
    plain average blend (:260-266)."""

    variant = "thin"
    has_occlusion_net = False
    flow_net = spynet.SPyNet

    def _flow(self, x0, x2):
        B = x0.shape[0]
        first = torch.stack((x0, x2), dim=1).reshape((2 * B,) + x0.shape[1:])
        second = torch.stack((x2, x0), dim=1).reshape((2 * B,) + x0.shape[1:])
        return self.flownets(first, second) / 2.0

    def _filters_and_occlusions(self, pair):
        t = forward_single_path(self.initScaleNets_filter, self.trunk_specs, pair)
        filters = forward_dual_path(self.initScaleNets_filter1, self.initScaleNets_filter2,
                                    self.filter_branch_specs, t)
        occ = filters[0][:, :1]
        return filters, (occ, occ)

    def _blend(self, warped0, warped1, occ):
        return warped0 / 2.0 + warped1 / 2.0  # MEMC_Net_s.py:264


class MEMCNetStar(MEMCNet):
    """MEMC-Net*: ResNet-conv1 contexts (warped, detached) and the EDSR
    rectifier (MEMC_Net_star.py:35,127-148,272-285); xavier init (:64);
    MonoNet pool/unpool blocks without BatchNorm (:313-345)."""

    with_bn = False
    init_fn = staticmethod(I.xavier_uniform)

    def __init__(self, filter_size=4, channel=3):
        super().__init__(filter_size, channel)
        self.ctxNet = ctx_mod.ContextNet()

    def _build_rectify(self):
        fs2 = self.filter_size * self.filter_size
        self.rectify_in = 3 + 2 * 2 + 2 * fs2 + 64 * 2 + 1 * 2  # MEMC_Net_star.py:35
        self.rectifyNet = edsr.EDSR(self.rectify_in, n_resblocks=10, n_feats=128)

    def _init_rectify(self, generator):
        self.rectifyNet.init_params(generator, init_fn=self.init_fn)

    def _init_extra(self, generator):
        self.ctxNet.init_params(generator)

    def _contexts(self, x0, x2):
        """Both frames' ResNet-conv1 contexts, one call: (B, 2, 64, H, W)."""
        B = x0.shape[0]
        with tracing.span("ctx"):
            cc = self.ctxNet(torch.stack((x0, x2), dim=1).reshape((2 * B,) + x0.shape[1:]))
            return cc.reshape((B, 2) + cc.shape[1:])

    def _warp(self, x0, x2, offs, filters, ctx):
        """Each frame warped with its context (K1's split warp); the warped
        contexts detached (MEMC_Net_star.py:285)."""
        fs = self.filter_size
        w0, ctx0 = filter_interp_warp_split((x0, ctx[:, 0]), offs[0], filters[0], filter_size=fs)
        w1, ctx1 = filter_interp_warp_split((x2, ctx[:, 1]), offs[1], filters[1], filter_size=fs)
        return w0, w1, (ctx0.detach(), ctx1.detach())

    def _rectify(self, blended, offs, filters, occs, ctxs):
        pieces = (blended, offs[0], offs[1], filters[0], filters[1],
                  occs[0], occs[1], ctxs[0], ctxs[1])  # MEMC_Net_star.py:142-147 order
        return blended + self.rectifyNet.forward_pieces(pieces)
