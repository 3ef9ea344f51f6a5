"""SPyNet: 6-level spatial-pyramid residual flow (port of
memcnet_tpu/models/spynet.py; reference networks/SPyNet/Network.py).

Per level, Basic = five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2 with ReLU
between them; every one of them, at every level, is kernel K4 on CUDA tensors
(ops/cuda/conv_kernel.py), with bias and ReLU fused.  The JAX package's 96x96
gate in front of its Pallas conv was a TPU heuristic.  Pyramid: average-pool
x2 while a level is larger than 32 px (up to 6 levels, static per input
size); the flow starts as zeros at half the coarsest size; each level
upsamples the flow x2 (bilinear, align_corners=True, times 2.0),
replicate-pads it by one on an odd size, and adds a residual predicted from
cat(first, warp(second, flow_up), flow_up).  That input -- the upsample, the
pad, the float32 grid, the grid-sample warp and the concat -- is one launch
of kernel K5 per level on CUDA tensors (ops/cuda/gather_kernel.py::
level_input), and the residual adds its flow_up channels.

On partitioned frames (``parallel.partition``) every conv runs on its
halo-extended tile (``nn.layers.conv2d_k4``), the pools gather their 0-1
halos, the pyramid's sizes are the partition's global level sizes, and each
level input is one launch of K5's tile entry (``level_input_tile``) on the
second frame's whole level (``Partition.gather``: the warp samples anywhere)
and the coarse flow's window (``Partition.level_input_window``), on the
frame's global coordinates.

Its base grid and flow terms are float32 whatever the activation type: the
JAX package builds them in x's type (spynet.py:77-81), which in bf16 puts the
sampled column up to 7 px off at W = 1344 (ROADMAP.md Queue C).

Preprocess keeps the reference's channel quirk (Network.py:66-75): the input is
read as BGR and emitted as normalised RGB.
Keys: flownets.moduleBasic.{L}.moduleBasic.{0,2,4,6,8}.{weight,bias}.
"""

import torch
from torch import nn

from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn import layers as L
from memcnet_tpu_torch.ops.cuda import gather_kernel
from memcnet_tpu_torch.ops.cuda.gather_kernel import warp_grid

BASIC = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]
LEVELS = 6


class _Basic(nn.Module):
    def __init__(self):
        super().__init__()
        mods = []
        for j, (cin, cout) in enumerate(BASIC):
            mods.append(nn.Conv2d(cin, cout, 7, 1, 3))
            if j < len(BASIC) - 1:
                mods.append(nn.ReLU())
        self.moduleBasic = nn.Sequential(*mods)

    def convs(self):
        return [self.moduleBasic[2 * j] for j in range(len(BASIC))]

    def forward(self, x):
        h = x
        for j, conv in enumerate(self.convs()):
            h = L.conv2d_k4(h, conv.weight, conv.bias, relu=j < len(BASIC) - 1)
        return h


def _preprocess(x):
    b = (x[:, 0:1] - 0.406) / 0.225
    g = (x[:, 1:2] - 0.456) / 0.224
    r = (x[:, 2:3] - 0.485) / 0.229
    return torch.cat([r, g, b], dim=1)


def _backward_warp(x, flow):
    """grid_sample warp of x by a flow in pixels, the grid in float32."""
    return L.grid_sample_bilinear(x, warp_grid(flow))


class SPyNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.moduleBasic = nn.ModuleList([_Basic() for _ in range(LEVELS)])

    @torch.no_grad()
    def init_params(self, generator):
        """torch-0.2 Conv2d default for weights and biases (spynet.py:35-44),
        level by level, weight then bias."""
        for basic in self.moduleBasic:
            for conv in basic.convs():
                fan_in = conv.in_channels * 49
                conv.weight.copy_(I.torch_default_uniform(tuple(conv.weight.shape), generator))
                conv.bias.copy_(I.torch_default_uniform(tuple(conv.bias.shape), generator,
                                                        fan_in=fan_in))

    def forward(self, first, second):
        """first, second: (B, 3, H, W) in [0, 1] -> (B, 2, H, W) flow in
        pixels; or the tiles of partitioned frames -> the flow's tiles."""
        part = L.active_partition()

        def size(x):  # the level's (global) H and W
            return tuple(x.shape[2:]) if part is None else part.level(x)

        firsts = [_preprocess(first)]
        seconds = [_preprocess(second)]
        for _ in range(LEVELS - 1):
            if max(size(firsts[0])) > 32:
                firsts.insert(0, L.avg_pool2d(firsts[0], 2))
                seconds.insert(0, L.avg_pool2d(seconds[0], 2))
        h0, w0 = (g // 2 for g in size(firsts[0]))
        if part is not None:
            h0, w0 = part.tile_size(h0, w0)
        flow = torch.zeros((first.shape[0], 2, h0, w0), dtype=first.dtype, device=first.device)
        for lvl, (fst, snd) in enumerate(zip(firsts, seconds)):
            if part is None:
                inp = gather_kernel.level_input(fst, snd, flow)  # cat(fst, warp(snd, up), up)
            else:
                window, origins, (GH, GW) = part.level_input_window(flow, fst)
                inp = gather_kernel.level_input_tile(fst, part.gather(snd), window, origins,
                                                     GH, GW)
            flow = self.moduleBasic[lvl](inp) + inp[:, 6:8]
        return flow
