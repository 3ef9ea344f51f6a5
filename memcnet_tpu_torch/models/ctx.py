"""Context extractor: ResNet18 conv1 at stride 1 (port of
memcnet_tpu/models/ctx.py; reference networks/ResNet/Resnet_conv1.py).

One 7x7 3 -> 64 conv, no bias, over a channel-normalised input.  The
reference's normalisation quirk is kept (Resnet_conv1.py:263-265, ctx.py:23-24
in JAX): mean 0.485 for all three channels and std 0.224 for G and B.  The
conv is kernel K4 (ops/cuda/conv_kernel.py) on CUDA tensors.  On partitioned
frames (``parallel.partition``) K4 runs once over every stacked tile, each
extended by 3 columns (and rows, where H is tiled) of the normalised input
from its neighbours, zeros beyond the frame's edge; K4's 'same' padding then
touches only the columns cropped afterwards.
Key: ctxNet.conv1.weight.
"""

import torch
from torch import nn

from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn.layers import active_partition
from memcnet_tpu_torch.ops.cuda import conv_kernel

MEAN = (0.485, 0.485, 0.485)
STD = (0.229, 0.224, 0.224)


class ContextNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 1, 3, bias=False)
        # not in the state dict; follow the module's device and type
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1), persistent=False)

    @torch.no_grad()
    def init_params(self, generator):
        self.conv1.weight.copy_(I.resnet_msra(tuple(self.conv1.weight.shape), generator))

    def forward(self, x):
        y = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        part = active_partition()
        if part is None:
            return conv_kernel.conv2d_small(y, self.conv1.weight, None)
        # the halo of the normalised input: zero padding applies after it
        ext, pads = part.conv_input(y, (7, 7), (1, 1), (3, 3))
        out = conv_kernel.conv2d_small(ext, self.conv1.weight, None)
        for dim, p in ((-2, pads[0]), (-1, pads[1])):
            if p == 0:  # a tiled axis
                out = out.narrow(dim, 3, out.shape[dim] - 6)
        return out
