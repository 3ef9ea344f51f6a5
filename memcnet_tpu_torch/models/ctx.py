"""Context extractor: ResNet18 conv1 at stride 1 (port of
memcnet_tpu/models/ctx.py; reference networks/ResNet/Resnet_conv1.py).

One 7x7 3 -> 64 conv, no bias, over a channel-normalised input.  The
reference's normalisation quirk is kept (Resnet_conv1.py:263-265, ctx.py:23-24
in JAX): mean 0.485 for all three channels and std 0.224 for G and B.  The
conv is kernel K4 (ops/cuda/conv_kernel.py) on CUDA tensors.  On partitioned
frames (``parallel.partition``) K4 runs once over every stacked tile, each
extended by 3 columns (and rows, where H is tiled) of the normalised input
from its neighbours (``nn.layers.conv2d_k4``).
Key: ctxNet.conv1.weight.
"""

import torch
from torch import nn

from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn.layers import conv2d_k4

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
        # the halo of the normalised input: zero padding applies after it
        return conv2d_k4((x - self.mean.to(x.dtype)) / self.std.to(x.dtype), self.conv1.weight)
