"""MonoNet5 U-Net trunks, their conv-relu-conv branches and the RectifyNet as
layer specs (port of memcnet_tpu/models/mononet.py; reference
MEMC_Net.py:154-250, MEMC_Net_s.py:192-239, MEMC_Net_star.py:204-262).

A spec list ``[(kind, flat_idx, meta)]`` mirrors the reference's flat
nn.ModuleList; ``build_modulelist`` makes that ModuleList, so state-dict keys
are the reference's (e.g. ``initScaleNets_filter.12.weight``).  The walkers
push the tensor entering each max-pool and add it back after each upsample
(MEMC_Net.py:154-178).  BatchNorm follows each module's mode, so
``model.train()`` switches it to batch statistics.  The JAX package's
block-diagonal dense weights and its env-gated Pallas routing
(mononet.py:27-41, 155-160) are TPU workarounds; here the paired
filter/occlusion walk is a ``groups=2`` conv.
"""

import torch
from torch import nn

from memcnet_tpu_torch.nn import layers as L


def _blocks_to_specs(blocks, with_bn):
    """blocks: ('c'|'cp'|'cu'|'uc', cin, cout) -> flat spec list mirroring
    ModuleList order ('cp' = conv-relu[-bn]-maxpool, 'cu' =
    conv-relu[-bn]-upsample, 'uc' = upsample-conv-relu[-bn], MEMC_Net_s's
    order, where the skip add lands before the conv)."""
    specs = []
    i = 0
    for kind, cin, cout in blocks:
        if kind == "uc":
            specs.append(("upsample", i, None)); i += 1
        specs.append(("conv", i, (cin, cout))); i += 1
        specs.append(("relu", i, None)); i += 1
        if kind in ("cp", "cu", "uc"):
            if with_bn:
                specs.append(("bn", i, cout)); i += 1
            if kind == "cp":
                specs.append(("maxpool", i, None)); i += 1
            elif kind == "cu":
                specs.append(("upsample", i, None)); i += 1
    return specs


def mononet5_specs(channel_in, with_bn=True, *, variant="full"):
    """Trunk specs; ``channel_in`` is per frame and the first conv takes the
    two stacked frames.  ``variant``: "full" (MEMC_Net, MEMC_Net_star) or
    "thin" (MEMC_Net_s, one conv per block)."""
    c2 = channel_in * 2
    if variant == "thin":  # MEMC_Net_s.py:192-239
        blocks = [
            ("c", c2, 16), ("cp", 16, 32),
            ("cp", 32, 64),
            ("cp", 64, 128),
            ("cp", 128, 256),
            ("cp", 256, 512),
            ("c", 512, 512),
            ("uc", 512, 256),
            ("uc", 256, 128),
            ("uc", 128, 64),
            ("uc", 64, 32),
            ("uc", 32, 16),
        ]
        return _blocks_to_specs(blocks, with_bn)
    if variant != "full":
        raise ValueError(variant)
    blocks = [
        ("c", c2, 32), ("c", 32, 32), ("cp", 32, 32),
        ("c", 32, 64), ("cp", 64, 64),
        ("c", 64, 128), ("cp", 128, 128),
        ("c", 128, 256), ("cp", 256, 256),
        ("c", 256, 512), ("cp", 512, 512),
        ("c", 512, 512), ("c", 512, 512),
        ("cu", 512, 512), ("c", 512, 256),
        ("cu", 256, 256), ("c", 256, 128),
        ("cu", 128, 128), ("c", 128, 64),
        ("cu", 64, 64), ("c", 64, 32),
        ("cu", 32, 32), ("c", 32, 16),
    ]
    return _blocks_to_specs(blocks, with_bn)


def branch_specs(channel_out):
    """conv_relu_conv branch: Conv(16,16) / ReLU / Conv(16,out)."""
    return [("conv", 0, (16, 16)), ("relu", 1, None), ("conv", 2, (16, channel_out))]


def rectify_specs(channel_in):
    """get_RectifyNet2 (MEMC_Net.py:240-250): 7 conv-relu (-> 64) and a final
    conv to 3 channels."""
    specs = _blocks_to_specs([("c", channel_in, 64)] + [("c", 64, 64)] * 6, with_bn=False)
    specs.append(("conv", specs[-1][1] + 1, (64, 3)))
    return specs


def build_modulelist(specs):
    """The reference's flat ModuleList for ``specs`` (keys = flat indices)."""
    mods = []
    for kind, _idx, meta in specs:
        if kind == "conv":
            mods.append(nn.Conv2d(meta[0], meta[1], 3, 1, 1))
        elif kind == "relu":
            mods.append(nn.ReLU())
        elif kind == "bn":
            mods.append(nn.BatchNorm2d(meta))
        elif kind == "maxpool":
            mods.append(nn.MaxPool2d(2))
        elif kind == "upsample":
            mods.append(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True))
        else:
            raise ValueError(kind)
    return nn.ModuleList(mods)


@torch.no_grad()
def init_specs(modules, specs, init_fn, generator):
    """Conv weights from ``init_fn``, zero biases; BN weight 1, bias 0,
    running mean 0, running var 1 (mononet.py:118-132)."""
    for kind, idx, _meta in specs:
        m = modules[idx]
        if kind == "conv":
            m.weight.copy_(init_fn(tuple(m.weight.shape), generator))
            m.bias.zero_()
        elif kind == "bn":
            m.reset_parameters()


def _bn(m, x):
    """BatchNorm ``m`` in its own mode: running statistics in eval mode; in
    train mode batch statistics, and the new running statistics written
    into ``m``'s buffers (the JAX walkers return them as ``bn_updates``)."""
    if not m.training:
        return L.batch_norm_eval(x, m.weight, m.bias, m.running_mean, m.running_var, m.eps)
    y, new_mean, new_var = L.batch_norm_train(x, m.weight, m.bias, m.running_mean,
                                              m.running_var, m.momentum, m.eps)
    with torch.no_grad():
        m.running_mean.copy_(new_mean)
        m.running_var.copy_(new_var)
    return y


def forward_single_path(modules, specs, x):
    """The reference stack walk (MEMC_Net.forward_singlePath); each BatchNorm
    runs in its module's mode (``model.train()`` / ``model.eval()``)."""
    stack = []
    cur = x
    for kind, idx, _meta in specs:
        m = modules[idx]
        if kind == "conv":
            cur = L.conv2d(cur, m.weight, m.bias, stride=1, padding=1)
        elif kind == "relu":
            cur = L.relu(cur)
        elif kind == "bn":
            cur = _bn(m, cur)
        elif kind == "maxpool":
            stack.append(cur)
            cur = L.max_pool2d(cur, 2)
        elif kind == "upsample":
            cur = L.upsample_bilinear(cur, 2) + stack.pop()
    if stack:
        raise ValueError("unbalanced pool/upsample specs")
    return cur


def forward_dual_path(modules_a, modules_b, specs, x):
    """Two identical-spec nets on the same input as one walk of ``groups=2``
    convs (channels [a | b]).  Each half keeps its own BatchNorm, in that
    module's mode: per-channel statistics make this the JAX walk's BatchNorm
    over the concatenated channels.  Returns (out_a, out_b)."""
    stack = []
    cur = torch.cat([x, x], dim=1)
    for kind, idx, _meta in specs:
        ma, mb = modules_a[idx], modules_b[idx]
        if kind == "conv":
            w = torch.cat([ma.weight, mb.weight], dim=0)
            b = torch.cat([ma.bias, mb.bias], dim=0)
            cur = L.conv2d(cur, w, b, stride=1, padding=1, groups=2)
        elif kind == "relu":
            cur = L.relu(cur)
        elif kind == "bn":
            h = cur.shape[1] // 2
            cur = torch.cat([_bn(ma, cur[:, :h]), _bn(mb, cur[:, h:])], dim=1)
        elif kind == "maxpool":
            stack.append(cur)
            cur = L.max_pool2d(cur, 2)
        elif kind == "upsample":
            cur = L.upsample_bilinear(cur, 2) + stack.pop()
    if stack:
        raise ValueError("unbalanced pool/upsample specs")
    h = cur.shape[1] // 2
    return cur[:, :h], cur[:, h:]
