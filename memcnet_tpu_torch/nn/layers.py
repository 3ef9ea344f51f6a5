"""Functional layers with the semantics of memcnet_tpu/nn/layers.py, on stock
PyTorch (the JAX package leaves these to XLA, so they take no hand kernel).

Weights keep the PyTorch layouts (conv OIHW, conv-transpose IOHW) and the
reference's state-dict names, so parameters move between the two packages
name for name.  PyTorch-0.2 semantics kept: bilinear upsampling is
align_corners=True; BatchNorm eval uses running statistics with eps 1e-5,
train mode the batch's (``batch_norm_train``).
The JAX package's sub-pixel form of ConvTranspose2d (layers.py:166-197) is a
TPU workaround and is not carried over.

``grid_sample_bilinear`` is the one layer here with a hand kernel (K5,
ops/cuda/gather_kernel.py); the JAX package's same-size-grid gate and its
lax.cond budget around the Pallas gather (layers.py:329, :418) were TPU
choices, so every grid shape takes the kernel on CUDA tensors.
"""

import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import gather_kernel


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def conv2d(x, w, b=None, *, stride=1, padding=0, groups=1):
    """PyTorch Conv2d.  w: (O, I/groups, kH, kW)."""
    return F.conv2d(x, _cast(w, x.dtype), _cast(b, x.dtype), stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(x, w, b=None, *, stride=2, padding=1):
    """PyTorch ConvTranspose2d.  w: (I, O, kH, kW)."""
    return F.conv_transpose2d(x, _cast(w, x.dtype), _cast(b, x.dtype), stride=stride,
                              padding=padding)


def upsample_bilinear(x, scale_factor=2):
    """PyTorch-0.2 nn.Upsample(mode='bilinear') == align_corners=True."""
    return F.interpolate(x, scale_factor=scale_factor, mode="bilinear", align_corners=True)


def max_pool2d(x, k=2, s=None):
    return F.max_pool2d(x, k, k if s is None else s)


def avg_pool2d(x, k=2, s=None):
    """Average pool, 'VALID' windows: odd sizes floor (layers.py:243-246)."""
    return F.avg_pool2d(x, k, k if s is None else s)


def replication_pad2d(x, pad):
    """pad = (left, right, top, bottom), PyTorch ReplicationPad2d order."""
    return F.pad(x, tuple(pad), mode="replicate")


def grid_sample_bilinear(x, grid):
    """F.grid_sample semantics, mode='bilinear', padding_mode='zeros',
    align_corners=True (layers.py:312-360): each out-of-range tap adds zero.
    x (B, C, H, W); grid (B, Ho, Wo, 2) normalised to [-1, 1], [..., 0] = x.
    Coordinates and tap weights are float32 whatever x's type; the result has
    x's type.  Kernel K5 on CUDA tensors, its plain version on CPU tensors."""
    return gather_kernel.grid_sample(x, grid)


def relu(x):
    return F.relu(x)


def leaky_relu(x, negative_slope=0.1):
    return F.leaky_relu(x, negative_slope)


def batch_norm_eval(x, gamma, beta, running_mean, running_var, eps=1e-5):
    """BatchNorm2d in eval mode (running statistics); scale and shift are
    formed in float32, as layers.py:200-205 does."""
    inv = torch.rsqrt(running_var.float() + eps)
    scale = gamma.float() * inv
    shift = beta.float() - running_mean.float() * scale
    return x * scale.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


def _synced_moments(x32, group):
    """The batch mean and biased variance per channel over every rank of
    ``group`` (a per-channel sum, then a centred sum of squares, each
    all-reduced, differentiably), and the whole batch's count."""
    from memcnet_tpu_torch.parallel.ring import all_reduce_sum

    n_local = x32.shape[0] * x32.shape[2] * x32.shape[3]
    sums = all_reduce_sum(torch.cat([x32.sum(dim=(0, 2, 3)), x32.new_tensor([n_local])]), group)
    n = float(sums.detach()[-1])
    mean = sums[:-1] / n
    var = all_reduce_sum((x32 - mean.view(1, -1, 1, 1)).square().sum(dim=(0, 2, 3)), group) / n
    return mean, var, int(n)


def batch_norm_train(x, gamma, beta, running_mean, running_var, momentum=0.1, eps=1e-5):
    """BatchNorm2d in train mode (layers.py:208-232, torch's semantics):
    normalise by the biased batch variance, in float32 whatever x's type, and
    return the running statistics updated with the unbiased variance at
    ``momentum``: running = (1 - momentum) * running + momentum * batch.
    Returns (y in x's type, new running mean, new running var); the new
    statistics keep the running statistics' type and carry no gradient.

    Inside ``parallel.data_parallel(group)`` the batch is the whole batch
    over the group's ranks, as GSPMD gives a batch-sharded BatchNorm in the
    JAX package: the per-channel sum and centred sum are all-reduced, and the
    unbiased count is the whole batch's."""
    from memcnet_tpu_torch.parallel.context import active_data_group

    x32 = x.float()
    group = active_data_group()
    if group is not None:
        mean, var, n = _synced_moments(x32, group)
    else:
        mean = x32.mean(dim=(0, 2, 3))
        var = (x32 - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = ((1.0 - momentum) * running_mean.float() + momentum * mean)
        new_var = ((1.0 - momentum) * running_var.float() + momentum * unbiased)
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean.view(1, -1, 1, 1)) * (gamma.float() * inv).view(1, -1, 1, 1)
    y = y + beta.float().view(1, -1, 1, 1)
    return y.to(x.dtype), new_mean.to(running_mean.dtype), new_var.to(running_var.dtype)
