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

Partitioned frames (``parallel.mesh.shard_frames``): where the active
``spatial_tiling`` context holds a partition, every input is a tile of it.
The convs, the deconv and the max- and average pools gather their halos
(``parallel.partition``) and run with no padding on the tiled axes; K4's
'same' conv (``conv2d_k4``) runs on the halo-extended tile and crops; the
upsample lerps on the frame's global coordinates; train-mode BatchNorm
takes its statistics over the pixels the tiles own, over every rank of the
mesh.  The elementwise layers and eval-mode BatchNorm need nothing.
``replication_pad2d`` takes an edge-replicating halo onto the padded
extent, a derived extent of the frame (``Partition.clamped_take``), and
``grid_sample_bilinear`` samples x's level whole (``Partition.gather``) at
the grid's tiles, normalised to the whole frame, in one launch of K5's
general entry, as the JAX layers (layers.py:302, :312) run on sharded
arrays; no model calls them on tiles, since SPyNet's level input
(ops/cuda/gather_kernel.py::level_input_tile) does their work there.
"""

import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel


def _context():
    # imported when called: memcnet_tpu_torch.parallel imports the models
    from memcnet_tpu_torch.parallel import context

    return context


def active_partition():
    return _context().active_partition()


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def conv2d(x, w, b=None, *, stride=1, padding=0, groups=1):
    """PyTorch Conv2d.  w: (O, I/groups, kH, kW)."""
    part = active_partition()
    if part is not None:
        x, padding = part.conv_input(x, w.shape[-2:], _pair(stride), _pair(padding))
    return F.conv2d(x, _cast(w, x.dtype), _cast(b, x.dtype), stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(x, w, b=None, *, stride=2, padding=1):
    """PyTorch ConvTranspose2d.  w: (I, O, kH, kW)."""
    part = active_partition()
    if part is None:
        return F.conv_transpose2d(x, _cast(w, x.dtype), _cast(b, x.dtype), stride=stride,
                                  padding=padding)
    if w.shape[-1] != w.shape[-2]:
        raise NotImplementedError("a partitioned conv_transpose2d takes square kernels")
    x, pads, crop = part.deconv_input(x, w.shape[-1], stride, padding)
    return crop(F.conv_transpose2d(x, _cast(w, x.dtype), _cast(b, x.dtype), stride=stride,
                                   padding=pads))


def upsample_bilinear(x, scale_factor=2):
    """PyTorch-0.2 nn.Upsample(mode='bilinear') == align_corners=True."""
    part = active_partition()
    if part is not None:
        return part.upsample(x, scale_factor)
    return F.interpolate(x, scale_factor=scale_factor, mode="bilinear", align_corners=True)


def conv2d_k4(x, w, b=None, *, relu=False):
    """Kernel K4's stride-1 'same' conv (ops/cuda/conv_kernel.py, bias and
    ReLU fused).  On partitioned frames K4 runs once over every tile
    extended by k // 2 columns (and rows, where H is tiled) of x, zeros
    beyond the frame's edge; K4's own padding then touches only the
    positions cropped afterwards."""
    part = active_partition()
    if part is None:
        return conv_kernel.conv2d_small(x, w, b, relu=relu)
    p = w.shape[-1] // 2
    ext, pads = part.conv_input(x, w.shape[-2:], (1, 1), (p, p))
    out = conv_kernel.conv2d_small(ext, w, b, relu=relu)
    for dim, pad in ((-2, pads[0]), (-1, pads[1])):
        if pad == 0:  # a tiled axis
            out = out.narrow(dim, p, out.shape[dim] - 2 * p)
    return out


def _pool(fn, x, k, s):
    s = k if s is None else s
    part = active_partition()
    if part is not None:
        x, pads = part.conv_input(x, _pair(k), _pair(s), (0, 0))
        if any(pads):
            raise AssertionError(pads)
    return fn(x, k, s)


def max_pool2d(x, k=2, s=None):
    return _pool(F.max_pool2d, x, k, s)


def avg_pool2d(x, k=2, s=None):
    """Average pool, 'VALID' windows: odd sizes floor (layers.py:243-246)."""
    return _pool(F.avg_pool2d, x, k, s)


def replication_pad2d(x, pad):
    """pad = (left, right, top, bottom), PyTorch ReplicationPad2d order.  On
    partitioned frames the padded extent is a derived extent of the frame,
    whose tile i reads x at clamp(j - left) (clamp(j - top)) for the
    positions j it owns."""
    part = active_partition()
    if part is None:
        return F.pad(x, tuple(pad), mode="replicate")
    left, right, top, bottom = pad
    gh, gw = part.extent(x)
    size = part.add_extent(gh + top + bottom, gw + left + right)
    y = part.clamped_take(x, (gh, gw), size, shift=(top, left))
    return y if part.h else F.pad(y, (0, 0, top, bottom), mode="replicate")


def grid_sample_bilinear(x, grid):
    """F.grid_sample semantics, mode='bilinear', padding_mode='zeros',
    align_corners=True (layers.py:312-360): each out-of-range tap adds zero.
    x (B, C, H, W); grid (B, Ho, Wo, 2) normalised to [-1, 1], [..., 0] = x.
    Coordinates and tap weights are float32 whatever x's type; the result has
    x's type.  Kernel K5 on CUDA tensors, its plain version on CPU tensors.
    On partitioned frames the grid (n, ho, wo, 2) is tiled over its dims 1
    and 2 (a level or derived extent of the frame, normalised to the whole
    x): x's level comes whole (``Partition.gather``) and the tiles of a
    sample are sampled side by side along Ho in one call."""
    part = active_partition()
    if part is None:
        return gather_kernel.grid_sample(x, grid)
    part.extent(grid, dims=(1, 2))  # a tile of the frame, or raise
    src = part.gather(x)
    n, ho, wo, _ = grid.shape
    S = src.shape[0]
    T = n // S
    g = grid.reshape(T, S, ho, wo, 2).transpose(0, 1).reshape(S, T * ho, wo, 2)
    out = gather_kernel.grid_sample(src, g)
    return out.view(S, -1, T, ho, wo).permute(2, 0, 1, 3, 4).reshape(n, -1, ho, wo)


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


def _moments(x32, mask, n_local, group):
    """The batch mean and biased variance per channel of x32 (over the
    pixels ``mask`` keeps, or all), summed over every rank of ``group``
    where one is given (a per-channel sum, then a centred sum of squares,
    each all-reduced, differentiably), and the whole batch's count."""
    from memcnet_tpu_torch.parallel.ring import all_reduce_sum

    xm = x32 if mask is None else x32 * mask
    sums = torch.cat([xm.sum(dim=(0, 2, 3)), x32.new_tensor([n_local])])
    if group is not None:
        sums = all_reduce_sum(sums, group)
    n = float(sums.detach()[-1])
    mean = sums[:-1] / n
    d2 = (x32 - mean.view(1, -1, 1, 1)).square()
    sq = (d2 if mask is None else d2 * mask).sum(dim=(0, 2, 3))
    if group is not None:
        sq = all_reduce_sum(sq, group)
    return mean, sq / n, int(n)


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
    unbiased count is the whole batch's.  On partitioned frames the
    statistics are over the pixels the tiles own (the stacked tiles'
    padding masked), over every rank of the mesh where the tiles live
    across ranks."""
    x32 = x.float()
    part = active_partition()
    group = _context().active_data_group()
    if part is not None:
        mean, var, n = _moments(x32, part.mask(x), part.count(x),
                                part.mesh.group if part.across else group)
    elif group is not None:
        mean, var, n = _moments(x32, None, x.shape[0] * x.shape[2] * x.shape[3], group)
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
