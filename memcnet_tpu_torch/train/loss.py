"""Training losses (port of memcnet_tpu/train/loss.py).

The reference's train-mode forwards return residual lists to be penalised
(MEMC_Net.py:132-137: [interp - gt, rectified - gt]), and my_args.py:41-59
documents the upstream trainer's Charbonnier epsilon (1e-6) and per-residual
weights alpha ([1.0, 0.0]).  Penalties are float32 means whatever the
residuals' type.

On partitioned frames (``parallel.partition``) a mean is over the whole
frame: the sum over the pixels the tiles own (the stacked tiles' padding
masked), all-reduced over the tile lines where the tiles live across ranks,
divided by the frame's count.  Every rank of a tile line then holds its
data slice's loss, and the all-reduce's backward scales each rank's
gradient by the line's size, so that DDP's average over every rank of the
mesh (``parallel.step``) is the whole batch's gradient.
"""

import torch

from memcnet_tpu_torch.nn.layers import active_partition


def _mean(v):
    """The mean of elementwise penalties v (float32)."""
    part = active_partition()
    if part is None:
        return v.mean()
    from memcnet_tpu_torch.parallel.ring import all_reduce_sum

    mask = part.mask(v)
    total = (v if mask is None else v * mask).sum()
    for group in part.tile_groups():
        total = all_reduce_sum(total, group)
    gh, gw = part.level(v)
    return total / (part.samples(v.shape[0]) * v.shape[1] * gh * gw)


def charbonnier(x, eps=1e-6):
    """Mean Charbonnier penalty sqrt(x^2 + eps^2) (my_args.py:56 epsilon)."""
    return _mean(torch.sqrt(x.float() ** 2 + eps * eps))


def l1(x):
    return _mean(x.float().abs())


def residual_loss(residuals, alpha=None, eps=1e-6):
    """Weighted sum of Charbonnier penalties over residual tensors.  alpha
    defaults to uniform 1.0 (the reference's [1.0, 0.0] trains the
    pre-rectification output only; pass it to reproduce that)."""
    if alpha is None:
        alpha = [1.0] * len(residuals)
    if len(alpha) != len(residuals):
        raise ValueError(f"{len(alpha)} weights for {len(residuals)} residuals")
    total = 0.0
    for a, r in zip(alpha, residuals):
        total = total + a * charbonnier(r, eps)
    return total
