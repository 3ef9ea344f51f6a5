"""Training losses (port of memcnet_tpu/train/loss.py).

The reference's train-mode forwards return residual lists to be penalised
(MEMC_Net.py:132-137: [interp - gt, rectified - gt]), and my_args.py:41-59
documents the upstream trainer's Charbonnier epsilon (1e-6) and per-residual
weights alpha ([1.0, 0.0]).  Penalties are float32 means whatever the
residuals' type.
"""

import torch


def charbonnier(x, eps=1e-6):
    """Mean Charbonnier penalty sqrt(x^2 + eps^2) (my_args.py:56 epsilon)."""
    return torch.sqrt(x.float() ** 2 + eps * eps).mean()


def l1(x):
    return x.float().abs().mean()


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
