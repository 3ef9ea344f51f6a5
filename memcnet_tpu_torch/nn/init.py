"""Seeded weight initialisers with the distributions of memcnet_tpu/nn/init.py
(the reference's torch init rules), each drawing from an explicit
``torch.Generator``.  The numbers differ from ``jax.random``'s for the same
seed; tests that compare the two packages move weights across with
``io.params_from_jax``.

  * kaiming_uniform(a=0, mode='fan_in'): bound sqrt(3) * sqrt(2 / fan_in).
  * xavier_uniform (MEMC_Net_star convs): bound sqrt(6 / (fan_in + fan_out)).
  * flownets_normal: normal(0, 0.02 / n), n = kh*kw*out_channels (OIHW);
    flownets_normal_iohw for conv-transpose weights (IOHW).
  * resnet_msra: normal(0, sqrt(2 / n)), n = kh*kw*out_channels.
  * torch_default_uniform (SPyNet, weights and biases): the torch-0.2 Conv2d
    default, uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = I*kh*kw of the
    conv (spynet.py:28-32, :41-43).
"""

import math

import torch


def _fans(shape):
    o, i, kh, kw = shape
    rf = kh * kw
    return i * rf, o * rf


def _uniform(shape, bound, generator, dtype):
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(dtype)


def _normal(shape, std, generator, dtype):
    return (torch.randn(shape, generator=generator, dtype=torch.float32) * std).to(dtype)


def kaiming_uniform(shape, generator, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(shape, math.sqrt(3.0) * math.sqrt(2.0) / math.sqrt(fan_in), generator, dtype)


def xavier_uniform(shape, generator, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator, dtype)


def flownets_normal(shape, generator, dtype=torch.float32):
    out_ch, _i, kh, kw = shape
    return _normal(shape, 0.02 / (kh * kw * out_ch), generator, dtype)


def flownets_normal_iohw(shape, generator, dtype=torch.float32):
    _i, out_ch, kh, kw = shape
    return _normal(shape, 0.02 / (kh * kw * out_ch), generator, dtype)


def resnet_msra(shape, generator, dtype=torch.float32):
    o, _i, kh, kw = shape
    return _normal(shape, math.sqrt(2.0 / (kh * kw * o)), generator, dtype)


def torch_default_uniform(shape, generator, dtype=torch.float32, fan_in=None):
    """``fan_in`` defaults to that of an OIHW ``shape``; a bias passes its
    conv's fan_in."""
    if fan_in is None:
        fan_in, _ = _fans(shape)
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator, dtype)
