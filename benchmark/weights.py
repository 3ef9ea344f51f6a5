"""Seeded weights by the init rules of a configuration file.

A configuration's ``init`` lists rules ``{"match": regex, "init": kind}``
(optionally ``"dim"``, the tensor's rank, ``"scale"`` and ``"fan_in_of"``);
each state-dict entry takes the first rule whose regex matches its whole
name.  The kinds are the reference implementation's init rules (the
program's ``nn/init.py`` follows the same rules, from its own generator):

  xavier_uniform   U(-b, b), b = sqrt(6 / (fan_in + fan_out))
  kaiming_uniform  U(-b, b), b = sqrt(6 / fan_in)
  uniform_fan_in   U(-b, b), b = 1 / sqrt(fan_in); a bias takes the fan_in
                   of the weight named by ``fan_in_of`` in place of "bias"
  normal_over_n    N(0, scale / n), n = kh * kw * out channels (OIHW)
  normal_over_n_iohw  the same for a transposed conv's IOHW weight
  msra             N(0, sqrt(2 / n)), n = kh * kw * out channels
  zeros, ones

The uniform draws of all tensors come from one ``torch.rand`` call and the
normal draws from one ``torch.randn`` call of a generator seeded with the
run's seed, on the run's device, in float32.
"""

import math
import re

import torch


def _fans(shape):
    o, i, kh, kw = shape
    return i * kh * kw, o * kh * kw


def _rule(rules, name, t):
    for r in rules:
        if re.fullmatch(r["match"], name) and r.get("dim", t.dim()) == t.dim():
            return r
    raise KeyError(f"no init rule matches {name} {tuple(t.shape)}")


def _draw(rule, name, shape, template):
    """(kind of draw, bound or std) of one tensor."""
    kind = rule["init"]
    if kind == "xavier_uniform":
        fi, fo = _fans(shape)
        return "uniform", math.sqrt(6.0 / (fi + fo))
    if kind == "kaiming_uniform":
        return "uniform", math.sqrt(6.0 / _fans(shape)[0])
    if kind == "uniform_fan_in":
        of = rule.get("fan_in_of")
        wshape = tuple(template[name.replace("bias", of)].shape) if of else shape
        return "uniform", 1.0 / math.sqrt(_fans(wshape)[0])
    if kind == "normal_over_n":
        return "normal", rule["scale"] / (shape[2] * shape[3] * shape[0])
    if kind == "normal_over_n_iohw":
        return "normal", rule["scale"] / (shape[2] * shape[3] * shape[1])
    if kind == "msra":
        return "normal", math.sqrt(2.0 / (shape[2] * shape[3] * shape[0]))
    if kind in ("zeros", "ones"):
        return kind, None
    raise ValueError(f"unknown init kind {kind!r} for {name}")


def make(template, rules, seed, device):
    """A float32 state dict on ``device`` with the names and shapes of
    ``template`` (a module's state dict), drawn from ``seed`` by ``rules``.
    Integer entries (BatchNorm's batch counts) are zeros of their type."""
    plan, draws = [], {"uniform": [], "normal": []}
    for name, t in template.items():
        if not t.is_floating_point():
            plan.append((name, "int", t))
            continue
        kind, arg = _draw(_rule(rules, name, t), name, tuple(t.shape), template)
        plan.append((name, kind, t))
        if kind in draws:
            draws[kind].append((t.numel(), arg))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {}
    for kind, items in draws.items():
        if not items:
            continue
        counts = torch.tensor([n for n, _ in items], device=device)
        scale = torch.repeat_interleave(
            torch.tensor([a for _, a in items], dtype=torch.float32, device=device), counts)
        n = int(counts.sum())
        if kind == "uniform":
            pools[kind] = iter((torch.rand(n, generator=gen, device=device) * 2.0 - 1.0)
                               .mul_(scale).split([c for c, _ in items]))
        else:
            pools[kind] = iter(torch.randn(n, generator=gen, device=device).mul_(scale)
                               .split([c for c, _ in items]))
    out = {}
    for name, kind, t in plan:
        if kind == "int":
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(t.shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(t.shape, device=device)
        else:
            out[name] = next(pools[kind]).view(t.shape)
    return out
