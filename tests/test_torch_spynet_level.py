"""CPU parity of SPyNet's level input (kernel K5's fused entry, through its
plain version) with the JAX package's level steps: the x2 upsample times 2,
the edge pad of an odd level, the backward warp and the concat
(memcnet_tpu/models/spynet.py:152-156).

Inputs come from numpy with a seed; everything is float32.  Tolerances:
  * ATOL 1e-5: the same float32 arithmetic in another order (the grid, 4-tap
    sums of values in [0, 1));
  * the upsampled flow within max(ATOL, UP_RTOL * max |up|): the JAX package
    upsamples by two float32 matmuls with weights made in float64, PyTorch
    with float32 weights, so at 120 px they differ by a few float32 ulps
    (4.6e-5 seen, 6 ulps of 120);
  * gradients GATOL 1e-4: sums of up to four cotangents per source pixel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from memcnet_tpu.models import spynet as jspynet
from memcnet_tpu.nn import layers as JL

from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.models import spynet
from memcnet_tpu_torch.nn import layers as TL
from memcnet_tpu_torch.ops.cuda import _lib, gather_kernel

ATOL = 1e-5
UP_RTOL = 1e-6
GATOL = 1e-4
# (H, W) of a level: even, and odd in both directions (the pad fires twice)
SIZES = [(24, 40), (25, 37)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@jax.jit
def jax_level(fst, snd, flow):
    """The JAX package's level steps (spynet.py:152-156)."""
    up = JL.upsample_bilinear(flow, 2) * 2.0
    if up.shape[2] != fst.shape[2]:
        up = jnp.pad(up, ((0, 0), (0, 0), (0, 1), (0, 0)), mode="edge")
    if up.shape[3] != fst.shape[3]:
        up = jnp.pad(up, ((0, 0), (0, 0), (0, 0), (0, 1)), mode="edge")
    return jnp.concatenate([fst, jspynet._backward_warp(snd, up), up], axis=1)


def level_inputs(rng, H, W, scale, B=2):
    """fst, snd (B, 3, H, W) in [0, 1) and a coarse flow (B, 2, H // 2, W // 2)
    of up to ``scale`` px: a smooth field plus noise."""
    fst = rng.rand(B, 3, H, W).astype(np.float32)
    snd = rng.rand(B, 3, H, W).astype(np.float32)
    h, w = H // 2, W // 2
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    smooth = np.stack([np.sin(2 * np.pi * ys / h + 0.3) * np.cos(2 * np.pi * xs / w),
                       np.cos(2 * np.pi * xs / w + 1.1)])
    flow = scale * (0.8 * smooth[None] + 0.2 * rng.uniform(-1, 1, (B, 2, h, w)))
    return fst, snd, flow.astype(np.float32)


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("scale", [0.0, 2.0, 60.0])
def test_level_input_matches_jax_steps(rng, H, W, scale):
    """fst exact; up against the JAX upsample; the warp against the JAX warp
    of the port's own up (so an ulp of up does not move the taps); and, with
    flows of a few px, all 8 channels against the JAX level at ATOL."""
    fst, snd, flow = level_inputs(rng, H, W, scale)
    want = np.asarray(jax_level(*(jnp.asarray(a) for a in (fst, snd, flow))))
    got = gather_kernel.level_input(t(fst), t(snd), t(flow)).numpy()
    assert got.shape == (2, 8, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :3], fst)
    up = got[:, 6:8]
    np.testing.assert_allclose(up, want[:, 6:8], rtol=0,
                               atol=max(ATOL, UP_RTOL * float(np.abs(want[:, 6:8]).max())))
    warped = np.asarray(jax.jit(jspynet._backward_warp)(jnp.asarray(snd), jnp.asarray(up)))
    np.testing.assert_allclose(got[:, 3:6], warped, rtol=0, atol=ATOL)
    if scale <= 2.0:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("H,W", SIZES)
def test_level_input_grads_match_jax_vjp(rng, H, W):
    fst, snd, flow = level_inputs(rng, H, W, 2.0, B=1)
    ct = rng.randn(1, 8, H, W).astype(np.float32)
    want = jax.jit(lambda *a: jax.vjp(jax_level, *a[:3])[1](a[3]))(
        *(jnp.asarray(a) for a in (fst, snd, flow, ct)))
    ins = [t(a).requires_grad_(True) for a in (fst, snd, flow)]
    gather_kernel.level_input(*ins).backward(t(ct))
    for a, w in zip(ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=0, atol=GATOL)


def test_level_input_kernel_backward_is_autograd_of_plain_version(rng):
    """The helper the CUDA path's backward runs equals autograd of the plain
    composition, for fst, snd and flow."""
    ins = [t(a) for a in level_inputs(rng, 25, 37, 3.0)]
    ct = t(rng.randn(2, 8, 25, 37).astype(np.float32))
    got = _lib.reference_grads(gather_kernel.level_input_reference, ins, [True] * 3, [ct])
    xs = [a.clone().requires_grad_(True) for a in ins]
    want = torch.autograd.grad(gather_kernel.level_input_reference(*xs), xs, ct)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


@pytest.mark.parametrize("H,W", SIZES)
def test_level_input_is_the_separate_level_steps(rng, H, W):
    """The plain version is the composition SPyNet ran as separate layers
    (upsample_bilinear, * 2.0, replication_pad2d, _backward_warp, cat), bit
    for bit, in float32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        fst, snd, flow = (t(a).to(dt) for a in level_inputs(rng, H, W, 5.0))
        up = TL.upsample_bilinear(flow, 2) * 2.0
        up = TL.replication_pad2d(up, (0, W - up.shape[3], 0, H - up.shape[2]))
        want = torch.cat([fst, spynet._backward_warp(snd, up), up], dim=1)
        got = gather_kernel.level_input(fst, snd, flow)
        assert got.dtype == dt
        assert torch.equal(got, want)


def test_launch_level_input_refuses_what_the_kernel_does_not_take():
    """Shapes and types are checked before anything is launched."""
    fst = torch.zeros(2, 3, 24, 40)
    with pytest.raises(ValueError, match="flow"):
        gather_kernel.launch_level_input(fst, fst, torch.zeros(2, 2, 12, 21))
    with pytest.raises(ValueError, match="flow"):
        gather_kernel.launch_level_input(fst, fst, torch.zeros(1, 2, 12, 20))
    with pytest.raises(ValueError, match="snd"):
        gather_kernel.launch_level_input(fst, torch.zeros(2, 3, 24, 41), torch.zeros(2, 2, 12, 20))
    with pytest.raises(TypeError, match="one type"):
        gather_kernel.launch_level_input(fst, fst, torch.zeros(2, 2, 12, 20, dtype=torch.bfloat16))


def test_spynet_forward_residual_adds_the_upsampled_flow(rng):
    """SPyNet's level residual is added to the level input's up channels:
    a level whose convs predict zero passes the upsampled flow on, so with
    the last conv of every level zeroed but the first level's bias the
    flow is that bias, doubled at each of the two later levels."""
    net = spynet.SPyNet()
    flat = {k: np.zeros(tuple(v.shape), np.float32)
            for k, v in torch.nn.ModuleDict({"flownets": net}).state_dict().items()}
    flat["flownets.moduleBasic.0.moduleBasic.8.bias"] = np.array([0.5, -0.25], np.float32)
    load_jax_params(torch.nn.ModuleDict({"flownets": net}), flat)
    x = t(rng.rand(1, 3, 128, 128).astype(np.float32))
    with torch.no_grad():
        flow = net(x, x)
    assert flow.shape == (1, 2, 128, 128)
    # the upsample's weights sum to 1 within a float32 rounding
    np.testing.assert_allclose(flow[0, 0].numpy(), 2.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(flow[0, 1].numpy(), -1.0, rtol=0, atol=1e-6)
