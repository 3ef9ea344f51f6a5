"""CPU parity of the port's SPyNet path with the JAX package: the grid sample
(kernel K5's plain version), SPyNet's 7x7 convs (kernel K4's plain version),
the pooling and padding layers and the SPyNet forward.

Inputs and weights are made with numpy from a seed and handed to both
packages; everything is float32.  The JAX side runs its XLA formulation or
its Pallas kernel in interpret mode.  Tolerances:
  * ATOL 1e-5: the same float32 arithmetic in another order (4-tap sums, a
    7x7 conv of up to 64 channels of values of order 1);
  * gradients GATOL 1e-4: sums of up to four cotangents per source pixel;
  * the SPyNet forward FLOW_TOL 1e-4 relative to the flow's scale (15 convs
    of 7x7 over three levels).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from memcnet_tpu.models import spynet as jspynet
from memcnet_tpu.nn import layers as JL
from memcnet_tpu.ops.pallas import conv_kernel as jck

from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.models import spynet
from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn import layers as TL
from memcnet_tpu_torch.ops.cuda import _lib, conv_kernel, gather_kernel

ATOL = 1e-5
GATOL = 1e-4
FLOW_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_grid(rng, B, Ho, Wo, H, W, scale):
    """A normalised (B, Ho, Wo, 2) grid: the identity of an (Ho, Wo) frame
    plus a random flow of ``scale`` pixels of an (H, W) source."""
    gy, gx = np.meshgrid(np.linspace(-1, 1, Ho), np.linspace(-1, 1, Wo), indexing="ij")
    base = np.stack([gx, gy], -1)[None].repeat(B, 0)
    fl = rng.randn(B, Ho, Wo, 2) * scale
    fl[..., 0] /= (W - 1) / 2
    fl[..., 1] /= (H - 1) / 2
    return (base + fl).astype(np.float32)


# -- grid sample (K5) ---------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 2.0, 8.0, 60.0])
def test_grid_sample_matches_jax(rng, scale):
    B, C, H, W = 2, 3, 24, 40
    x = rng.rand(B, C, H, W).astype(np.float32)
    g = make_grid(rng, B, H, W, H, W, scale)
    want = np.asarray(JL._grid_sample_xla(jnp.asarray(x), jnp.asarray(g)))
    got = TL.grid_sample_bilinear(t(x), t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale", [2.0, 60.0])
def test_grid_sample_matches_pallas_interpret(rng, scale):
    """Against gather_bands in interpret mode, through _grid_sample_fast
    (test_grid_sample_fast.py runs it the same way)."""
    B, C, H, W = 2, 3, 24, 40
    x = rng.rand(B, C, H, W).astype(np.float32)
    g = make_grid(rng, B, H, W, H, W, scale)
    want = np.asarray(JL._grid_sample_fast(jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = gather_kernel.grid_sample(t(x), t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_grid_sample_mismatched_grid(rng):
    """K5 takes any (B, Ho, Wo, 2) grid; JAX keeps such grids on XLA."""
    B, C, H, W = 1, 5, 16, 24
    x = rng.randn(B, C, H, W).astype(np.float32)
    g = make_grid(rng, B, 9, 13, H, W, 1.5)
    want = np.asarray(JL.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(g)))
    got = TL.grid_sample_bilinear(t(x), t(g))
    assert got.shape == (B, C, 9, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_grid_sample_grads_match_jax_vjp(rng):
    B, C, H, W = 1, 3, 16, 24
    x = rng.rand(B, C, H, W).astype(np.float32)
    g = make_grid(rng, B, H, W, H, W, 2.5)
    ct = rng.randn(B, C, H, W).astype(np.float32)
    _, vjp = jax.vjp(JL._grid_sample_xla, jnp.asarray(x), jnp.asarray(g))
    want = vjp(jnp.asarray(ct))
    ins = [t(a).requires_grad_(True) for a in (x, g)]
    TL.grid_sample_bilinear(*ins).backward(t(ct))
    for a, w in zip(ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=0, atol=GATOL)


def test_grid_sample_kernel_backward_is_autograd_of_plain_version(rng):
    """The helper the CUDA path's backward runs equals autograd of the plain
    version, for x and grid."""
    x = t(rng.rand(2, 3, 10, 14).astype(np.float32))
    g = t(make_grid(rng, 2, 10, 14, 10, 14, 2.0))
    ct = t(rng.randn(2, 3, 10, 14).astype(np.float32))
    got = _lib.reference_grads(gather_kernel.reference, [x, g], [True, True], [ct])
    xs = [a.clone().requires_grad_(True) for a in (x, g)]
    want = torch.autograd.grad(gather_kernel.reference(*xs), xs, ct)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_grid_sample_bf16_rounds_once(rng):
    """bf16 in, float32 weights and sums, one rounding out."""
    x = t(rng.rand(1, 3, 12, 20).astype(np.float32)).to(torch.bfloat16)
    g = t(make_grid(rng, 1, 12, 20, 12, 20, 3.0))
    got = TL.grid_sample_bilinear(x, g)
    assert got.dtype == torch.bfloat16
    want = gather_kernel.reference(x.float(), g).to(torch.bfloat16)
    assert torch.equal(got, want)


# -- layers and init ------------------------------------------------------------


@pytest.mark.parametrize("H,W", [(24, 40), (37, 25)])
def test_avg_pool_and_replication_pad_match_jax(rng, H, W):
    x = rng.randn(2, 3, H, W).astype(np.float32)
    np.testing.assert_allclose(TL.avg_pool2d(t(x), 2).numpy(),
                               np.asarray(JL.avg_pool2d(jnp.asarray(x), 2)), rtol=0, atol=ATOL)
    pad = (0, 1, 2, 1)
    np.testing.assert_array_equal(TL.replication_pad2d(t(x), pad).numpy(),
                                  np.asarray(JL.replication_pad2d(jnp.asarray(x), pad)))


def test_torch_default_uniform_is_seeded_and_bounded():
    w = I.torch_default_uniform((32, 64, 7, 7), torch.Generator().manual_seed(4))
    bound = 1.0 / np.sqrt(64 * 49)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert torch.equal(w, I.torch_default_uniform((32, 64, 7, 7), torch.Generator().manual_seed(4)))
    b = I.torch_default_uniform((32,), torch.Generator().manual_seed(4), fan_in=64 * 49)
    assert float(b.abs().max()) <= bound


# -- SPyNet's convs (K4) --------------------------------------------------------


def test_spynet_conv_matches_pallas_interpret_and_xla(rng):
    """SPyNet's 64 -> 32 7x7 conv with bias and ReLU: the shape that needs
    K4's channel tiling."""
    x = rng.randn(2, 64, 16, 24).astype(np.float32)
    w = (rng.randn(32, 64, 7, 7) / np.sqrt(64 * 49)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, 32).astype(np.float32)
    got = conv_kernel.conv2d_small(t(x), t(w), t(b), relu=True).numpy()
    want = np.asarray(jck.conv2d_small(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       relu=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    xla = np.maximum(np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          stride=1, padding=3)), 0)
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)


# -- SPyNet -------------------------------------------------------------------------


def spynet_params(seed, last_scale=1.0):
    """numpy weights for SPyNet: the torch-0.2 default bounds; the last conv
    of each level scaled by ``last_scale``."""
    rng = np.random.RandomState(seed)
    flat = {}
    for lvl in range(6):
        for j, (cin, cout) in enumerate(spynet.BASIC):
            name = f"flownets.moduleBasic.{lvl}.moduleBasic.{2 * j}"
            bound = 1.0 / np.sqrt(cin * 49)
            scale = last_scale if j == len(spynet.BASIC) - 1 else 1.0
            flat[name + ".weight"] = (rng.uniform(-bound, bound, (cout, cin, 7, 7))
                                      * scale).astype(np.float32)
            flat[name + ".bias"] = (rng.uniform(-bound, bound, cout) * scale).astype(np.float32)
    return flat


@pytest.mark.parametrize("H,W", [(128, 128), (74, 100)])
def test_spynet_forward_matches_jax(rng, H, W):
    """128x128: three pyramid levels.  74x100: levels 18x25, 37x50, 74x100,
    so the replicate pad fires on the width at the first level and on the
    height at the second.  The last convs are scaled up so that the flows
    reach a few pixels (every step is continuous in the flow)."""
    flat = spynet_params(21, last_scale=10.0)
    net = spynet.SPyNet()
    load_jax_params(torch.nn.ModuleDict({"flownets": net}), flat)
    first = rng.rand(2, 3, H, W).astype(np.float32)
    second = np.roll(first, (1, 2), axis=(2, 3)) * 0.9 + 0.05
    want = np.asarray(jax.jit(jspynet.forward)({k: jnp.asarray(v) for k, v in flat.items()},
                                               jnp.asarray(first), jnp.asarray(second)))
    with torch.no_grad():
        got = net(t(first), t(second)).numpy()
    assert got.shape == (2, 2, H, W)
    assert float(np.abs(want).max()) > 1.0  # the flows are not trivial
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOW_TOL * max(1.0, float(np.abs(want).max())))


def test_spynet_keys_match_jax():
    shapes = {k: v.shape for k, v in jax.eval_shape(
        jspynet.init_params, jax.random.PRNGKey(0)).items()}
    net = torch.nn.ModuleDict({"flownets": spynet.SPyNet()})
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {k: tuple(v) for k, v in shapes.items()}
