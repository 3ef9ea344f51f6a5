"""K4's weight repacking for its bf16 tensor-core kernel, on the CPU.

``conv_kernel.pack_weights`` lays a conv's weights out in the order the
kernel's GEMM consumes them: for each output-channel group, channel chunk,
kernel row ky and 16-deep step g, a 16-wide slice k = t * CG + c (tap
kx = g * TPS + t, channel c of the chunk) per output channel, with the
channels, taps and output channels padded.  Here an im2col product over the
packed weights, step by step in the kernel's order, is held against the
plain version (``conv_kernel.reference``) and against the JAX package's
``conv2d_small`` run in interpret mode.  Everything is float32; ATOL 1e-5 is
the same float32 arithmetic summed in another order (up to 64 * 49 terms of
order 1e-2).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from memcnet_tpu.ops.pallas import conv_kernel as jck

from memcnet_tpu_torch.ops.cuda import conv_kernel

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def igemm_product(x, packed, O, K, b=None, relu=False):
    """The bf16 kernel's sum, in float32: for every (group, chunk, ky, g)
    step, the 16-deep im2col slice of each pixel times the packed weights."""
    B, C, H, W = x.shape
    p = conv_kernel.pack_geometry(C, O, K)
    CG, TPS, G, nch, NT, ng = (p[k] for k in ("CG", "TPS", "G", "nchunks", "NT", "n_groups"))
    assert packed.shape == (ng, nch, K, G, NT, 16)
    P = K // 2
    # zero ring of K // 2, channels padded to the chunks, and the taps of the
    # last step that pass K read columns past the halo (zero weights there)
    xp = F.pad(x, (P, P + G * TPS - K, P, P, 0, nch * CG - C))
    out = torch.zeros(B, ng * NT, H, W)
    for og in range(ng):
        for c in range(nch):
            for ky in range(K):
                for g in range(G):
                    a = torch.cat([xp[:, c * CG:(c + 1) * CG, ky:ky + H,
                                      g * TPS + tt:g * TPS + tt + W] for tt in range(TPS)], 1)
                    out[:, og * NT:(og + 1) * NT] += torch.einsum(
                        "bkhw,nk->bnhw", a, packed[og, c, ky, g])
    out = out[:, :O]
    if b is not None:
        out = out + b[None, :, None, None]
    return out.clamp(min=0.0) if relu else out


@pytest.mark.parametrize("C,O,K", [(3, 64, 7), (8, 32, 7), (64, 32, 7), (16, 2, 7), (32, 64, 7),
                                   (6, 40, 3), (20, 24, 5), (3, 80, 3)])
def test_packed_im2col_product_matches_plain_conv(rng, C, O, K):
    """C = 3 and 6 pack 4 and 2 taps per step; C = 20 pads a second chunk;
    O = 2 and 40 pad the output channels; O = 80 takes two groups."""
    x = rng.randn(2, C, 11, 13).astype(np.float32)
    w = (rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, O).astype(np.float32)
    packed = conv_kernel.pack_weights(t(w), torch.float32)
    got = igemm_product(t(x), packed, O, K, t(b), relu=True)
    want = conv_kernel.reference(t(x), t(w), t(b), relu=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("C", [3, 8, 64])
def test_packed_im2col_product_matches_pallas_interpret(rng, C):
    """Against the Pallas conv2d_small in interpret mode: the ctx conv's C = 3,
    SPyNet's first conv's C = 8 and its 64 -> 32 conv."""
    O, K = (64, 7) if C == 3 else (32, 7)
    x = rng.randn(1, C, 12, 20).astype(np.float32)
    w = (rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, O).astype(np.float32)
    packed = conv_kernel.pack_weights(t(w), torch.float32)
    got = igemm_product(t(x), packed, O, K, t(b), relu=True).numpy()
    want = np.asarray(jck.conv2d_small(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       relu=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("C,O,K,geometry", [
    (3, 64, 7, dict(CG=4, TPS=4, G=2, nchunks=1, NT=64, n_groups=1)),
    (8, 32, 7, dict(CG=8, TPS=2, G=4, nchunks=1, NT=32, n_groups=1)),
    (64, 32, 7, dict(CG=16, TPS=1, G=7, nchunks=4, NT=32, n_groups=1)),
    (16, 2, 7, dict(CG=16, TPS=1, G=7, nchunks=1, NT=16, n_groups=1)),
    (20, 80, 5, dict(CG=16, TPS=1, G=5, nchunks=2, NT=64, n_groups=2)),
])
def test_pack_geometry(C, O, K, geometry):
    """The tiling of the served shapes: C = 3 pads its depth per kernel row
    from 21 to 32 (not to 7 * 16), C = 8 from 56 to 64."""
    assert conv_kernel.pack_geometry(C, O, K) == geometry


def test_packed_layout_places_each_weight(rng):
    """Spot-check the index map of the docstring on the C = 3 layout."""
    w = t(rng.randn(5, 3, 7, 7).astype(np.float32))
    packed = conv_kernel.pack_weights(w, torch.bfloat16)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    for o, c, ky, kx in [(0, 0, 0, 0), (4, 2, 6, 6), (3, 1, 2, 5)]:
        g, tt = divmod(kx, 4)
        assert packed[0, 0, ky, g, o, tt * 4 + c] == w[o, c, ky, kx].to(torch.bfloat16)
    # channel 3, tap kx = 7 and output channels 5..15 are padding
    assert not packed[0, 0, :, :, :, 3::4].any()
    assert not packed[0, 0, :, 1, :, 12:].any()
    assert not packed[0, 0, :, :, 5:].any()


def test_packed_weights_are_cached_until_the_tensor_changes(rng):
    w = t(rng.randn(16, 8, 3, 3).astype(np.float32))
    first = conv_kernel._prepared_weights(w, torch.bfloat16)
    assert conv_kernel._prepared_weights(w, torch.bfloat16) is first
    with torch.no_grad():
        w.mul_(2.0)
    packed, sums = conv_kernel._prepared_weights(w, torch.bfloat16)
    assert packed is not first[0]
    assert torch.equal(packed, conv_kernel.pack_weights(w, torch.bfloat16))
    assert torch.equal(sums, conv_kernel.abs_weight_sums(w, torch.bfloat16))


def test_abs_weight_sums(rng):
    """Sum of |w| per output channel in the kernel's type, zero on padding."""
    w = t(rng.randn(5, 3, 7, 7).astype(np.float32))
    sums = conv_kernel.abs_weight_sums(w, torch.bfloat16)
    assert sums.dtype == torch.float32 and sums.shape == (16,)
    want = w.to(torch.bfloat16).float().abs().sum((1, 2, 3))
    np.testing.assert_allclose(sums[:5].numpy(), want.numpy(), rtol=1e-6)
    assert not sums[5:].any()
