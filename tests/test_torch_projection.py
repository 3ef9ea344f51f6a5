"""CPU parity of the port's fused flow projection (K2 scatter, folds and
divide; K3 fill; csrc/project.cu) with the JAX package.

On the CPU the kernels cannot run, so these tests hold the plain versions
the card is checked against -- the gather form of the border folds
(``project_kernel.fold``, the arithmetic of project_fold_kernel), the K2 and
K3 stage versions and the has-value bit masks -- against the JAX package's
``_scatter4``, ``_directional_fill_xla`` and ``_global_flow_project``, with
flows that land exactly on x = W-1 and y = H-1, on 0, at -0.5 and out of the
frame, at H or W = 1 (where the folds double the sums) and at widths that are
not multiples of 32.  Inputs are made with numpy from a seed.  Tolerances:
counts exact (sums of 1.0); float32 within 1e-5 (the same arithmetic, summed
in another order by the scatter).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from memcnet_tpu.ops import projection as JP

from memcnet_tpu_torch.ops import cuda as K
from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops.cuda import project_kernel as P

ATOL = 1e-5
SHAPES = [(1, 7), (7, 1), (5, 33), (12, 40)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def edge_flow(rng, B, H, W, amp=2.0):
    """Random flow of about ``amp`` px with pixels that land exactly on
    x = W-1, on y = H-1, on both, on x = 0, at x = -0.5 (invalid) and out of
    the frame."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    f = (rng.randn(B, 2, H, W) * amp).astype(np.float32)
    for b in range(B):
        k = rng.randint(0, 8, size=(H, W))
        f[b, 0] = np.where((k == 1) | (k == 3), (W - 1) - xs, f[b, 0])
        f[b, 1] = np.where((k == 2) | (k == 3), (H - 1) - ys, f[b, 1])
        f[b, 0] = np.where(k == 4, -xs, f[b, 0])
        f[b, 0] = np.where(k == 5, -0.5 - xs, f[b, 0])
        f[b, 0] = np.where(k == 6, 3.0 * W, f[b, 0])
    return f


def jax_sums(flow):
    H, W = flow.shape[2:]
    f = jnp.asarray(flow)
    valid, ixL, ixR, iyT, iyB = JP._landing_cells(f)
    out, cnt = JP._scatter4(-f, jnp.ones(f[:, 0].shape), valid, ixL, ixR, iyT, iyB, H, W)
    return np.asarray(out), np.asarray(cnt)


def fused_plain(flow, fillhole):
    """The plain versions of the card's stages, chained as flow_project
    chains the kernels."""
    if fillhole:
        _, avg, masks = P.sums_stage_reference(flow, True)
        return P.fill_stage_reference(avg, masks, flow.dtype)
    return P.sums_stage_reference(flow, False)[1]


@pytest.mark.parametrize("H,W", SHAPES)
def test_gather_fold_matches_jax_scatter4(rng, H, W):
    flow = edge_flow(rng, 2, H, W)
    want, want_cnt = jax_sums(flow)
    out = P.fold(P.base_sums(t(flow)))
    np.testing.assert_array_equal(out[:, 2].numpy(), want_cnt)
    np.testing.assert_allclose(out[:, :2].numpy(), want, rtol=0, atol=ATOL)
    assert (want_cnt > 0).any()


@pytest.mark.parametrize("fillhole", [True, False])
@pytest.mark.parametrize("H,W", SHAPES)
def test_fused_plain_matches_jax_flow_project(rng, H, W, fillhole):
    flow = edge_flow(rng, 2, H, W)
    want = np.asarray(JP._global_flow_project(jnp.asarray(flow), fillhole=fillhole))
    got = fused_plain(t(flow), fillhole)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(TP.flow_project(t(flow), fillhole=fillhole).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("fillhole", [True, False])
def test_bf16_flow_takes_float32_coordinates(rng, fillhole):
    """A bf16 flow is projected from float32 coordinates: the result is the
    JAX float32 projection of the same (bf16-valued) flow, rounded once.  At
    W = 300 a bf16 pixel grid would put landings above x = 256 in other
    cells."""
    flow = torch.from_numpy(edge_flow(rng, 2, 6, 300, amp=3.0)).to(torch.bfloat16)
    f32 = flow.float().numpy()
    want = np.asarray(JP._global_flow_project(jnp.asarray(f32), fillhole=fillhole))
    avg, cnt = TP.project(flow, fillhole=fillhole)
    np.testing.assert_array_equal(cnt.numpy(), jax_sums(f32)[1])
    np.testing.assert_allclose(avg.numpy(), want, rtol=0, atol=ATOL)
    got = fused_plain(flow, fillhole)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, avg.to(torch.bfloat16))
    assert torch.equal(TP.flow_project(flow, fillhole=fillhole), got)


@pytest.mark.parametrize("fillhole", [True, False])
def test_all_invalid_landings_give_zero(fillhole):
    B, H, W = 2, 37, 45
    flow = np.full((B, 2, H, W), 5.0 * W, np.float32)
    flow[:, 1, ::2] = -0.5 - H  # some above the frame instead
    flow[0, 0, 3, 4] = np.nan   # NaN lands nowhere
    got = fused_plain(t(flow), fillhole)
    assert not got.isnan().any()
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP._global_flow_project(jnp.asarray(flow), fillhole=fillhole)))
    _, _, masks = P.sums_stage_reference(t(flow), True)
    assert all(int(m.abs().sum()) == 0 for m in masks)


@pytest.mark.parametrize("fillhole", [True, False])
def test_single_valid_pixel(fillhole):
    """One landing at (y, x) = (2.6, 5.3) feeds cells (2..3, 5..6); with the
    fill their rows fill left and right, and the rows below them only in
    columns 5 and 6 (the up-search finds them from below)."""
    B, H, W = 1, 9, 70
    flow = np.full((B, 2, H, W), 5.0 * W, np.float32)
    flow[0, :, 2, 5] = (0.3, 0.6)
    want = np.asarray(JP._global_flow_project(jnp.asarray(flow), fillhole=fillhole))
    got = fused_plain(t(flow), fillhole).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _, _, cnt = P.sums_and_average(t(flow))
    assert int((cnt > 0).sum()) == 4
    if fillhole:
        nonzero = got[0, 0] != 0
        assert nonzero[2:4].all() and not nonzero[:2].any()
        assert nonzero[4:, 5:7].all() and int(nonzero[4:].sum()) == 2 * (H - 4)
    else:
        assert int((got[0, 0] != 0).sum()) == 4


@pytest.mark.parametrize("W", [1, 31, 33, 64, 97])
def test_mask_bits_round_trip(rng, W):
    has = t(rng.rand(2, 5, W) < 0.3)
    has[0, 1] = True  # a full line: bit 31 set, a negative int32 word
    words = P.pack_bits(has)
    assert words.dtype == torch.int32 and words.shape == (2, 5, (W + 31) // 32)
    assert torch.equal(P.unpack_bits(words, W), has)
    masks = P.pack_masks(has)
    assert tuple(tuple(m.shape) for m in masks) == P.mask_shapes(2, 5, W)
    assert torch.equal(P.unpack_bits(masks.cols, 5), has.transpose(1, 2))
    assert torch.equal(P.unpack_bits(masks.row_sums, words.shape[2]), words != 0)
    assert torch.equal(P.unpack_bits(masks.col_sums, masks.cols.shape[2]),
                       masks.cols != 0)


@pytest.mark.parametrize("density", [0.15, 0.0])
def test_fill_stage_matches_jax_fill(rng, density):
    """K3's plain version reads the masks K2 packs: the same fill as the
    count-based one and the JAX XLA scans."""
    B, H, W = 2, 24, 70
    cnt = (rng.rand(B, H, W) < density).astype(np.float32) * (1.0 + rng.rand(B, H, W))
    avg = (rng.randn(B, 2, H, W) * (cnt > 0)[:, None]).astype(np.float32)
    cnt = cnt.astype(np.float32)
    got = P.fill_stage_reference(t(avg), P.pack_masks(t(cnt) > 0), torch.float32)
    np.testing.assert_array_equal(got.numpy(), P.fill_reference(t(avg), t(cnt)).numpy())
    want = np.asarray(JP._directional_fill_xla(jnp.asarray(avg), jnp.asarray(cnt), False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_plain_path_launches_nothing(rng):
    K.reset_counters()
    TP.flow_project(t(edge_flow(rng, 1, 8, 40)), fillhole=True)
    assert set(K.launch_counts().values()) == {0}


@pytest.mark.parametrize("fillhole", [False, True])
def test_bf16_counts_past_256_are_exact(rng, fillhole):
    """A bf16 flow whose 24 x 40 pixels all land on one cell (and two
    clamped border cells): the counts are float32 sums, exact past 256
    (a bf16 sum of ones stops at 256, as the JAX XLA branch's counter,
    memcnet_tpu/ops/projection.py:80-81, does), and the bf16 projection is
    the float32 one rounded once, within 1 bf16 ulp.  The train path runs
    this op on bf16 flows."""
    B, H, W = 1, 24, 40
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    flow = np.stack([20.0 - xs, 10.0 - ys])[None] + 0.25  # land on (10.25, 20.25)
    flow[0, :, :, :3] = np.stack([W - 1 - xs, H - 1 - ys])[:, :, :3]  # the corner
    bf = t(flow.astype(np.float32)).bfloat16()
    S, avg, cnt = P.sums_and_average(bf)
    assert S.dtype == torch.float32
    assert float(S[0, 2, 10, 20]) == H * (W - 3) and float(S[0, 2, H - 1, W - 1]) == H * 3
    assert float(cnt[0, 10, 20]) == float(cnt[0, 11, 21]) == H * (W - 3)
    assert float(cnt[0, H - 1, W - 1]) == 4 * H * 3  # clamped: all four land on the corner
    f = jnp.asarray(flow.astype(np.float32), jnp.bfloat16)
    valid, ixL, ixR, iyT, iyB = JP._landing_cells(f)
    _, jcnt = JP._scatter4(-f, jnp.ones_like(f[:, 0]), valid, ixL, ixR, iyT, iyB, H, W)
    assert float(jcnt[0, 10, 20]) == 256.0  # the JAX bf16 count saturates
    got = TP.flow_project(bf, fillhole=fillhole)
    want = TP.flow_project(bf.float(), fillhole=fillhole)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.bfloat16().float().numpy())
