"""CPU parity of the port's op library (memcnet_tpu_torch.ops) with the JAX
package's (memcnet_tpu.ops): each of the 13 names of the JAX ``__all__``,
forward and backward, in float32.

The backward is a VJP with a random cotangent against ``jax.vjp`` of the JAX
op, so the reference's hand backwards are held too: N7's depth term
(f - avg), N9's -2 sqrt(w) and where(p1 > tgt, 1, -1), and the splats' -2x
flow gradient.  Inputs are made with numpy from a seed; flows land out of the
frame and exactly on the borders, where a clamped neighbour takes a
contribution twice.  Tolerances: 1e-5 of the output's largest magnitude
(absolute where that is below 1: the same float32 arithmetic, summed in
another order by the scatters); N7/N8 counts and gates exact; the -2000
sentinel exact.  N7 and N8 are also held against the JAX package's Pallas
path in interpret mode, at a shape whose rows are a multiple of its band.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import memcnet_tpu.ops as J
from memcnet_tpu.ops import projection as JP

import memcnet_tpu_torch.ops as T
from memcnet_tpu_torch.ops import mc as TM
from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops.cuda import project_kernel as P

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def edge_flow(rng, B, H, W, amp=2.0):
    """A random flow of about ``amp`` px whose pixels also land exactly on
    x = W-1 and y = H-1 (clamped neighbours), on x = 0, at x = -0.5 and far
    outside the frame."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    f = (rng.randn(B, 2, H, W) * amp).astype(np.float32)
    k = rng.randint(0, 8, size=(B, H, W))
    f[:, 0] = np.where((k == 1) | (k == 3), (W - 1) - xs, f[:, 0])
    f[:, 1] = np.where((k == 2) | (k == 3), (H - 1) - ys, f[:, 1])
    f[:, 0] = np.where(k == 4, -xs, f[:, 0])
    f[:, 0] = np.where(k == 5, -0.5 - xs, f[:, 0])
    f[:, 0] = np.where(k == 6, 3.0 * W, f[:, 0])
    return f


def both_vjp(jfn, tfn, args, rng, argnums):
    """(JAX outputs, port outputs, JAX grads, port grads) of one random
    cotangent per output; grads of the arguments in ``argnums``."""
    jargs = [jnp.asarray(a) for a in args]
    jout, vjp = jax.vjp(lambda *xs: jfn(*xs), *jargs)
    outs = jout if isinstance(jout, tuple) else (jout,)
    cots = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    jgrads = vjp(cots if isinstance(jout, tuple) else cots[0])
    targs = [t(a).requires_grad_(i in argnums) for i, a in enumerate(args)]
    tout = tfn(*targs)
    touts = tout if isinstance(tout, tuple) else (tout,)
    tgrads = torch.autograd.grad(touts, [targs[i] for i in argnums], [t(c) for c in cots])
    return outs, touts, [jgrads[i] for i in argnums], tgrads


def check_vjp(jfn, tfn, args, rng, argnums, tol=TOL):
    jo, to, jg, tg = both_vjp(jfn, tfn, args, rng, argnums)
    for a, b in zip(to, jo):
        close(a, b, tol)
    for a, b in zip(tg, jg):
        close(a, b, tol)
    return jo, to


def test_exports_the_jax_op_names():
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert callable(getattr(T, name)), name


# ---------------------------------------------------------------- N3 / N4


@pytest.mark.parametrize("name,C,amp", [("bilinear_warp", 3, 2.0), ("bilinear_warp_ch", 5, 6.0)])
def test_bilinear_warp_matches_jax(rng, name, C, amp):
    B, H, W = 2, 9, 13
    image = rng.rand(B, C, H, W).astype(np.float32)
    flow = edge_flow(rng, B, H, W, amp)
    flow[0, 0, 0, :3] = [W - 1.0, W - 0.5, -1e-3]  # x2 = W-1 (valid), W - 0.5 (valid), < 0
    jo, to = check_vjp(getattr(J, name), getattr(T, name), [image, flow], rng, (0, 1))
    assert (np.asarray(jo[0]) == 0).any()  # out-of-range pixels are zero


def test_bilinear_warp_strict_gate():
    """x2 = W is out (strict < W), x2 = W - 1 in, with its right tap
    clamped to the border."""
    H, W = 4, 5
    image = np.arange(H * W, dtype=np.float32).reshape(1, 1, H, W) + 1.0
    flow = np.zeros((1, 2, H, W), np.float32)
    flow[0, 0, 1, 0] = W  # lands at x = W
    flow[0, 0, 2, 0] = W - 1.0
    got = T.bilinear_warp(t(image), t(flow)).numpy()
    want = np.asarray(J.bilinear_warp(image, flow))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 1, 0] == 0.0 and got[0, 0, 2, 0] == image[0, 0, 2, W - 1]


# ---------------------------------------------------------------- N2 down scan


def test_flow_project_fix_down_scan_bug_matches_jax(rng):
    B, H, W = 2, 14, 37
    flow = edge_flow(rng, B, H, W, 5.0)
    want = np.asarray(JP.flow_project(jnp.asarray(flow), fillhole=True, fix_down_scan_bug=True))
    got = T.flow_project(t(flow), fillhole=True, fix_down_scan_bug=True)
    close(got, want)
    plain = T.flow_project(t(flow), fillhole=True)
    assert not torch.equal(got, plain)  # the down scan changed some holes


def test_fill_stage_down_matches_fill_reference(rng):
    """K3's plain stage with the down search (what the card is held
    against) equals the plain fill with fix_down_scan_bug."""
    flow = t(edge_flow(rng, 2, 11, 40, 6.0))
    _, avg, masks = P.sums_stage_reference(flow, True)
    _, want_avg, cnt = P.sums_and_average(flow)
    got = P.fill_stage_reference(avg, masks, torch.float32, down=True)
    want = P.fill_reference(want_avg, cnt, fix_down_scan_bug=True)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- N7


@pytest.mark.parametrize("fillhole,amp", [(False, 2.0), (True, 6.0)])
def test_depth_flow_project_matches_jax(rng, fillhole, amp):
    B, H, W = 2, 12, 21
    flow = edge_flow(rng, B, H, W, amp)
    depth = (rng.rand(B, 1, H, W) + 0.5).astype(np.float32)
    depth[0, 0, 3, :5] = 0.0  # zero depths: sums of depth, not counts
    check_vjp(lambda f, d: J.depth_flow_project(f, d, fillhole=fillhole),
              lambda f, d: T.depth_flow_project(f, d, fillhole=fillhole),
              [flow, depth], rng, (0, 1))


def test_depth_sums_and_hand_backward_match_jax(rng):
    """The depth sum (the divisor plane) exactly, the average, and the
    reference's hand backward (f - avg in the depth term) against
    _depth_project_bwd, zero sums included."""
    B, H, W = 2, 10, 17
    flow = edge_flow(rng, B, H, W, 3.0)
    depth = np.round(rng.rand(B, 1, H, W) * 4) / 4  # quarters: sums exact in any order
    depth = depth.astype(np.float32)
    g = rng.randn(B, 2, H, W).astype(np.float32)
    javg, jcnt = JP._depth_project_core(jnp.asarray(flow), jnp.asarray(depth))
    _, tavg, tcnt = P.payload_average(t(flow), TP.depth_payload(t(flow), t(depth)))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert (np.asarray(jcnt) == 0).any() and (np.asarray(jcnt) > 0).any()
    close(tavg, javg)
    jg = JP._depth_project_bwd((jnp.asarray(flow), jnp.asarray(depth), javg, jcnt),
                               (jnp.asarray(g), None))
    tg = TP.depth_project_backward(t(flow), t(depth), tavg, tcnt, t(g))
    for a, b in zip(tg, jg):
        close(a, b)


# ---------------------------------------------------------------- N8


def gated_frames(rng, B, H, W):
    frame1 = rng.rand(B, 3, H, W).astype(np.float32)
    frame2 = np.clip(frame1 + rng.randn(B, 3, H, W).astype(np.float32) * 0.15, 0, 1)
    return frame1, frame2.astype(np.float32)


@pytest.mark.parametrize("fillhole,threshold", [(False, 0.1), (True, 0.1), (False, 20.0 / 255.0)])
def test_weighted_flow_project_matches_jax(rng, fillhole, threshold):
    B, H, W = 2, 12, 19
    flow = edge_flow(rng, B, H, W, 2.5)
    frame1, frame2 = gated_frames(rng, B, H, W)
    check_vjp(lambda f, a, b: J.weighted_flow_project(f, a, b, threshold=threshold,
                                                      fillhole=fillhole),
              lambda f, a, b: T.weighted_flow_project(f, a, b, threshold=threshold,
                                                      fillhole=fillhole),
              [flow, frame1, frame2], rng, (0, 1, 2))


def test_weighted_gate_and_counts_exact(rng):
    """err in the JAX order, the gate (some pixels gated out, some in) and
    the count plane equal the JAX package's exactly."""
    B, H, W = 2, 12, 19
    flow = edge_flow(rng, B, H, W, 2.5)
    frame1, frame2 = gated_frames(rng, B, H, W)
    threshold = 0.1
    f = jnp.asarray(flow)
    xs = jnp.arange(W, dtype=f.dtype)[None, None, :]
    ys = jnp.arange(H, dtype=f.dtype)[None, :, None]
    x3 = jnp.clip(xs + 2.0 * f[:, 0], 0.0, W - 1.0).astype(jnp.int32)
    y3 = jnp.clip(ys + 2.0 * f[:, 1], 0.0, H - 1.0).astype(jnp.int32)
    diff = jnp.abs(jnp.asarray(frame1) - JP._gather_neighbors(jnp.asarray(frame2), y3, x3, W))
    jerr = diff[:, 0] / 3.0 + diff[:, 1] / 3.0 + diff[:, 2] / 3.0 + 1e-8
    valid = JP._landing_cells(f)[0]
    jgate = np.asarray(valid & (jerr <= threshold))
    terr = TP.brightness_error(t(flow), t(frame1), t(frame2))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    payload = TP.weighted_payload(t(flow), t(frame1), t(frame2), threshold)
    np.testing.assert_array_equal(payload[:, 3].numpy() > 0, jgate)
    assert 0 < jgate.mean() < np.asarray(valid).mean()
    vals, ixL, ixR, iyT, iyB = JP._landing_cells(f)
    _, jcnt = JP._scatter4(jnp.zeros((B, 0, H, W)), jnp.ones((B, H, W)), jnp.asarray(jgate),
                           ixL, ixR, iyT, iyB, H, W)
    _, _, tcnt = P.payload_average(t(flow), payload)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


def test_n7_n8_match_the_pallas_interpret_path(rng):
    """The JAX N7 and N8 through the Pallas scatter (and, with the fill, the
    Pallas fill) in interpret mode, as the TPU runs them, against the port."""
    B, H, W = 1, 16, 128  # rows a multiple of the band, so the Pallas path qualifies
    flow = edge_flow(rng, B, H, W, 2.0)
    depth = (rng.rand(B, 1, H, W) + 0.5).astype(np.float32)
    frame1, frame2 = gated_frames(rng, B, H, W)
    JP._FORCE_INTERPRET = True
    try:
        jd = np.asarray(JP.depth_flow_project(jnp.asarray(flow), jnp.asarray(depth),
                                              fillhole=True))
        jw, jwp = JP.weighted_flow_project(jnp.asarray(flow), jnp.asarray(frame1),
                                           jnp.asarray(frame2), threshold=0.3, fillhole=True)
    finally:
        JP._FORCE_INTERPRET = False
    close(T.depth_flow_project(t(flow), t(depth), fillhole=True), jd)
    tw, twp = T.weighted_flow_project(t(flow), t(frame1), t(frame2), threshold=0.3,
                                      fillhole=True)
    close(tw, jw)
    close(twp, jwp)


@pytest.mark.parametrize("P_", [3, 4])
def test_payload_stage_matches_payload_average(rng, P_):
    """The payload entry's plain stage (what the card is held against):
    counts and masks from plane P-1, the extra plane in the flow's type."""
    B, H, W = 2, 9, 35
    flow = t(edge_flow(rng, B, H, W, 3.0))
    payload = t(rng.rand(B, P_, H, W).astype(np.float32))
    payload[:, -1] = (payload[:, -1] > 0.3).float()
    S, avg, extra, masks = P.payload_stage_reference(flow, payload, True)
    _, want, den = P.payload_average(flow, payload)
    assert torch.equal(avg, want[:, :2])
    assert (extra is None) == (P_ == 3)
    if extra is not None:
        assert torch.equal(extra, want[:, 2:])
    has = P.unpack_bits(masks.rows, W)
    assert torch.equal(has, den > 0)
    assert torch.equal(P.fold(S)[:, -1], den)
    assert torch.equal(P.fill_stage_reference(avg, masks, torch.float32),
                       P.fill_reference(want[:, :2], den))


# ---------------------------------------------------------------- N5 / N6


@pytest.mark.parametrize("fs", [3, 4])
def test_separable_conv_matches_jax(rng, fs):
    B, C, H, W = 2, 3, 10, 12
    image = rng.rand(B, C, H, W).astype(np.float32)
    vert = rng.randn(B, fs, H - fs + 1, W - fs + 1).astype(np.float32)
    horiz = rng.randn(B, fs, H - fs + 1, W - fs + 1).astype(np.float32)
    check_vjp(J.separable_conv, T.separable_conv, [image, vert, horiz], rng, (0, 1, 2))


def test_separable_conv_flow_matches_jax_with_exact_sentinel(rng):
    B, fs, oH, oW = 2, 5, 6, 7
    vert = rng.rand(B, fs, oH, oW).astype(np.float32)
    horiz = rng.rand(B, fs, oH, oW).astype(np.float32)
    vert[0, :, 2, 3] = 0.0
    horiz[1, :, 4, 1] = 0.0
    vert[1, :, 0, 0] = [0.25, -0.5, 0.0, 0.5, -0.25]  # sums to exactly 0 in any order
    jo, to = check_vjp(J.separable_conv_flow, T.separable_conv_flow, [vert, horiz], rng, (0, 1))
    sentinel = np.asarray(jo[0]) == -2000.0
    assert sentinel.sum() == 3
    np.testing.assert_array_equal(to[0].detach().numpy() == T.sepconv.FLOW_SENTINEL, sentinel)


# ---------------------------------------------------------------- N9


@pytest.mark.parametrize("lambda_e", [0.02, 0.5])
def test_occlusion_weight_matches_jax(rng, lambda_e):
    """Forward and the reference's hand backward; lambda_e 0.02 puts most
    errors above lambda_e, where the -2 sqrt(w) rule loses the sign."""
    B, C, H, W = 2, 3, 9, 11
    frame1 = rng.rand(B, C, H, W).astype(np.float32)
    frame2 = np.clip(frame1 + rng.randn(B, C, H, W).astype(np.float32) * 0.1, 0, 1)
    frame2 = frame2.astype(np.float32)
    frame2[:, :, :2] = frame1[:, :, :2]  # p1 == tgt taps: where(p1 > tgt, 1, -1) gives -1
    flow = edge_flow(rng, B, H, W, 1.5)
    flow[:, :, :2] = 0.0
    jo, _ = check_vjp(lambda a, b, f: J.occlusion_weight(a, b, f, lambda_e=lambda_e),
                      lambda a, b, f: T.occlusion_weight(a, b, f, lambda_e=lambda_e),
                      [frame1, frame2, flow], rng, (0, 1, 2))
    assert (np.asarray(jo[0]) == np.float32(1e-4)).any()


def test_occlusion_weight_backward_is_not_autograd(rng):
    """The transcribed backward differs from autograd of the forward (the
    reference's rule), so it cannot have been derived."""
    B, C, H, W = 1, 3, 6, 7
    frame1 = t(rng.rand(B, C, H, W).astype(np.float32)).requires_grad_()
    frame2 = t(rng.rand(B, C, H, W).astype(np.float32))
    flow = t((rng.randn(B, 2, H, W) * 0.7).astype(np.float32))
    g = t(rng.randn(B, 1, H, W).astype(np.float32))
    (hand,) = torch.autograd.grad(T.occlusion_weight(frame1, frame2, flow), [frame1], g)
    (auto,) = torch.autograd.grad(TM.occlusion_weight_reference(frame1, frame2, flow),
                                  [frame1], g)
    assert not torch.allclose(hand, auto, atol=1e-3)


# ---------------------------------------------------------------- N10 / N11


@pytest.mark.parametrize("sigma_d", [1.0, 0.7])
def test_pixel_splat_matches_jax(rng, sigma_d):
    B, C, H, W = 2, 3, 8, 10
    values = rng.rand(B, C, H, W).astype(np.float32)
    flow = edge_flow(rng, B, H, W, 2.0) * 2.0  # the splat lands at p + f/2
    fw = rng.rand(B, 1, H, W).astype(np.float32)
    check_vjp(lambda v, f, w: J.pixel_splat(v, f, w, sigma_d=sigma_d),
              lambda v, f, w: T.pixel_splat(v, f, w, sigma_d=sigma_d),
              [values, flow, fw], rng, (0, 1, 2))


@pytest.mark.parametrize("name", ["pixel_value", "pixel_weight", "reliable_weight"])
def test_splat_modes_match_jax(rng, name):
    B, C, H, W = 2, 3, 7, 9
    values = rng.rand(B, C, H, W).astype(np.float32)
    flow = edge_flow(rng, B, H, W, 2.0) * 2.0
    fw = rng.rand(B, 1, H, W).astype(np.float32)
    args = {"pixel_value": [values, flow, fw], "pixel_weight": [flow, fw],
            "reliable_weight": [flow]}[name]
    check_vjp(getattr(J, name), getattr(T, name), args, rng, tuple(range(len(args))))


def test_splat_flow_gradient_is_minus_twice_autograd(rng):
    B, H, W = 1, 6, 8
    flow = t((rng.randn(B, 2, H, W) * 2.0).astype(np.float32)).requires_grad_()
    g = t(rng.randn(B, 1, H, W).astype(np.float32))
    (hand,) = torch.autograd.grad(T.reliable_weight(flow), [flow], g)
    (auto,) = torch.autograd.grad(TM.splat_reference("reliable", 1.0, flow), [flow], g)
    assert torch.equal(hand, -2.0 * auto)
    assert hand.abs().max() > 0


# ---------------------------------------------------------------- bf16


def test_bf16_landing_coordinates_are_float32(rng):
    """The JAX mc and gated-projection ops build landing coordinates in the
    flow's type; the port in float32, so a bf16 flow lands where its float32
    value does (above x = 256 a bf16 grid is up to 4 px off)."""
    B, H, W = 1, 4, 600
    flow = t(np.full((B, 2, H, W), 0.25, np.float32))
    x2, _ = TM._flow_landing(flow.bfloat16(), 1.0)
    assert torch.equal(x2, TM._flow_landing(flow, 1.0)[0])
    assert float(x2[0, 0, 513]) == 513.25
    frame1, frame2 = (t(rng.rand(B, 3, H, W).astype(np.float32)) for _ in range(2))
    err32 = TP.brightness_error(flow, frame1, frame2)
    assert torch.equal(TP.brightness_error(flow.bfloat16(), frame1, frame2), err32)
    xs = jnp.arange(W, dtype=jnp.bfloat16)
    assert float(xs[513] + 0.25) != 513.25  # the JAX bf16 grid
