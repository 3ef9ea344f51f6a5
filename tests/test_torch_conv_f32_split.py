"""K4's float32 body on the CPU: its 3xTF32 arithmetic and its data layout.

The body (``csrc/conv_f32.cu``) runs only on the card.  What it computes
is held here before the card runs it:

* ``conv_kernel.tf32_round`` is ``cvt.rna.tf32.f32`` (nearest, ties away
  from zero, 13 low bits cleared) and ``split_tf32`` keeps a value to 2^-22
  of itself;
* ``conv_kernel.tf32x3_reference`` -- the split and the three-pass sum in
  plain PyTorch -- meets the card's rule for float32 K4 (max abs err
  <= 5e-4 at SPyNet's sums) against ``F.conv2d`` in float32, and stays
  within 2^-20 * sum|x w| of a float64 conv;
* the kernel's index arithmetic, replayed in numpy (``emulate``: the halo
  staged by ``load_input``, the weights packed by ``pack_f32_weights``, the
  m16n8k8 fragments each lane loads, the accumulator each lane stores), gives
  the conv: so the packing, the channel slots and the fragment roles agree;
* ``f32_geometry`` fills the card at SPyNet's levels.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.ops.cuda import conv_kernel as ck

SPYNET = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    cases = {
        one + 2.0 ** -11: one + 2.0 ** -10,            # a tie: away from zero
        -(one + 2.0 ** -11): -(one + 2.0 ** -10),
        one + 2.0 ** -11 - 2.0 ** -23: one,            # below the tie
        one + 3 * 2.0 ** -11: one + 2.0 ** -9,         # a tie above an odd last bit
        2.0 - 2.0 ** -23: 2.0,                         # carries into the exponent
        0.0: 0.0,
    }
    got = ck.tf32_round(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32) * 100)
    r = ck.tf32_round(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((r - x).abs() <= x.abs() * 2.0 ** -11).all())


def test_split_keeps_2_to_the_minus_22():
    x = torch.from_numpy(np.random.RandomState(1).randn(1 << 14).astype(np.float32))
    hi, lo = ck.split_tf32(x)
    assert torch.equal(hi, ck.tf32_round(hi)) and torch.equal(lo, ck.tf32_round(lo))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -22).all())


def spynet_conv(cin, cout, h, w, seed):
    """SPyNet's conv at a small width: torch-0.2 default weights, x in [-2, 2)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((2, cin, h, w), generator=gen) * 4.0 - 2.0
    wt = I.torch_default_uniform((cout, cin, 7, 7), gen)
    b = I.torch_default_uniform((cout,), gen, fan_in=cin * 49)
    return x, wt, b


@pytest.mark.parametrize("cin,cout", SPYNET + [(3, 64)])
def test_three_passes_meet_the_card_rule(cin, cout):
    x, w, b = spynet_conv(cin, cout, 12, 20, seed=cin + cout)
    if cin == 3:  # the ctx conv: no bias, msra weights, no ReLU
        w, b = I.resnet_msra((cout, cin, 7, 7), torch.Generator().manual_seed(1)), None
    relu = cout != 2 and b is not None
    got = ck.tf32x3_reference(x, w, b, relu)
    assert float((got - ck.reference(x, w, b, relu)).abs().max()) <= 5e-4
    exact = F.conv2d(x.double(), w.double(), None if b is None else b.double(), padding=3)
    if relu:
        exact = exact.clamp(min=0.0)
    budget = F.conv2d(x.double().abs(), w.double().abs(), padding=3) * 2.0 ** -20
    assert bool(((got.double() - exact).abs() <= budget + 1e-12).all())


def split64(v):
    """``tf32_split`` of float32 values, as float64 (hi, lo)."""
    hi, lo = ck.split_tf32(torch.from_numpy(np.asarray(v, dtype=np.float32)))
    return hi.double().numpy(), lo.double().numpy()


def emulate(x, wp, bias, relu, O, K, geo):
    """The float32 body's blocks, replayed in numpy (float64 products): each
    chunk's halo staged channels-last as ``load_input`` writes it, each kernel
    row of ``wp`` as ``load_weights`` copies it, the A and B fragments of each
    lane read at the kernel's offsets (A split as loaded), the m16n8k8
    products formed from the PTX fragment roles (a0..a3: rows g, g + 8 at
    depth t, t + 4; b0, b1: depth t, t + 4 of column g; c0..c3: rows g,
    g + 8, columns 2t, 2t + 1) as lo*hi + hi*lo + hi*hi, and each lane's
    accumulators stored where the epilogue stores them."""
    B, C, H, W = x.shape
    CG, TPS, G, NT, MT = (geo[k] for k in ("CG", "TPS", "G", "NT", "MT"))
    TH, P = 8 * MT, K // 2
    SH, SWS = TH + K - 1, 16 + G * TPS - 1
    wp = wp.numpy().astype(np.float64).reshape(wp.shape[0], wp.shape[1], K, -1)
    x = x.numpy().astype(np.float64)
    out = np.zeros((B, O, H, W))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    ci = np.arange(CG)
    slot = 2 * (ci & 3) + (ci >> 2) if CG == 8 else ci
    rows = np.arange(8 * MT)[:, None]  # warp * MT + m
    for b in range(B):
        for og in range(-(-O // NT)):
            for y0 in range(0, H, TH):
                for x0 in range(0, W, 16):
                    acc = np.zeros((8 * MT, NT // 8, 32, 4))
                    for chunk in range(-(-C // CG)):
                        halo = np.zeros((SH, SWS, CG))
                        for r in range(SH):
                            for col in range(min(SWS, 16 + K - 1)):
                                gy, gx = y0 - P + r, x0 - P + col
                                if 0 <= gy < H and 0 <= gx < W:
                                    chans = np.minimum(chunk * CG + ci, C - 1)
                                    v = np.where(chunk * CG + ci < C, x[b, chans, gy, gx], 0.0)
                                    halo[r, col, slot] = v
                        flat = halo.reshape(-1)
                        for ky in range(K):
                            wrow = wp[og, chunk, ky]
                            for gs in range(G):
                                ah, al = np.zeros((8 * MT, 32, 4)), np.zeros((8 * MT, 32, 4))
                                for half in range(2):
                                    q = g + 8 * half + gs * TPS
                                    base = (rows + ky) * SWS + q
                                    if CG == 8:
                                        v0, v1 = flat[base * 8 + 2 * t], flat[base * 8 + 2 * t + 1]
                                    else:
                                        v0, v1 = flat[base * 4 + t], flat[(base + 1) * 4 + t]
                                    (h0, l0), (h1, l1) = split64(v0), split64(v1)
                                    ah[:, :, half], ah[:, :, 2 + half] = h0, h1
                                    al[:, :, half], al[:, :, 2 + half] = l0, l1
                                Ah, Al = np.zeros((8 * MT, 16, 8)), np.zeros((8 * MT, 16, 8))
                                for A, a in ((Ah, ah), (Al, al)):
                                    A[:, g, t], A[:, g + 8, t] = a[:, :, 0], a[:, :, 1]
                                    A[:, g, t + 4], A[:, g + 8, t + 4] = a[:, :, 2], a[:, :, 3]
                                for j in range(NT // 8):
                                    off = ((gs * NT + 8 * j + g) * 4 + t) * 4
                                    bw = wrow[off[:, None] + np.arange(4)]
                                    Bh, Bl = np.zeros((8, 8)), np.zeros((8, 8))
                                    Bh[t, g], Bh[t + 4, g] = bw[:, 0], bw[:, 1]  # depth t, t + 4
                                    Bl[t, g], Bl[t + 4, g] = bw[:, 2], bw[:, 3]
                                    D = Al @ Bh + Ah @ Bl + Ah @ Bh
                                    acc[:, j, :, 0] += D[:, g, 2 * t]
                                    acc[:, j, :, 1] += D[:, g, 2 * t + 1]
                                    acc[:, j, :, 2] += D[:, g + 8, 2 * t]
                                    acc[:, j, :, 3] += D[:, g + 8, 2 * t + 1]
                    for j in range(NT // 8):
                        for e in range(4):
                            n = og * NT + 8 * j + 2 * t + (e & 1)
                            xx = x0 + g + 8 * (e >> 1)
                            for r in range(8 * MT):
                                y = y0 + r
                                if y >= H:
                                    continue
                                ok = (n < min(O, og * NT + NT)) & (xx < W)
                                v = acc[r, j, ok, e] + (0.0 if bias is None else
                                                        bias.numpy()[n[ok]])
                                out[b, n[ok], y, xx[ok]] = np.maximum(v, 0.0) if relu else v
    return out


def emulate_taps(x, wp, bias, relu, O, K, MT):
    """The small-O variant (N = o * K + kx) replayed as ``emulate`` replays
    the GEMM: per block 32 halo columns in two m16 tiles, one depth-8 step
    per (chunk, ky), D staged as the epilogue stages it and summed over kx
    for the block's 32 - (K - 1) output columns."""
    B, C, H, W = x.shape
    TH, P, TW = 8 * MT, K // 2, 32 - (K - 1)
    SH, DS = TH + K - 1, 17
    wp = wp.numpy().astype(np.float64).reshape(wp.shape[0], K, -1)
    x = x.numpy().astype(np.float64)
    out = np.zeros((B, O, H, W))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    ci = np.arange(8)
    slot = 2 * (ci & 3) + (ci >> 2)
    rows = np.arange(TH)[:, None]
    for b in range(B):
        for y0 in range(0, H, TH):
            for x0 in range(0, W, TW):
                acc = np.zeros((TH, 2, 2, 32, 4))
                for chunk in range(wp.shape[0]):
                    halo = np.zeros((SH, 32, 8))
                    for r in range(SH):
                        for col in range(32):
                            gy, gx = y0 - P + r, x0 - P + col
                            if 0 <= gy < H and 0 <= gx < W:
                                chans = np.minimum(chunk * 8 + ci, C - 1)
                                halo[r, col, slot] = np.where(chunk * 8 + ci < C,
                                                              x[b, chans, gy, gx], 0.0)
                    flat = halo.reshape(-1)
                    for ky in range(K):
                        wrow = wp[chunk, ky]
                        for mt in range(2):
                            A = np.zeros((TH, 16, 8))
                            for half in range(2):
                                base = (rows + ky) * 32 + 16 * mt + g + 8 * half
                                A[:, g + 8 * half, t] = flat[base * 8 + 2 * t]
                                A[:, g + 8 * half, t + 4] = flat[base * 8 + 2 * t + 1]
                            for n in range(2):
                                bw = wrow[(((8 * n + g) * 4 + t) * 4)[:, None] + np.arange(4)]
                                Bm = np.zeros((8, 8))
                                Bm[t, g], Bm[t + 4, g] = bw[:, 0] + bw[:, 2], bw[:, 1] + bw[:, 3]
                                D = A @ Bm
                                for e in range(4):
                                    acc[:, mt, n, :, e] += D[:, g + 8 * (e >> 1), 2 * t + (e & 1)]
                d = np.zeros((TH, 32, DS))
                for mt in range(2):
                    for n in range(2):
                        for e in range(4):
                            d[:, 16 * mt + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)] = \
                                acc[:, mt, n, :, e]
                for o in range(O):
                    for r in range(min(TH, H - y0)):
                        for p in range(min(TW, W - x0)):
                            v = sum(d[r, p + kx, o * K + kx] for kx in range(K))
                            v += 0.0 if bias is None else float(bias[o])
                            out[b, o, y0 + r, x0 + p] = max(v, 0.0) if relu else v
    return out


@pytest.mark.parametrize("C,O,K,H,W", [(16, 2, 7, 19, 33), (3, 2, 7, 9, 30), (11, 3, 5, 17, 29),
                                       (20, 5, 3, 10, 35)])
def test_small_o_variant_replayed_gives_the_conv(C, O, K, H, W):
    """The taps-in-N variant (O * K <= 16): SPyNet's 16 -> 2 and O = 2 with
    C = 3, ragged chunks, K 3, 5, 7, widths past one block of 32 - (K - 1)."""
    rng = np.random.RandomState(C * 10 + O)
    x = torch.from_numpy(rng.randn(2, C, H, W).astype(np.float32))
    w = torch.from_numpy((rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(O).astype(np.float32) * 0.1)
    geo = ck.f32_geometry(2, C, H, W, O, K)
    assert geo["taps"] and geo["NT"] == ck.TAP_N and geo["CG"] == 8
    want = F.conv2d(x.double(), w.double(), bias.double(), padding=K // 2)
    wp = ck.pack_f32_tap_weights(w)
    assert wp.shape == (-(-C // 8), K, ck.TAP_N, 4, 4)
    for MT in (1, 2):
        got = emulate_taps(x, wp, bias, False, O, K, MT)
        assert np.abs(got - want.numpy()).max() <= 1e-5, MT


@pytest.mark.parametrize("C,O,K,H,W", [(3, 64, 7, 9, 21), (8, 32, 7, 10, 18), (11, 12, 5, 9, 17),
                                       (16, 3, 3, 11, 19), (4, 40, 3, 8, 16)])
def test_kernel_layout_replayed_gives_the_conv(C, O, K, H, W):
    """Every geometry of the GEMM: CG 4 and 8, a ragged last chunk (11),
    O past one group (40) and under one n8 tile (3), MT 1, 2 and 4, K 3, 5,
    7, H and W off the 16 x TH tile."""
    rng = np.random.RandomState(C * 100 + O)
    x = torch.from_numpy(rng.randn(2, C, H, W).astype(np.float32))
    w = torch.from_numpy((rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(O).astype(np.float32) * 0.1)
    want = F.conv2d(x.double(), w.double(), bias.double(), padding=K // 2).clamp(min=0.0)
    budget = (F.conv2d(x.double().abs(), w.double().abs(), padding=K // 2) * 2.0 ** -20).numpy()
    for NT, MT in ((None, None), (8, 1), (16, 2), (32, 4)):
        geo = ck.f32_geometry(2, C, H, W, O, K)
        if NT is not None:
            geo.update(NT=NT, MT=MT)
        wp = ck.pack_f32_weights(w, geo["CG"], geo["NT"])
        assert wp.shape[-2:] == (4, 4) and wp.shape[:4] == (-(-O // geo["NT"]),
                                                              -(-C // geo["CG"]), K, geo["G"])
        got = emulate(x, wp, bias, True, O, K, geo)
        assert (np.abs(got - want.numpy()) <= budget).all(), (NT, MT)


@pytest.mark.parametrize("level", range(6))
def test_geometry_fills_the_card_at_every_spynet_level(level):
    """At 720p (768x1344, B = 2) every SPyNet conv launches at least two
    blocks per SM, or runs its narrowest blocks (MT = 1, NT = 8)."""
    h, w = 768 >> level, 1344 >> level
    for cin, cout in SPYNET:
        p = ck.f32_geometry(2, cin, h, w, cout, 7)
        blocks = -(-w // p["width"]) * -(-h // p["TH"]) * 2 * p["n_groups"]
        assert blocks >= 2 * ck.SMS or p["MT"] == 1 and p["NT"] in (8, ck.TAP_N)
        assert p["NT"] * p["n_groups"] >= cout and p["CG"] == 8
        assert p["taps"] == (cout == 2)
        if level == 0 and cout > 2:
            assert (p["MT"], p["NT"]) == (2 if cout == 64 else 4, cout)
    assert ck.f32_geometry(2, 3, 768, 1344, 64, 7)["CG"] == 4
