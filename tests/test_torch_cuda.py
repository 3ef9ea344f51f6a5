"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the served paths and the three demos against their CPU runs.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
from memcnet_tpu_torch/csrc at first use); without CUDA they skip.  Run them
on the card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py pins JAX to the CPU and imports it, and
the machine with the card has no JAX; these tests import none of it.)

Tolerances: float32 ATOL 1e-4 (the same float32 arithmetic summed in another
order, or by atomics in a run-dependent order); bf16 outputs within 2 bf16
units in the last place of the plain value (one rounding of a float32 sum
that may flip) -- for K4 beyond 8 input channels, where hundreds of terms are
summed in another order and may cancel to near zero, beyond the float32
tolerance as well; projection counts and masks exact, the projection's
float32 average and result within 1e-3 (float atomics in a run-dependent
order over sums of up to ~10 flows of up to 200 px).
"""

import numpy as np
import pytest
import torch

from memcnet_tpu_torch import probe
from memcnet_tpu_torch.cli import demo_hd720p, demo_middlebury, demo_vimeo_ve
from memcnet_tpu_torch.cli.runner import PaddedInterp, PaddedVE, build_model
from memcnet_tpu_torch.io.png import imread
from memcnet_tpu_torch.ops import cuda as K
from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
from memcnet_tpu_torch.ops.cuda import project_kernel as P
from memcnet_tpu_torch.probe import device_ops

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run python -m pytest tests/test_torch_cuda.py "
                    "--noconftest on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def close(got, ref, long_sums=False):
    f32_tol = ATOL * max(1.0, float(ref.float().abs().max()))
    if ref.dtype == torch.float32:
        assert float((got - ref).abs().max()) <= f32_tol
        return
    r = ref.float().abs()
    e = torch.floor(torch.log2(torch.where(r > 0, r, torch.ones_like(r))))
    ulp = torch.where(r > 0, torch.exp2(e - 7), torch.full_like(r, 2.0 ** -133))
    err = (got.float() - ref.float()).abs()
    if long_sums:
        err = (err - f32_tol).clamp(min=0.0)
    assert float((err / ulp).max()) <= 2.0


def flow_field(rng, B, H, W, amp):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    f = np.zeros((B, 2, H, W), np.float32)
    f[:, 0] = amp * np.sin(2 * np.pi * ys / H) * np.cos(2 * np.pi * xs / W)
    f[:, 1] = 0.6 * amp * np.cos(2 * np.pi * xs / W)
    f += rng.randn(B, 2, H, W).astype(np.float32) * 0.5
    f[:, 0, :4, :6] = 3 * W  # out of range
    return torch.from_numpy(f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fs", [4, 2])
def test_warp_kernel_matches_plain(rng, dev, dtype, fs):
    B, H, W = 2, 37, 150
    ims = [torch.from_numpy(rng.rand(B, c, H, W).astype(np.float32)).to(dev, dtype)
           for c in (3, 64)]
    flow = flow_field(rng, B, H, W, 8.0).to(dev)
    filt = torch.from_numpy(rng.rand(B, fs * fs, H, W).astype(np.float32)).to(dev, dtype)
    got = warp_kernel.launch(ims, flow, filt, fs)
    ref = warp_kernel.reference(ims, flow, filt, fs)
    for g, r in zip(got, ref):
        close(g, r)


def border_flow(rng, B, H, W):
    """Small random flow, with bands of pixels that land just inside each
    border, so the patches clamp at all four borders."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    f = (rng.randn(B, 2, H, W) * 2.0).astype(np.float32)
    f[:, 0, :, :5] = 0.3 - xs[:, :5]               # land at x = 0.3
    f[:, 0, :, -5:] = (W - 1.2) - xs[:, -5:]       # land at x = W - 1.2
    f[:, 1, :4] = 0.6 - ys[:4]                     # land at y = 0.6
    f[:, 1, -4:] = (H - 1.1) - ys[-4:]             # land at y = H - 1.1
    f[:, 0, 10:12, 20:30] = 2.0 * W                # out of range: copied through
    return torch.from_numpy(f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [(3,), (3, 64), (1, 2, 5), (4, 3, 2, 7)])
@pytest.mark.parametrize("W", [150, 151, 152])
@pytest.mark.parametrize("fs", [4, 2])
def test_warp_kernel_sources_borders_and_widths(rng, dev, dtype, channels, W, fs):
    """1-4 split sources; W = 152 is a multiple of 8 (the bf16 interior
    patches take the aligned row loads), 150 and 151 are not multiples of 4;
    patches clamped at every border."""
    B, H = 2, 29
    ims = [torch.from_numpy(rng.rand(B, c, H, W).astype(np.float32)).to(dev, dtype)
           for c in channels]
    flow = border_flow(rng, B, H, W).to(dev)
    filt = torch.from_numpy(rng.rand(B, fs * fs, H, W).astype(np.float32)).to(dev, dtype)
    got = warp_kernel.launch(ims, flow, filt, fs)
    ref = warp_kernel.reference(ims, flow, filt, fs)
    assert len(got) == len(channels)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("amp", [20.0, None])
def test_warp_kernel_at_ve_batch(rng, dev, dtype, amp):
    """MEMC_Net_VE's split warp: B = 6 (six neighbours), sources of 3 and 64
    channels, on a smooth 20 px field or on +-20 px noise (source boxes too
    wide for shared memory)."""
    B, H, W = 6, 64, 96
    ims = [torch.from_numpy(rng.rand(B, c, H, W).astype(np.float32)).to(dev, dtype)
           for c in (3, 64)]
    if amp is None:
        flow = torch.from_numpy(rng.uniform(-20, 20, (B, 2, H, W)).astype(np.float32)).to(dev)
    else:
        flow = flow_field(rng, B, H, W, amp).to(dev)
    filt = torch.from_numpy(rng.rand(B, 16, H, W).astype(np.float32)).to(dev, dtype)
    got = warp_kernel.launch(ims, flow, filt, 4)
    ref = warp_kernel.reference(ims, flow, filt, 4)
    for g, r in zip(got, ref):
        close(g, r)


def projection_flow(rng, B, H, W, kind):
    """Flows for the fused projection: the smooth field at 1.5 or 12 px, +-200
    px of noise (most landings outside the frame, long runs of holes), or
    every landing invalid (every pixel a hole)."""
    if kind == "all_invalid":
        f = np.full((B, 2, H, W), 3.0 * W, np.float32)
        f[:, 1, ::3] = -1.0 - H
        return torch.from_numpy(f)
    if kind == "pm200":
        return torch.from_numpy((rng.uniform(-200, 200, (B, 2, H, W))).astype(np.float32))
    return flow_field(rng, B, H, W, {"amp1.5": 1.5, "amp12": 12.0}[kind])


PROJ_SHAPES = [(45, 97), (45, 1100), (1100, 40)]  # W or H past 1024: 2 summary words


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["amp1.5", "amp12", "pm200", "all_invalid"])
@pytest.mark.parametrize("H,W", PROJ_SHAPES)
@pytest.mark.parametrize("B", [1, 2, 3])
def test_projection_sums_stage_matches_plain(rng, dev, dtype, kind, H, W, B):
    """K2 (memset, scatter, fold-and-divide): counts and masks exact, the
    float32 average within 1e-3 (the atomics' order)."""
    flow = projection_flow(rng, B, H, W, kind).to(dev, dtype)
    S, avg, masks = P.launch_sums(flow, True)
    S_ref, avg_ref, masks_ref = P.sums_stage_reference(flow, True)
    assert torch.equal(S[:, 2], S_ref[:, 2])
    assert torch.equal(P.fold(S)[:, 2], P.fold(S_ref)[:, 2])
    for m, r in zip(masks, masks_ref):
        assert torch.equal(m, r)
    assert float((avg - avg_ref).abs().max()) <= 1e-3
    if kind == "all_invalid":
        assert not bool(avg.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("density", [0.1, 0.6, 0.0])
@pytest.mark.parametrize("W", [97, 1100])
def test_fill_stage_matches_plain(rng, dev, dtype, density, W):
    B, H = 2, 45
    cnt = torch.from_numpy((rng.rand(B, H, W) < density).astype(np.float32)).to(dev)
    avg = torch.from_numpy(rng.randn(B, 2, H, W).astype(np.float32)).to(dev) * (cnt > 0)[:, None]
    masks = P.pack_masks(cnt > 0)
    close_projection(P.launch_fill(avg, masks, dtype), P.fill_stage_reference(avg, masks, dtype))


def close_projection(got, ref):
    """float32 within 1e-3 (the atomics' order); bf16 within 2 ulps of each
    plain value."""
    assert got.dtype == ref.dtype
    if ref.dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-3
    else:
        close(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fillhole", [True, False])
@pytest.mark.parametrize("kind", ["amp1.5", "amp12", "pm200", "all_invalid"])
@pytest.mark.parametrize("H,W", PROJ_SHAPES)
@pytest.mark.parametrize("B", [1, 2, 3])
def test_flow_project_matches_plain(rng, dev, dtype, fillhole, kind, H, W, B):
    flow = projection_flow(rng, B, H, W, kind).to(dev, dtype)
    K.reset_counters()
    got = TP.flow_project(flow, fillhole=fillhole)
    counts = K.launch_counts()
    assert counts["base_scatter"] == 1 and counts["fill_holes"] == int(fillhole)
    close_projection(got, TP.reference(flow, fillhole=fillhole))
    if kind == "all_invalid":
        assert not bool(got.any())


@pytest.mark.parametrize("fillhole,most", [(True, 4), (False, 3)])
def test_flow_project_device_launches(rng, dev, fillhole, most):
    flow = projection_flow(rng, 2, 96, 160, "amp12").to(dev, torch.bfloat16)
    n, _, _ = device_ops(lambda: TP.flow_project(flow, fillhole=fillhole))
    assert 0 < n <= most


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,O,k,bias", [(3, 64, 7, False), (6, 40, 3, True), (8, 16, 5, True),
                                        (64, 32, 7, True), (32, 16, 7, True), (16, 2, 7, False),
                                        (20, 24, 3, True)])
def test_conv_kernel_matches_plain(rng, dev, dtype, C, O, k, bias):
    """C > 8 takes K4's channel-chunked paths (float32: chunks of 8, a ragged
    last one for C = 20; bf16: 16-channel chunks, C = 20 padded to 32);
    SPyNet's shapes are the 7x7 ones."""
    x = torch.from_numpy(rng.randn(2, C, 33, 70).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.randn(O, C, k, k) * 0.1).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(rng.randn(O).astype(np.float32)).to(dev) if bias else None
    close(conv_kernel.launch(x, w, b, relu=bias), conv_kernel.reference(x, w, b, relu=bias),
          long_sums=C > 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [3, 5, 7])
@pytest.mark.parametrize("O", [2, 16, 32, 64])
@pytest.mark.parametrize("C", [3, 8, 16, 32, 64])
def test_conv_kernel_tiling_cases(rng, dev, dtype, C, O, K):
    """Every tiling case of K4: C = 3 (4 taps per 16-deep bf16 step), 8 (2
    taps), 16-64 (16-channel chunks); O padded to 16, 32 or 64; B = 2; H and W
    not multiples of the bf16 tile (16 wide, 16 or 32 tall) or of the 64 x 8
    float32 one; W alternately a multiple of 8 (16-byte stores) and odd."""
    H, W = (37, 72) if (C + O + K) % 2 else (33, 71)
    x = torch.from_numpy(rng.randn(2, C, H, W).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32))
    w = w.to(dev, dtype)
    b = torch.from_numpy(rng.randn(O).astype(np.float32) * 0.1).to(dev)
    relu = O != 2
    close(conv_kernel.launch(x, w, b, relu=relu), conv_kernel.reference(x, w, b, relu=relu),
          long_sums=C > 8)


def sample_grid(rng, B, Ho, Wo, H, W, scale):
    gy, gx = np.meshgrid(np.linspace(-1, 1, Ho), np.linspace(-1, 1, Wo), indexing="ij")
    g = np.stack([gx, gy], -1)[None].repeat(B, 0) + rng.randn(B, Ho, Wo, 2) * scale / W
    g[:, :3, :5] = 40.0  # far outside: every tap zero
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ho,Wo,scale", [(37, 150, 3.0), (37, 150, 80.0), (20, 61, 2.0)])
def test_grid_sample_kernel_matches_plain(rng, dev, dtype, Ho, Wo, scale):
    B, C, H, W = 2, 3, 37, 150
    x = torch.from_numpy(rng.rand(B, C, H, W).astype(np.float32)).to(dev, dtype)
    g = sample_grid(rng, B, Ho, Wo, H, W, scale).to(dev)
    got = gather_kernel.launch(x, g)
    close(got, gather_kernel.reference(x, g))
    if dtype == torch.float32:
        lib = torch.nn.functional.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                                              align_corners=True)
        assert float((got - lib).abs().max()) <= 1e-5


def level_case(rng, dev, dtype, H, W, amp=60.0, B=2):
    """fst, snd (B, 3, H, W) and a coarse flow of up to ``amp`` px with an
    out-of-frame block, on the card in ``dtype``."""
    fst, snd = (torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32)).to(dev, dtype)
                for _ in range(2))
    return fst, snd, flow_field(rng, B, H // 2, W // 2, amp).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(768, 1344), (74, 100), (25, 45)])
@pytest.mark.parametrize("amp", [3.0, 60.0])
def test_level_input_kernel_matches_plain(rng, dev, dtype, H, W, amp):
    """SPyNet's fused level input: fst and the upsampled flow equal the plain
    composition's bit for bit; the warp equals the plain grid sample of the
    kernel's own up within 2 bf16 ulps, or 1e-5 in float32."""
    fst, snd, flow = level_case(rng, dev, dtype, H, W, amp)
    got = gather_kernel.launch_level_input(fst, snd, flow)
    ref = gather_kernel.level_input_reference(fst, snd, flow)
    assert got.shape == (2, 8, H, W) and got.dtype == dtype
    assert torch.equal(got[:, :3], ref[:, :3])
    assert torch.equal(got[:, 6:], ref[:, 6:])
    want = gather_kernel.reference(snd, gather_kernel.warp_grid(got[:, 6:8]))
    if dtype == torch.float32:
        assert float((got[:, 3:6] - want).abs().max()) <= 1e-5
    else:
        close(got[:, 3:6], want)
    assert device_ops(lambda: gather_kernel.launch_level_input(fst, snd, flow))[0] == 1


def test_level_input_gradients_match_plain(rng, dev):
    fst, snd, flow = (a.requires_grad_() for a in level_case(rng, dev, torch.float32, 25, 45, 3.0))
    ct = torch.randn(2, 8, 25, 45, device=dev)
    (gather_kernel.level_input(fst, snd, flow) * ct).sum().backward()
    xs = [a.detach().requires_grad_() for a in (fst, snd, flow)]
    (gather_kernel.level_input_reference(*xs) * ct).sum().backward()
    for a, c in zip((fst, snd, flow), xs):  # the grid sample's backward adds by atomics
        assert float((a.grad - c.grad).abs().max()) <= ATOL


def test_level_input_refuses_what_the_kernel_does_not_take(rng, dev):
    fst, snd, flow = level_case(rng, dev, torch.float32, 24, 40)
    with pytest.raises(ValueError, match="flow"):
        gather_kernel.level_input(fst, snd, flow[:, :, :11])
    with pytest.raises(TypeError, match="one type"):
        gather_kernel.level_input(fst, snd, flow.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        gather_kernel.level_input(fst, snd.cpu(), flow)
    with pytest.raises(ValueError, match="contiguous"):
        gather_kernel.level_input(fst, snd, flow.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError):
        gather_kernel.level_input(*(a.half() for a in (fst, snd, flow)))


def test_spynet_forward_launches_k5_once_per_level(rng, dev):
    """At 74x100 SPyNet runs three levels (18x25, 37x50, 74x100): one K5
    launch and five K4 launches each, and matches the CPU path."""
    from memcnet_tpu_torch.models import spynet

    net = spynet.SPyNet()
    net.init_params(torch.Generator().manual_seed(3))
    first = torch.from_numpy(rng.rand(2, 3, 74, 100).astype(np.float32))
    second = torch.roll(first, (1, 2), dims=(2, 3))
    with torch.no_grad():
        ref = net(first, second)
        net.to(dev)
        K.reset_counters()
        got = net(first.to(dev), second.to(dev))
    counts = K.launch_counts()
    assert counts["grid_sample"] == 3 and counts["conv2d_small"] == 15
    assert float((got.cpu() - ref).abs().max()) <= 1e-3 * max(1.0, float(ref.abs().max()))


def test_kernel_gradients_match_plain(rng, dev):
    B, H, W = 1, 24, 40
    img = torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32)).to(dev).requires_grad_()
    flow = flow_field(rng, B, H, W, 4.0).to(dev).requires_grad_()
    filt = torch.from_numpy(rng.rand(B, 16, H, W).astype(np.float32)).to(dev).requires_grad_()
    ct = torch.randn(B, 3, H, W, device=dev)
    (warp_kernel.warp((img,), flow, filt)[0] * ct).sum().backward()
    got = [x.grad.clone() for x in (img, flow, filt)]
    xs = [x.detach().cpu().requires_grad_() for x in (img, flow, filt)]
    (warp_kernel.reference((xs[0],), xs[1], xs[2])[0] * ct.cpu()).sum().backward()
    for g, x in zip(got, xs):
        assert float((g.cpu() - x.grad).abs().max()) <= ATOL

    f = flow_field(rng, 1, H, W, 3.0).to(dev).requires_grad_()
    ctf = torch.randn(1, 2, H, W, device=dev)
    (TP.flow_project(f, fillhole=True) * ctf).sum().backward()
    fc = f.detach().cpu().requires_grad_()
    (TP.flow_project(fc, fillhole=True) * ctf.cpu()).sum().backward()
    assert float((f.grad.cpu() - fc.grad).abs().max()) <= ATOL

    x = torch.from_numpy(rng.rand(1, 3, H, W).astype(np.float32)).to(dev).requires_grad_()
    g = sample_grid(rng, 1, H, W, H, W, 3.0).to(dev).requires_grad_()
    ctg = torch.randn(1, 3, H, W, device=dev)
    (gather_kernel.grid_sample(x, g) * ctg).sum().backward()
    xs = [a.detach().cpu().requires_grad_() for a in (x, g)]
    (gather_kernel.reference(*xs) * ctg.cpu()).sum().backward()
    for a, c in zip((x, g), xs):
        assert float((a.grad.cpu() - c.grad).abs().max()) <= ATOL


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 3, 8, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv_kernel.launch(x, torch.zeros(4, 3, 3, 3, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        warp_kernel.launch((x.float(),), torch.zeros(1, 2, 8, 8, device=dev),
                           torch.zeros(1, 9, 8, 8, device=dev), 3)
    with pytest.raises(TypeError):
        TP.flow_project(torch.zeros(1, 2, 8, 8, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="fix_down_scan_bug"):
        TP.flow_project(torch.zeros(1, 2, 8, 8, device=dev), fillhole=True,
                        fix_down_scan_bug=True)


def test_served_path_launches_every_kernel_and_matches_cpu(rng, dev):
    a = rng.rand(3, 60, 90).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    ref, _ = PaddedInterp(build_model(seed=1, device="cpu"), device="cpu")(a, b)
    K.reset_counters()
    got, _ = PaddedInterp(build_model(seed=1, device=dev), device=dev)(a, b)
    assert K.launch_counts() == {"filter_interp_warp": 2, "base_scatter": 1,
                                 "fill_holes": 1, "conv2d_small": 1, "grid_sample": 0}
    assert float(np.abs(got - ref).max()) <= 1e-3


def offset_spynet(model):
    """Scale SPyNet's last convs and give them a constant bias: the three
    levels of a 128x128 input then sum to a flow near (0.7, 0.42) px, far from
    the cell boundaries where card and CPU could land in different cells."""
    with torch.no_grad():
        for basic in model.flownets.moduleBasic:
            last = basic.moduleBasic[8]
            last.weight.mul_(0.02)
            last.bias.copy_(torch.tensor([0.1, 0.06]))
    return model


def test_memc_s_served_path_launches_its_kernels_and_matches_cpu(rng, dev):
    """MEMC_Net_s at 128x128 (padded from 60x90): SPyNet runs three levels,
    so K4 launches 15 times and K5 3 times."""
    a = rng.rand(3, 60, 90).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    models = [offset_spynet(build_model("MEMC_Net_s", seed=1, device=d)) for d in ("cpu", dev)]
    ref, _ = PaddedInterp(models[0], device="cpu")(a, b)
    K.reset_counters()
    got, _ = PaddedInterp(models[1], device=dev)(a, b)
    assert K.launch_counts() == {"filter_interp_warp": 2, "base_scatter": 1,
                                 "fill_holes": 1, "conv2d_small": 15, "grid_sample": 3}
    assert np.isfinite(got).all() and got.shape == (3, 60, 90)
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_ve_served_path_launches_its_kernels_and_matches_cpu(rng, dev):
    """MEMC_Net_VE at 128x128 (padded from 40x100): one split warp and one
    ctx conv per window, no projection; within 1e-3 of the output's scale of
    the CPU path (random kaiming weights put it in the thousands)."""
    base = rng.rand(3, 60, 120).astype(np.float32)
    frames = [np.ascontiguousarray(base[:, 10 + d:50 + d, 10 + 2 * d:110 + 2 * d])
              for d in range(-3, 4)]
    ref = PaddedVE(build_model("MEMC_Net_VE", seed=1, device="cpu"), device="cpu")(frames)
    K.reset_counters()
    got = PaddedVE(build_model("MEMC_Net_VE", seed=1, device=dev), device=dev)(frames)
    assert K.launch_counts() == {"filter_interp_warp": 1, "base_scatter": 0,
                                 "fill_holes": 0, "conv2d_small": 1, "grid_sample": 0}
    assert np.isfinite(got).all() and got.shape == (3, 40, 100)
    assert float(np.abs(got - ref).max()) <= 1e-3 * max(1.0, float(np.abs(ref).max()))


def assert_levels_close(got, want):
    """uint8 outputs of the card and the CPU: within 1 level, unequal on at
    most 0.5% of values (float32 sums in another order may flip a rounding)."""
    most, share = probe.levels_apart(got, want)
    assert most <= 1 and share <= 0.005, (most, share)


def run_demo(main, args, device):
    """One demo run on ``device``; the launch counts of that run."""
    K.reset_counters()
    result = main(args + ["--device", device])
    return result, K.launch_counts()


def test_hd720p_demo_launches_its_kernels_and_matches_cpu(dev, tmp_path):
    """MEMC_Net_star over a 5-frame 64x128 stream, 2 pairs: 2 K1, 1 K2, 1 K3
    and 1 K4 a pair; ground truth in the output stream byte-equal, the
    reconstructions within 1 level of the CPU run's."""
    src = probe.write_yuv(str(tmp_path / "in.yuv"), probe.moving_frames(0, 5, 64, 128))
    streams = {}
    for d in ("cpu", "cuda"):
        _, counts = run_demo(demo_hd720p.main, [
            "--yuv", src, "--height", "64", "--width", "128", "--frames", "4",
            "--out-dir", str(tmp_path / d), "--net-name", "MEMC_Net_star", "--uid", "u"], d)
        streams[d] = np.fromfile(str(tmp_path / d / "u" / "in.yuv"), np.uint8).reshape(4, -1)
    assert counts == {"filter_interp_warp": 4, "base_scatter": 2, "fill_holes": 2,
                      "conv2d_small": 2, "grid_sample": 0}
    np.testing.assert_array_equal(streams["cuda"][0::2], streams["cpu"][0::2])
    assert_levels_close(streams["cuda"][1::2], streams["cpu"][1::2])


def test_middlebury_demo_memc_s_launches_its_kernels_and_matches_cpu(dev, tmp_path):
    """MEMC_Net_s on two 64x96 sequences (padded to 128x128: SPyNet runs
    three levels, 15 K4 and 3 K5 launches a pair), weights offset as in
    offset_spynet and shared through one .pth."""
    data, gt = probe.write_middlebury(str(tmp_path / "mb"), ["A", "B"], 64, 96)
    pth = str(tmp_path / "s.pth")
    torch.save(offset_spynet(build_model("MEMC_Net_s", seed=1, device="cpu")).state_dict(), pth)
    outs = {}
    for d in ("cpu", "cuda"):
        out = tmp_path / d
        results, counts = run_demo(demo_middlebury.main, [
            "--data-dir", data, "--gt-dir", gt, "--out-dir", str(out),
            "--net-name", "MEMC_Net_s", "--pretrained", pth], d)
        (uid,) = out.iterdir()
        outs[d] = (results, [imread(str(uid / n / "frame10i11.png")) for n in ("A", "B")])
    assert counts == {"filter_interp_warp": 4, "base_scatter": 2, "fill_holes": 2,
                      "conv2d_small": 30, "grid_sample": 6}
    for (_, ie, _), (_, ie_cpu, _) in zip(outs["cuda"][0], outs["cpu"][0]):
        assert abs(ie - ie_cpu) <= 0.01
    for got, want in zip(outs["cuda"][1], outs["cpu"][1]):
        assert_levels_close(got, want)


def test_vimeo_ve_demo_launches_its_kernels_and_matches_cpu(dev, tmp_path):
    """MEMC_Net_VE on one 64x96 septuplet: 1 K1 and 1 K4 a window.  The .pth
    scales the rectifier's last conv by 1e-3, so the output is not all 0 or
    255 (random kaiming EDSR outputs are in the thousands)."""
    root = probe.write_vimeo(str(tmp_path / "vimeo"), 1, 64, 96)
    model = build_model("MEMC_Net_VE", seed=1, device="cpu")
    with torch.no_grad():
        model.rectifyNet.tail[0].weight.mul_(1e-3)
    pth = str(tmp_path / "ve.pth")
    torch.save(model.state_dict(), pth)
    recs = {}
    for d in ("cpu", "cuda"):
        _, counts = run_demo(demo_vimeo_ve.main, [
            "--root", root, "--out-dir", str(tmp_path / d), "--task", "denoise",
            "--pretrained", pth], d)
        recs[d] = imread(str(tmp_path / d / "00001" / "0001" / "im4.png"))
    assert counts == {"filter_interp_warp": 1, "base_scatter": 0, "fill_holes": 0,
                      "conv2d_small": 1, "grid_sample": 0}
    assert_levels_close(recs["cuda"], recs["cpu"])


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_native_unfilter_matches_plain(dev, tmp_path, ch):
    """csrc/png.cu's host unfilter against the plain Python one, on rows of
    each filter type and on an adaptively filtered file; a bad filter type
    raises."""
    from memcnet_tpu_torch.io import png
    from memcnet_tpu_torch.ops.cuda import _lib

    assert _lib.nvcc_path() is not None  # imread takes the C unfilter here
    frame = probe.moving_frames(ch, 1, 37, 53)[0]
    img = frame[..., 0] if ch == 1 else (
        frame if ch == 3 else np.concatenate([frame, frame[..., :1]], axis=2))
    flat = img.reshape(37, 53 * ch)
    each = png.filter_rows(flat, ch)
    for kinds in [np.full(37, t) for t in range(5)] + [np.arange(37) % 5]:
        rows = np.concatenate([kinds[:, None].astype(np.uint8), each[kinds, np.arange(37)]], 1)
        raw = rows.tobytes()
        got = png.unfilter(raw, 37, 53 * ch, ch)
        np.testing.assert_array_equal(got, flat)
        np.testing.assert_array_equal(got, png.unfilter_plain(raw, 37, 53 * ch, ch))
    path = str(tmp_path / "a.png")
    png.imwrite(path, img, adaptive=True)
    np.testing.assert_array_equal(png.imread(path), img)
    rows[5, 0] = 9
    with pytest.raises(ValueError, match="row 5 has unknown filter type 9"):
        png.unfilter(rows.tobytes(), 37, 53 * ch, ch)
