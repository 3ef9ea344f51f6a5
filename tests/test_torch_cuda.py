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
order over sums of up to ~10 flows of up to 200 px); K4's float32 body
(three TF32 passes) within 5e-4 of its plain version, chip_smoke.py's rule
at SPyNet's sums; K4's bf16 body bit for bit against its earlier outputs.
"""

import numpy as np
import pytest
import torch

from memcnet_tpu_torch import ops, probe
from memcnet_tpu_torch.cli import demo_hd720p, demo_middlebury, demo_vimeo_ve
from memcnet_tpu_torch.cli.runner import PaddedInterp, PaddedVE, build_model
from memcnet_tpu_torch.io.png import imread
from memcnet_tpu_torch.ops import cuda as K
from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops.cuda import conv_kernel, gather_kernel, warp_kernel
from memcnet_tpu_torch.ops.cuda import project_kernel as P
from memcnet_tpu_torch.probe import device_ops, graph_ops

pytestmark = pytest.mark.cuda
ATOL = 1e-4
# the tile entries of parallel/tiling.py launch on no untiled path
NO_TILE_ENTRIES = {"filter_interp_warp_tile": 0, "base_scatter_tile": 0, "fill_holes_carry": 0,
                   "level_input_tile": 0,
                   "base_scatter_payload_tile": 0}
# K4 launches of the spec walkers (models/mononet.py) in a float32 forward, one
# for each 3x3 conv: star's two full MonoNet5 trunks (2 x 23) and four branches
# (4 x 2); MEMC_Net's the same and the RectifyNet (8); MEMC_Net_s's thin trunk
# (12), two filter branches (2 x 2) and RectifyNet (8); VE's full trunk and one
# branch.  In bf16, and in a forward autograd records (a train step), the
# walkers launch no K4.
WALKER_K4 = {"MEMC_Net_star": 54, "MEMC_Net": 62, "MEMC_Net_s": 24, "MEMC_Net_VE": 25}


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


@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("density", [0.1, 0.6, 0.0])
@pytest.mark.parametrize("W", [97, 1100])
def test_fill_hole_count_matches_plain(rng, dev, down, dtype, density, W):
    """K3's count of pixels with no projected value (the tracer's holes)
    equals the plain count, adds up over launches and leaves the fill as it
    is without it."""
    B, H = 2, 45
    cnt = torch.from_numpy((rng.rand(B, H, W) < density).astype(np.float32)).to(dev)
    avg = torch.from_numpy(rng.randn(B, 2, H, W).astype(np.float32)).to(dev) * (cnt > 0)[:, None]
    masks = P.pack_masks(cnt > 0)
    holes = torch.zeros((), dtype=torch.int64, device=dev)
    got = P.launch_fill(avg, masks, dtype, down=down, holes=holes)
    P.launch_fill(avg, masks, dtype, down=down, holes=holes)
    assert int(holes) == 2 * int((cnt == 0).sum())
    assert torch.equal(got, P.launch_fill(avg, masks, dtype, down=down))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["amp12", "pm200", "all_invalid"])
def test_flow_project_counters_match_the_plain_path(rng, dev, dtype, kind):
    """Inside a span under the profiler, K2's sum of |flow| and K3's hole
    count equal the plain version's on the CPU, and add up over calls."""
    from torch.profiler import ProfilerActivity, profile

    from memcnet_tpu_torch.utils import tracing

    flow = projection_flow(rng, 2, 96, 160, kind).to(dtype)
    counts = []
    for f in (flow, flow.to(dev)):
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]), tracing.span("project", f):
            TP.flow_project(f, fillhole=True)
            TP.flow_project(f, fillhole=True)
        counts.append(tracing.snapshot()["counters"])
    tracing.reset()
    cpu, card = counts
    assert cpu["holes"] == card["holes"] and cpu["holes"]["total"] == 2 * 2 * 96 * 160
    assert cpu["holes"]["value"] > 0
    assert card["flow_px"]["total"] == cpu["flow_px"]["total"] == 2 * 2 * 96 * 160
    assert card["flow_px"]["value"] == pytest.approx(cpu["flow_px"]["value"], rel=1e-5)


@pytest.mark.parametrize("name", ["MEMC_Net_s", "MEMC_Net_star"])
def test_stage_spans_time_the_card(dev, name):
    """Under the profiler every span has device ms from its events, the
    stages' sum within the forward's, and each forward its allocator calls."""
    from torch.profiler import ProfilerActivity, profile

    from memcnet_tpu_torch.utils import tracing

    model = build_model(name, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x0, x2 = (torch.rand(2, 3, 128, 256, device=dev, generator=g) for _ in range(2))
    with torch.inference_mode():
        model(x0, x2)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x0, x2)
    # the ranges stay on the host: no device event of their name
    assert not [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(tracing.PREFIX)]
    snap = tracing.snapshot()
    tracing.reset()
    spans = snap["spans"]
    assert snap["forwards"] == 3 and len(spans) == (8 if name == "MEMC_Net_star" else 7)
    for s in spans.values():
        assert s["calls"] == 3 and s["device_ms"] > 0.0
    stages = sum(s["device_ms"] for n, s in spans.items() if n != "memc.forward")
    assert stages <= spans["memc.forward"]["device_ms"] * 1.0001
    assert snap["counters"]["cuda_allocs"]["total"] == 3
    assert snap["counters"]["holes"]["total"] == 3 * 2 * 2 * 128 * 256


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
    with pytest.raises(ValueError, match="project_payload"):  # N7 takes a one-plane depth
        P.payload_project("depth", torch.zeros(1, 2, 8, 8, device=dev),
                          (torch.zeros(1, 3, 8, 8, device=dev),))
    with pytest.raises(ValueError, match="project_payload"):  # N8 takes two frames
        P.payload_project("gated", torch.zeros(1, 2, 8, 8, device=dev),
                          (torch.zeros(1, 3, 8, 8, device=dev),), 0.1)


# ---------------------------------------------------------------- the op library (N2-N11)


def payload_inputs(rng, op, B, H, W, dev, dtype):
    """N7's depth (quarters: its sums exact in any order) or N8's frames
    (frame2 within about 0.1 of frame1, so the gate passes some and fails
    others), in ``dtype``."""
    if op == "depth":
        depth = rng.randint(1, 8, (B, 1, H, W)) * 0.25
        return (torch.from_numpy(depth.astype(np.float32)).to(dev, dtype),)
    f1 = rng.rand(B, 3, H, W).astype(np.float32)
    f2 = np.clip(f1 + rng.randn(B, 3, H, W).astype(np.float32) * 0.1, 0.0, 1.0)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in (f1, f2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["depth", "gated"])
@pytest.mark.parametrize("fillhole", [True, False])
@pytest.mark.parametrize("kind", ["amp12", "pm200", "all_invalid"])
@pytest.mark.parametrize("H,W", PROJ_SHAPES)
def test_payload_entry_matches_plain(rng, dev, dtype, op, fillhole, kind, H, W):
    """K2's payload entry, the payload built inside it: the last plane of S
    (N7's depth sums in quarters, N8's count of gated pixels: every gate
    decision), base and folded, and the masks exact, the result within 1e-3
    (float32) or 2 ulps (bf16), the extra plane likewise."""
    B = 2
    flow = projection_flow(rng, B, H, W, kind).to(dev, dtype)
    ins = payload_inputs(rng, op, B, H, W, dev, dtype)
    S, out, extra, masks = P.launch_payload(op, flow, ins, 0.1, fillhole)
    S_ref, out_ref, extra_ref, masks_ref = P.op_stage_reference(op, flow, ins, 0.1, fillhole)
    assert torch.equal(S[:, -1], S_ref[:, -1])
    assert torch.equal(P.fold(S)[:, -1], P.fold(S_ref)[:, -1])
    if fillhole:
        for m, r in zip(masks, masks_ref):
            assert torch.equal(m, r)
    close_projection(out, out_ref)
    assert (extra is None) == (op == "depth")
    if extra is not None:
        close_projection(extra, extra_ref)


def test_gate_at_the_threshold_matches_plain(rng, dev):
    """N8's gate on the card at err exactly the threshold (in) and one
    float32 ulp below it (out), bf16 and float32 frames."""
    B, H, W = 2, 45, 97
    flow = projection_flow(rng, B, H, W, "amp12").to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        ins = payload_inputs(rng, "gated", B, H, W, dev, dtype)
        err = P.brightness_error(flow, *ins)
        at = float(err[1, 20, 30])
        for threshold in (at, float(np.nextafter(np.float32(at), np.float32(0)))):
            S, *_ = P.launch_payload("gated", flow, ins, threshold, False)
            S_ref, *_ = P.op_stage_reference("gated", flow, ins, threshold, False)
            assert torch.equal(S[:, -1], S_ref[:, -1]), (dtype, threshold)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("density", [0.1, 0.6, 0.0])
@pytest.mark.parametrize("H,W", [(45, 97), (1100, 40)])
def test_fill_stage_down_search_matches_plain(rng, dev, dtype, density, H, W):
    B = 2
    cnt = torch.from_numpy((rng.rand(B, H, W) < density).astype(np.float32)).to(dev)
    avg = torch.from_numpy(rng.randn(B, 2, H, W).astype(np.float32)).to(dev) * (cnt > 0)[:, None]
    masks = P.pack_masks(cnt > 0)
    close_projection(P.launch_fill(avg, masks, dtype, down=True),
                     P.fill_stage_reference(avg, masks, dtype, down=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["amp12", "pm200"])
def test_flow_project_down_scan_on_the_card(rng, dev, dtype, kind):
    flow = projection_flow(rng, 2, 45, 1100, kind).to(dev, dtype)
    K.reset_counters()
    got = TP.flow_project(flow, fillhole=True, fix_down_scan_bug=True)
    assert K.launch_counts()["base_scatter"] == 1 and K.launch_counts()["fill_holes"] == 1
    close_projection(got, TP.reference(flow, fillhole=True, fix_down_scan_bug=True))


def op_library_calls(rng, B=2, H=40, W=72, amp=4.0):
    """Each op of the library with seeded inputs, flows of about ``amp`` px:
    (name, fn, inputs, which inputs take a gradient)."""
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.rand(*shape) * scale).astype(np.float32))

    flow = flow_field(rng, B, H, W, amp)
    f1 = r(B, 3, H, W)
    f2 = (f1 + torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32)) * 0.05).clamp(0, 1)
    fs = 5
    vh = [torch.from_numpy(rng.randn(B, fs, H - fs + 1, W - fs + 1).astype(np.float32))
          for _ in range(2)]
    kern = [r(B, fs, H - fs + 1, W - fs + 1) for _ in range(2)]  # sums away from 0
    kern[0][0, :, 3, 4] = 0.0  # the sentinel
    return [
        ("bilinear_warp", ops.bilinear_warp, [f1, flow], [True, True]),
        ("bilinear_warp_ch", ops.bilinear_warp_ch, [r(B, 6, H, W), flow], [True, True]),
        ("flow_project_down", lambda f: ops.flow_project(f, fillhole=True,
                                                         fix_down_scan_bug=True), [flow], [True]),
        ("depth_flow_project", lambda f, d: ops.depth_flow_project(f, d, fillhole=True),
         [flow, r(B, 1, H, W) + 0.5], [True, True]),
        ("depth_flow_project_nofill", ops.depth_flow_project, [flow, r(B, 1, H, W) + 0.5],
         [True, True]),
        ("weighted_flow_project", lambda f, a, b: ops.weighted_flow_project(f, a, b,
                                                                             fillhole=True),
         [flow, f1, f2], [True, True, True]),
        ("separable_conv", ops.separable_conv, [f1, *vh], [True, True, True]),
        ("separable_conv_flow", ops.separable_conv_flow, kern, [True, True]),
        ("occlusion_weight", ops.occlusion_weight, [f1, f2, flow], [True, True, True]),
        ("pixel_splat", ops.pixel_splat, [f1, flow, r(B, 1, H, W)], [True, True, True]),
        ("pixel_value", ops.pixel_value, [f1, flow, r(B, 1, H, W)], [True, True, True]),
        ("pixel_weight", ops.pixel_weight, [flow, r(B, 1, H, W)], [True, True]),
        ("reliable_weight", ops.reliable_weight, [flow], [True]),
    ]


def test_gate_error_on_the_card_equals_the_cpu_bit_for_bit(rng, dev):
    """The gated projection's err decides its gate at the threshold, so the
    card computes it in the CPU's (and the JAX package's) float32 order."""
    B, H, W = 2, 64, 96
    flow = flow_field(rng, B, H, W, 6.0)
    f1, f2 = (torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32)) for _ in range(2))
    got = P.brightness_error(flow.to(dev), f1.to(dev), f2.to(dev)).cpu()
    assert torch.equal(got, P.brightness_error(flow, f1, f2))


def test_op_library_on_the_card_matches_cpu(rng, dev):
    """Every op on CUDA tensors against the same op on CPU tensors, forward
    and a VJP with a seeded cotangent, within 1e-4 of each output's scale
    (float atomics and index_add in a run-dependent order); N7 and N8 launch
    one K2 and, with the fill, one K3 per call."""
    for name, fn, inputs, grads in op_library_calls(rng):
        outs = {}
        for where in ("cuda", "cpu"):
            xs = [x.to(where).requires_grad_(g) for x, g in zip(inputs, grads)]
            K.reset_counters()
            out = fn(*xs)
            out = out if isinstance(out, tuple) else (out,)
            counts = K.launch_counts()
            cts = [torch.from_numpy(np.random.RandomState(1).randn(*o.shape).astype(np.float32))
                   .to(where) for o in out]
            gs = torch.autograd.grad(out, [x for x, g in zip(xs, grads) if g], cts)
            outs[where] = ([o.detach().cpu() for o in out], [g.cpu() for g in gs])
            if where == "cuda" and "project" in name:
                fills = 0 if name.endswith("nofill") else 1
                assert counts["base_scatter"] == 1 and counts["fill_holes"] == fills, name
        for a, b in zip(outs["cuda"][0] + outs["cuda"][1], outs["cpu"][0] + outs["cpu"][1]):
            tol = ATOL * max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol, name


def test_served_path_launches_every_kernel_and_matches_cpu(rng, dev):
    a = rng.rand(3, 60, 90).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    ref, _ = PaddedInterp(build_model(seed=1, device="cpu"), device="cpu")(a, b)
    K.reset_counters()
    got, _ = PaddedInterp(build_model(seed=1, device=dev), device=dev)(a, b)
    assert K.launch_counts() == {"filter_interp_warp": 2, "base_scatter": 1,
                                 "fill_holes": 1,
                                 "conv2d_small": 1 + WALKER_K4["MEMC_Net_star"],
                                 "grid_sample": 0, **NO_TILE_ENTRIES}
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_memc_net_float32_served_path_runs_its_walkers_on_k4_and_matches_cpu(rng, dev):
    """MEMC_Net in float32 at 128x128 (padded from 60x90): its dual MonoNet5
    trunks, four branches and RectifyNet run every 3x3 conv on K4's float32
    body (62 launches, FlowNetS none); the output within 1e-3 of the CPU
    path's, as its siblings'."""
    a = rng.rand(3, 60, 90).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    ref, _ = PaddedInterp(build_model("MEMC_Net", seed=1, device="cpu"), device="cpu")(a, b)
    K.reset_counters()
    got, _ = PaddedInterp(build_model("MEMC_Net", seed=1, device=dev), device=dev)(a, b)
    assert K.launch_counts() == {"filter_interp_warp": 2, "base_scatter": 1,
                                 "fill_holes": 1, "conv2d_small": WALKER_K4["MEMC_Net"],
                                 "grid_sample": 0, **NO_TILE_ENTRIES}
    assert K.body_counts() == {"conv2d_small[float32]": WALKER_K4["MEMC_Net"]}
    assert np.isfinite(got).all() and got.shape == (3, 60, 90)
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
    so K4 launches 15 times there and K5 3 times; the walkers' convs add
    theirs."""
    a = rng.rand(3, 60, 90).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    models = [offset_spynet(build_model("MEMC_Net_s", seed=1, device=d)) for d in ("cpu", dev)]
    ref, _ = PaddedInterp(models[0], device="cpu")(a, b)
    K.reset_counters()
    got, _ = PaddedInterp(models[1], device=dev)(a, b)
    assert K.launch_counts() == {"filter_interp_warp": 2, "base_scatter": 1,
                                 "fill_holes": 1, "conv2d_small": 15 + WALKER_K4["MEMC_Net_s"],
                                 "grid_sample": 3, **NO_TILE_ENTRIES}
    assert np.isfinite(got).all() and got.shape == (3, 60, 90)
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_ve_served_path_launches_its_kernels_and_matches_cpu(rng, dev):
    """MEMC_Net_VE at 128x128 (padded from 40x100): one split warp and one
    ctx conv per window, no projection, and the walkers' float32 convs;
    within 1e-3 of the output's scale of the CPU path (random kaiming weights
    put it in the thousands)."""
    base = rng.rand(3, 60, 120).astype(np.float32)
    frames = [np.ascontiguousarray(base[:, 10 + d:50 + d, 10 + 2 * d:110 + 2 * d])
              for d in range(-3, 4)]
    ref = PaddedVE(build_model("MEMC_Net_VE", seed=1, device="cpu"), device="cpu")(frames)
    K.reset_counters()
    got = PaddedVE(build_model("MEMC_Net_VE", seed=1, device=dev), device=dev)(frames)
    assert K.launch_counts() == {"filter_interp_warp": 1, "base_scatter": 0,
                                 "fill_holes": 0, "conv2d_small": 1 + WALKER_K4["MEMC_Net_VE"],
                                 "grid_sample": 0, **NO_TILE_ENTRIES}
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
    """MEMC_Net_star in float32 over a 5-frame 64x128 stream, 2 pairs: 2 K1,
    1 K2, 1 K3 and 1 + 54 K4 a pair (the ctx conv, the walkers' convs);
    ground truth in the output stream byte-equal, the reconstructions within
    1 level of the CPU run's."""
    src = probe.write_yuv(str(tmp_path / "in.yuv"), probe.moving_frames(0, 5, 64, 128))
    streams = {}
    for d in ("cpu", "cuda"):
        _, counts = run_demo(demo_hd720p.main, [
            "--yuv", src, "--height", "64", "--width", "128", "--frames", "4",
            "--out-dir", str(tmp_path / d), "--net-name", "MEMC_Net_star", "--uid", "u"], d)
        streams[d] = np.fromfile(str(tmp_path / d / "u" / "in.yuv"), np.uint8).reshape(4, -1)
    assert counts == {"filter_interp_warp": 4, "base_scatter": 2, "fill_holes": 2,
                      "conv2d_small": 2 * (1 + WALKER_K4["MEMC_Net_star"]), "grid_sample": 0,
                      **NO_TILE_ENTRIES}
    np.testing.assert_array_equal(streams["cuda"][0::2], streams["cpu"][0::2])
    assert_levels_close(streams["cuda"][1::2], streams["cpu"][1::2])


def test_middlebury_demo_memc_s_launches_its_kernels_and_matches_cpu(dev, tmp_path):
    """MEMC_Net_s in float32 on two 64x96 sequences (padded to 128x128:
    SPyNet runs three levels, 15 K4 and 3 K5 launches a pair, and the
    walkers 24 K4), weights offset as in offset_spynet and shared through one
    .pth."""
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
                      "conv2d_small": 2 * (15 + WALKER_K4["MEMC_Net_s"]), "grid_sample": 6,
                      **NO_TILE_ENTRIES}
    for (_, ie, _), (_, ie_cpu, _) in zip(outs["cuda"][0], outs["cpu"][0]):
        assert abs(ie - ie_cpu) <= 0.01
    for got, want in zip(outs["cuda"][1], outs["cpu"][1]):
        assert_levels_close(got, want)


def test_vimeo_ve_demo_launches_its_kernels_and_matches_cpu(dev, tmp_path):
    """MEMC_Net_VE in float32 on one 64x96 septuplet: 1 K1 and 1 + 25 K4 a
    window (the ctx conv, the walkers' convs).  The .pth
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
                      "conv2d_small": 1 + WALKER_K4["MEMC_Net_VE"], "grid_sample": 0,
                      **NO_TILE_ENTRIES}
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


# ---------------------------------------------------------------- train steps

TRAIN_LAUNCHES = {  # per train step at 64x128: SPyNet has 3 levels there, no hole fill
    "MEMC_Net_star": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                      "conv2d_small": 1, "grid_sample": 0, **NO_TILE_ENTRIES},
    "MEMC_Net_s": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                   "conv2d_small": 15, "grid_sample": 3, **NO_TILE_ENTRIES},
    "MEMC_Net": {"filter_interp_warp": 2, "base_scatter": 1, "fill_holes": 0,
                 "conv2d_small": 0, "grid_sample": 0, **NO_TILE_ENTRIES},
    "MEMC_Net_VE": {"filter_interp_warp": 1, "base_scatter": 0, "fill_holes": 0,
                    "conv2d_small": 1, "grid_sample": 0, **NO_TILE_ENTRIES},
}


def train_step(name, device, lr=1e-4):
    from memcnet_tpu_torch import train as T

    model = build_model(name, seed=0, device=device)
    opt = T.make_optimizer(model, lr=lr, subnet_lr=True, plateau=True)
    make = T.make_ve_train_step if name == "MEMC_Net_VE" else T.make_interp_train_step
    return model, make(model, opt, device=device)


def train_inputs(rng, name, B=1):
    x0 = rng.rand(B, 3, 64, 128).astype(np.float32)
    x2 = np.roll(x0, (1, 2), axis=(2, 3)) * 0.9 + 0.05
    if name == "MEMC_Net_VE":
        window = [np.roll(x0, (k - 3, 2 * (k - 3)), axis=(2, 3)) for k in range(7)]
        return window, window[3] * 0.9 + 0.05
    return x0, (x0 + x2) / 2, x2


@pytest.mark.parametrize("name", sorted(TRAIN_LAUNCHES))
def test_train_step_launches_its_kernels(rng, dev, name):
    """Counted around the whole step (forward, backward, optimizer): the
    forward's kernels once each; the backward (autograd of the plain
    versions) and the optimizer launch none; no hole fill in training."""
    _, step = train_step(name, "cuda")
    args = train_inputs(rng, name)
    for _ in range(2):
        K.reset_counters()
        loss = step(*args)
        assert K.launch_counts() == TRAIN_LAUNCHES[name]
        assert np.isfinite(float(loss))


def test_train_step_on_card_matches_cpu(rng, dev):
    """One float32 MEMC_Net_star step at 2x 64x128 from the same weights and
    inputs: the loss within 1e-4 relative, each gradient within 1e-2 of the
    largest gradient magnitude in its subnet (float32 sums in other orders
    through ~100 layers; FlowNetS's deepest layers, at its 0.02 / n init, get
    gradients near float32 noise, so not of the tensor's own), the parameters
    after the update within 2 lr of the CPU's (Adamax's first update is about
    lr * sign(g)) and within 1e-6 on 99% of elements."""
    args = train_inputs(rng, "MEMC_Net_star", B=2)
    out = {}
    for device in ("cpu", "cuda"):
        model, step = train_step("MEMC_Net_star", device)
        loss = float(step(*args))
        out[device] = (loss, {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                              for k, p in model.named_parameters()},
                       {k: p.detach().cpu() for k, p in model.named_parameters()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    subnet_max = {}
    for k, g in gc.items():
        sub = k.split(".")[0]
        subnet_max[sub] = max(subnet_max.get(sub, 0.0), float(g.abs().max()))
    close_elems = total = 0
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-2 * subnet_max[k.split(".")[0]], k
        d = (pg[k] - pc[k]).abs()
        assert float(d.max()) <= 2e-4 * (1 + 1e-3), k
        close_elems += int((d <= 1e-6).sum())
        total += d.numel()
    assert close_elems >= 0.99 * total


def test_bf16_k4_reads_the_optimizer_update(rng, dev):
    """K4's bf16 packed weights are cached by (pointer, version): after an
    in-place optimizer update the next launch packs the new weights, so it
    matches the plain conv with the updated weights, not the old ones."""
    from memcnet_tpu_torch import train as T

    x = torch.from_numpy(rng.rand(2, 3, 64, 96).astype(np.float32)).to(dev, torch.bfloat16)
    w = (torch.from_numpy(rng.randn(64, 3, 7, 7).astype(np.float32)) * 0.1).to(
        dev, torch.bfloat16).requires_grad_()
    opt = T.make_optimizer({"ctxNet.conv1.weight": w}, lr=0.05)
    with torch.no_grad():
        before = conv_kernel.conv2d_small(x, w)
    w.grad = torch.ones_like(w)
    opt.step()
    with torch.no_grad():
        after = conv_kernel.conv2d_small(x, w)
    close(after, conv_kernel.reference(x, w.detach()), long_sums=True)
    assert not torch.equal(after, before)


# -- the tile entries of parallel/tiling.py ---------------------------------------------


def tile_grid(grid, dev):
    from memcnet_tpu_torch.parallel import make_mesh, make_mesh_2d

    devs = [torch.device(dev)] * 4
    return (make_mesh(4, devices=devs), None) if grid == "tile4" else \
        (make_mesh_2d(4, devices=devs), "tile_h")


def tile_flow(rng, kind, B, H, W, halo):
    """Flows within the halo budget: smooth, noisy up to the budget, or all
    landing below the frame."""
    if kind == "invalid":
        f = np.zeros((B, 2, H, W), np.float32)
        f[:, 1] = 3.0 * H
        return torch.from_numpy(f)
    amp = 6.0 if kind == "smooth" else float(halo - 6)
    f = flow_field(rng, B, H, W, amp).numpy()
    f[:, 0, :4, :6] = -(halo - 5)  # a corner landing left of the frame
    return torch.from_numpy(np.clip(f, -(halo - 5), halo - 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
@pytest.mark.parametrize("halo", [16, 32])
@pytest.mark.parametrize("kind", ["smooth", "noisy", "invalid"])
def test_tile_entries_match_their_plain_versions(rng, dev, dtype, grid, halo, kind):
    """K1's tile entry, K2's (counts exact) and K3's tile entry (masks from
    exact counts) against their plain versions on the tiles the tiled ops
    hand them, and the tiled ops against the global ones on the card."""
    from memcnet_tpu_torch.parallel import tiling as T

    mesh, axis_h = tile_grid(grid, dev)
    B, H, W = 2, 128, 256
    flow = tile_flow(rng, kind, B, H, W, halo).to(dev)
    frame = torch.rand(B, 3, H, W, device=dev).to(dtype)
    ctx = torch.randn(B, 5, H, W, device=dev).to(dtype)
    filt = (torch.rand(B, 16, H, W, device=dev) / 8).to(dtype)
    ring = T._ring(mesh, B, "tile", axis_h)
    Wl, Hl, hh = T._grid(mesh, frame.shape, "tile", axis_h, halo, None)
    exts = []
    for im in (frame, ctx):
        e = T._exchange_halo(ring.split(im), ring, "tile", halo, -1)
        exts.append(T._exchange_halo(e, ring, axis_h, hh, -2) if axis_h else e)
    org = T._origins(ring, "tile", axis_h, Wl, Hl, dev)
    fl, fi = ring.split(flow), ring.split(filt)
    geom = (halo, hh, 4, W, H)
    for g, r in zip(warp_kernel.launch_tile(exts, fl, fi, org, *geom),
                    warp_kernel.tile_reference(exts, fl, fi, org, *geom)):
        close(g, r)
    fd = ring.split(flow.to(dtype))
    got = P.launch_tile_sums(fd, org, halo, hh, W, H)
    ref = P.tile_sums_reference(fd, org, halo, hh, W, H)
    assert torch.equal(got[:, 2], ref[:, 2])
    assert float((got - ref).abs().max()) <= 1e-3
    avg, cnt, ring = T._tiled_average(mesh, flow.to(dtype), halo, "tile", axis_h, None)
    stacks = (ring.stacked("tile"), ring.stacked(axis_h) if axis_h else None)
    got, masks = P.launch_fill_tiles(avg, cnt, stacks, None, None, None, dtype, with_masks=True)
    assert torch.equal(got, T.tiled_fill_reference(avg, cnt, ring, "tile", axis_h, dtype))
    want = P.pack_masks(cnt > 0)
    assert torch.equal(masks.rows, want.rows) and torch.equal(masks.cols, want.cols)
    if kind == "invalid" and axis_h:
        return  # the vertical clamp moves these landings, by contract
    K.reset_counters()
    tw = T.tiled_filter_interp_warp_split(mesh, (frame, ctx), flow, filt, halo=halo,
                                          axis_h=axis_h)
    tp = T.tiled_flow_project(mesh, flow.to(dtype), halo=halo, fillhole=True, axis_h=axis_h)
    assert K.launch_counts() == {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                                 "conv2d_small": 0, "grid_sample": 0,
                                 "filter_interp_warp_tile": 1, "base_scatter_tile": 1,
                                 "fill_holes_carry": 1, "level_input_tile": 0,
                                 "base_scatter_payload_tile": 0}
    for g, r in zip(tw, ops.filter_interp_warp_split((frame, ctx), flow, filt)):
        close(g, r)
    close(tp, ops.flow_project(flow.to(dtype), fillhole=True), long_sums=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
@pytest.mark.parametrize("kind", ["sparse", "empty", "uneven", "dense", "nan", "wide"])
def test_tile_fill_entry_matches_plain(rng, dev, dtype, grid, kind):
    """K3's tile entry against the tiled fill's plain composition, bits and
    masks exact, on 70x84 tiles: sparse counts (rows empty in the next tile,
    so the carry comes from two tiles away, and rows empty in every tile,
    whose search stops at the frame's edge with no wraparound), no value at
    all, the last column and row of every tile empty (an owned width of 83
    of 84), dense counts, and the tiled average of a flow with NaNs; and
    sparse counts on 20x2100 tiles, whose 66-word rows are scanned word by
    word; the counts a strided view; with the carries given for every axis
    (across ranks) and for W alone; one launch and two device operations a
    call, counted as CUDA-graph nodes."""
    from memcnet_tpu_torch.parallel import tiling as T

    mesh, axis_h = tile_grid(grid, dev)
    ring = T._ring(mesh, 2, "tile", axis_h)
    n, H, W = (ring.n, 20, 2100) if kind == "wide" else (ring.n, 70, 84)
    if kind == "nan":
        th, tw = (2, 2) if axis_h else (1, 4)
        flow = tile_flow(rng, "noisy", 2, th * H, tw * W, 16)
        flow[:, :, ::7, ::5] = float("nan")
        avg, cnt, _ = T._tiled_average(mesh, flow.to(dev, dtype), 16, "tile", axis_h, None)
    else:
        density = {"sparse": 0.004, "empty": 0.0, "uneven": 0.3, "dense": 0.5,
                   "wide": 0.0005}[kind]
        full = torch.from_numpy((rng.rand(n, H, W + 2) < density).astype(np.float32)).to(dev)
        cnt = full[..., 1:W + 1]
        if kind == "uneven":
            cnt[..., -1] = 0.0
            cnt[:, -1] = 0.0
        avg = torch.from_numpy(rng.randn(n, 2, H, W).astype(np.float32)).to(dev)
        avg = avg * (cnt > 0)[:, None]
    stacks = (ring.stacked("tile"), ring.stacked(axis_h) if axis_h else None)
    want = T.tiled_fill_reference(avg, cnt, ring, "tile", axis_h, dtype)
    got, masks = P.launch_fill_tiles(avg, cnt, stacks, None, None, None, dtype, with_masks=True)
    assert torch.equal(got, want)
    ref = P.pack_masks(cnt > 0)
    assert torch.equal(masks.rows, ref.rows) and torch.equal(masks.cols, ref.cols)
    has = cnt > 0
    left, right = T._row_carries(avg, has, ring, "tile")
    up = T._up_carry(avg, has, ring, axis_h) if axis_h else None
    assert torch.equal(P.launch_fill_tiles(avg, cnt, (None, None), left, right, up, dtype), want)
    if axis_h:
        assert torch.equal(P.launch_fill_tiles(avg, cnt, (None, stacks[1]), left, right, None,
                                               dtype), want)
    K.reset_counters()
    T._tiled_fill(avg, cnt, ring, "tile", axis_h, dtype)
    counts = K.launch_counts()
    assert counts["fill_holes_carry"] == 1 and sum(counts.values()) == 1, counts
    assert graph_ops(lambda: T._tiled_fill(avg, cnt, ring, "tile", axis_h, dtype)) == 2


def test_tile_fill_gradients_match_plain(rng, dev):
    """The tiled fill's gradient on the card (autograd of its plain
    composition) reaches the averages of the tiles a carry came from, as
    the plain composition's does on the CPU."""
    from memcnet_tpu_torch.parallel import tiling as T

    mesh, axis_h = tile_grid("tile2x2", dev)
    ring = T._ring(mesh, 1, "tile", axis_h)
    n, H, W = ring.n, 40, 48
    cnt = torch.from_numpy((rng.rand(n, H, W) < 0.01).astype(np.float32))
    avg = torch.from_numpy(rng.randn(n, 2, H, W).astype(np.float32)) * (cnt > 0)[:, None]
    g = torch.from_numpy(rng.randn(n, 2, H, W).astype(np.float32))
    a = avg.to(dev).requires_grad_(True)
    (got,) = torch.autograd.grad(T._tiled_fill(a, cnt.to(dev), ring, "tile", axis_h,
                                               torch.float32), a, g.to(dev))
    a = avg.clone().requires_grad_(True)
    cpu_ring = T._ring(tile_grid("tile2x2", "cpu")[0], 1, "tile", axis_h)
    (want,) = torch.autograd.grad(T._tiled_fill(a, cnt, cpu_ring, "tile", axis_h,
                                                torch.float32), a, g)
    close(got.cpu(), want)


def tile_sums_case(rng, dev, dtype, grid, kind, H=70, W=148, halo=16):
    """K2's tile entry's arguments on the tiles of B = 2 H x W frames: 37
    columns a tile on (1, 4), 74 x 35 on (1, 2, 2).  Flows: +-20 px with
    a band landing left of the frame, all landing below the frame, NaN
    in a third of the pixels, or whole pixels (every sum exact, so the
    kernel's result must equal the plain version's bit for bit)."""
    from memcnet_tpu_torch.parallel import tiling as T

    mesh, axis_h = tile_grid(grid, dev)
    if kind == "integer":
        f = rng.randint(-20, 21, (2, 2, H, W)).astype(np.float32)
    else:
        f = tile_flow(rng, "invalid" if kind == "invalid" else "noisy", 2, H, W, halo).numpy()
    if kind == "nan":
        f[rng.rand(*f.shape) < 0.33] = np.nan
    flow = torch.from_numpy(f).to(dev, dtype)
    ring = T._ring(mesh, 2, "tile", axis_h)
    Wl, Hl, hh = T._grid(mesh, flow.shape, "tile", axis_h, halo, None)
    return ring.split(flow), T._origins(ring, "tile", axis_h, Wl, Hl, dev), (halo, hh, W, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
@pytest.mark.parametrize("kind", ["noisy", "invalid", "nan", "integer"])
def test_tile_sums_odd_tiles_nan_and_alignment(rng, dev, dtype, grid, kind):
    """K2's tile entry on tiles of odd widths (37, and 35 rows on (1, 2, 2):
    halo_h 0 and 16): counts exact against its plain version, sums within
    1e-3 (exact, bit for bit, for whole-pixel flows); an all-invalid flow
    scatters nothing, a NaN flow only its other pixels; written into an
    output one float past an 8-byte boundary, the same counts."""
    from memcnet_tpu_torch.ops.cuda import _lib

    fl, org, geom = tile_sums_case(rng, dev, dtype, grid, kind)
    K.reset_counters()
    got = P.tile_sums(fl, org, *geom)
    assert K.launch_counts()["base_scatter_tile"] == 1
    ref = P.tile_sums_reference(fl, org, *geom)
    assert torch.equal(got[:, 2], ref[:, 2])
    assert float((got - ref).abs().max()) <= 1e-3
    if kind == "integer":
        assert torch.equal(got, ref)
    if kind == "invalid" and grid == "tile4":
        assert not got.any()
    if kind == "nan":
        assert torch.isfinite(got).all() and float(got[:, 2].sum()) > 0
    halo, hh, W, H = geom
    n, _, Hl, Wl = fl.shape
    sums = torch.empty_like(got)
    out = misaligned(torch.zeros_like(got))
    err = _lib.lib().memc_project_tile_sums(
        fl.data_ptr(), org.data_ptr(), sums.data_ptr(), out.data_ptr(), n, Hl, Wl, halo, hh, H,
        W, _lib.dtype_code(dtype), _lib.stream_ptr(fl))
    _lib.check(err, "project_tile_sums")
    assert torch.equal(out[:, 2], ref[:, 2])
    assert float((out - ref).abs().max()) <= 1e-3


def test_tiled_ops_under_spatial_tiling_launch_the_tile_entries(rng, dev):
    """Under spatial_tiling the three ops dispatch to the tiled ones, which
    launch the tile entries on CUDA tensors and never the plain versions."""
    from memcnet_tpu_torch.parallel import spatial_tiling

    mesh, _ = tile_grid("tile4", dev)
    flow = tile_flow(rng, "noisy", 2, 64, 512, 16).to(dev)
    img = torch.rand(2, 3, 64, 512, device=dev)
    filt = torch.rand(2, 16, 64, 512, device=dev) / 8
    K.reset_counters()
    with spatial_tiling(mesh, halo=16):
        ops.filter_interp_warp(img, flow, filt)
        ops.filter_interp_warp_split((img, img), flow, filt)
        ops.flow_project(flow, fillhole=True)
        ops.flow_project(flow)
        with pytest.raises(NotImplementedError):
            ops.flow_project(flow, fix_down_scan_bug=True)
    assert K.launch_counts() == {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                                 "conv2d_small": 0, "grid_sample": 0,
                                 "filter_interp_warp_tile": 2, "base_scatter_tile": 2,
                                 "fill_holes_carry": 1, "level_input_tile": 0,
                                 "base_scatter_payload_tile": 0}


# -- K1's tile entry kernel and K3's fill, 4 pixels a thread -----------------------------

TILE_SPLITS = {3: (3,), 5: (3, 2), 8: (3, 5), 9: (1, 8), 67: (3, 64)}  # channels of each source


def tile_warp_case(rng, dev, dtype, channels, fs, Wl, halo_h, kind, n=3, Hl=24, halo=16):
    """n tiles of Hl x Wl side by side in a frame of Hl x (n Wl) (with halo_h,
    stacked down a frame of (n Hl) x Wl): halo-extended sources of the given
    channels and the flow ``kind``: "smooth" (the blocks stage their box),
    with two columns of the first tile landing left of the frame; "budget"
    -- each tile near one flow, past the clamp budget +-(halo - fs), at it
    and at minus it (vertically past halo_h's budget too); "wide" -- uniform
    within +-1.5 halo, so the blocks' patches spread past the box and
    gather."""
    ext = [torch.from_numpy(rng.randn(n, c, Hl + 2 * halo_h, Wl + 2 * halo).astype(np.float32))
           .to(dev, dtype) for c in TILE_SPLITS[channels]]
    if kind == "wide":
        f = ((rng.rand(n, 2, Hl, Wl) - 0.5) * 3.0 * halo).astype(np.float32)
    elif kind == "smooth":
        f = flow_field(rng, n, Hl, Wl, 3.0).numpy()
        f[0, 0, :, :2] = -2.5 * Wl
    else:
        f = (rng.randn(n, 2, Hl, Wl) * 0.5).astype(np.float32)
        budget = halo - fs
        for k, fx in enumerate((budget + 7.5, budget, -budget)):
            f[k, 0] += fx
        if halo_h:
            f[1, 1] -= halo_h - fs + 3.0
    flow = torch.from_numpy(f).to(dev)
    filt = torch.from_numpy(rng.rand(n, fs * fs, Hl, Wl).astype(np.float32)).to(dev, dtype)
    if halo_h:
        org = torch.tensor([[0, k * Hl] for k in range(n)], dtype=torch.int32, device=dev)
        geom = (halo, halo_h, fs, Wl, n * Hl)
    else:
        org = torch.tensor([[k * Wl, 0] for k in range(n)], dtype=torch.int32, device=dev)
        geom = (halo, 0, fs, n * Wl, Hl)
    return ext, flow, filt, org, geom


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [3, 5, 8, 9, 67])
@pytest.mark.parametrize("fs", [4, 2])
def test_tile_warp_kernel_channels_widths_and_clamps(rng, dev, dtype, channels, fs):
    """K1's tile entry against its plain version: 3 channels (the gather
    path), 5, 8 and 9 (one stage, a full stage, a stage and one more channel
    in bf16) and 67 (star's frame and context: a partial last stage) in
    split sources; tiles 21 (less than a block), 336 and 672 columns wide;
    halo_h 0 and 12; smooth flows, flows at and past the clamp budget, and
    flows spread wider than the staged box."""
    for Wl in (21, 336, 672):
        for halo_h in (0, 12):
            for kind in ("smooth", "budget", "wide"):
                ext, flow, filt, org, geom = tile_warp_case(rng, dev, dtype, channels, fs, Wl,
                                                            halo_h, kind)
                got = warp_kernel.launch_tile(ext, flow, filt, org, *geom)
                ref = warp_kernel.tile_reference(ext, flow, filt, org, *geom)
                assert len(got) == len(ext)
                for g, r in zip(got, ref):
                    close(g, r)


FILL_MASKS = {"sparse": 0.1, "dense": 0.6, "all holes": 0.0, "no hole": 1.0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("H,W", [(45, 97), (37, 1101), (1100, 42), (33, 1344)])
def test_fill_is_the_plain_versions_bits(rng, dev, dtype, down, H, W):
    """K3 (4 pixels a thread) equals fill_stage_reference bit for bit, with
    and without the down search: widths that are not multiples of 4 (97,
    1101) or 32 (42), and 1344 (vector loads), on sparse, dense, all-hole and
    no-hole masks, and on an average one element off 16 bytes."""
    B = 2
    for name, density in FILL_MASKS.items():
        cnt = torch.from_numpy((rng.rand(B, H, W) < density).astype(np.float32)).to(dev)
        avg = torch.from_numpy(rng.randn(B, 2, H, W).astype(np.float32)).to(dev)
        avg = avg * (cnt > 0)[:, None]
        masks = P.pack_masks(cnt > 0)
        want = P.fill_stage_reference(avg, masks, dtype, down=down)
        assert torch.equal(P.launch_fill(avg, masks, dtype, down=down), want), name
    # an average that starts one float past a 16-byte boundary: pixel by pixel
    off = torch.empty(B * 2 * H * W + 1, device=dev)[1:].view(B, 2, H, W).copy_(avg)
    assert torch.equal(P.launch_fill(off, masks, dtype, down=down), want)


# -- partitioned frames (parallel/partition.py): every layer on its tile -------------------

PART_FRAMES = {"tile4": (64, 320), "tile2x2": (192, 320)}  # each with a level that does not divide
PART_LAYERS = {
    "conv k3 s2": lambda L, x, g: L.conv2d(x, g["w3"], g["b8"], stride=2, padding=1),
    "conv k7 s1": lambda L, x, g: L.conv2d(x, g["w7"], g["b8"], padding=3),
    "conv groups 2": lambda L, x, g: L.conv2d(x, g["wg"], None, padding=1, groups=2),
    "deconv": lambda L, x, g: L.conv_transpose2d(x, g["wd"], g["b4"], stride=2, padding=1),
    "upsample x2": lambda L, x, g: L.upsample_bilinear(x, 2),
    "max-pool": lambda L, x, g: L.max_pool2d(x, 2),
    "batch norm": lambda L, x, g: L.batch_norm_train(x, g["b6"], g["b6"] * 0.5, g["b6"] * 0,
                                                     g["b6"].abs() + 1)[0],
}


@pytest.mark.parametrize("grid", list(PART_FRAMES))
@pytest.mark.parametrize("layer", list(PART_LAYERS))
@pytest.mark.parametrize("lvl", [1, 5])
def test_partitioned_layers_on_the_card_match_the_whole_tensor(dev, grid, layer, lvl):
    """Each partitioned layer on stacked CUDA tiles against the stock layer
    on the whole CUDA tensor, float32 (TF32 off)."""
    from memcnet_tpu_torch.nn import layers as L
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling

    mesh, axis_h = tile_grid(grid, dev)
    H, W = PART_FRAMES[grid]
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = {"w3": (8, 6, 3, 3), "w7": (8, 6, 7, 7), "wg": (8, 3, 3, 3), "wd": (6, 4, 4, 4),
              "b8": (8,), "b4": (4,), "b6": (6,)}
    g = {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}
    x = torch.randn((2, 6, H >> lvl, W >> lvl), generator=gen, device=dev)
    want = PART_LAYERS[layer](L, x, g)
    with spatial_tiling(mesh, halo=16, axis_h=axis_h):
        shard_frames(mesh, torch.zeros(1, 1, H, W, device=dev))
        p = active_partition()
        got = p.merge(PART_LAYERS[layer](L, p.split(x), g))
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
def test_ctx_conv_runs_k4_once_on_halo_extended_tiles(rng, dev, dtype, grid):
    """Star's ctx conv on partitioned frames: one K4 launch over every
    stacked tile extended by 3 columns (and rows) of the normalised input,
    equal to K4 on the whole frame."""
    from memcnet_tpu_torch.models.ctx import ContextNet
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling

    mesh, axis_h = tile_grid(grid, dev)
    net = ContextNet()
    net.init_params(torch.Generator().manual_seed(0))
    net = net.to(dev, dtype)
    x = torch.from_numpy(rng.rand(2, 3, 128, 256).astype(np.float32)).to(dev, dtype)
    want = net(x)
    K.reset_counters()
    with spatial_tiling(mesh, halo=16, axis_h=axis_h):
        got = gather_frames(mesh, net(shard_frames(mesh, x)))
    assert K.launch_counts()["conv2d_small"] == 1
    close(got, want, long_sums=True)


def scale_flows(model, flow, px=3.0):
    """Scale the flow net's last conv (FlowNetS's; SPyNet's coarsest level's,
    whose residual doubles at every finer level) so that ``flow()`` reaches
    about px."""
    with torch.no_grad():
        if hasattr(model.flownets, "moduleBasic"):
            top = model.flownets.moduleBasic[0].moduleBasic[8]
            for _ in range(3):
                k = px / float(flow().abs().max())
                top.weight.mul_(k)
                top.bias.mul_(k)
        else:
            model.flownets.predict_flow2.weight.mul_(px / float(flow().abs().max()))


@pytest.mark.parametrize("name", ["MEMC_Net_star", "MEMC_Net", "MEMC_Net_s"])
def test_partitioned_forward_on_the_card_launches_tile_entries_and_matches(rng, dev, name):
    """The partitioned float32 forward on (1, 2, 2) at 128x128: 2 K1 tile, 1
    K2 tile and 1 K3 carry launches (and star's 1 K4; MEMC_Net_s's SPyNet 3
    levels of 5 K4 and 1 K5 tile entry; the walkers' K4 on halo-extended
    tiles), no global K1-K3 or K5, and every output within 1e-4 of its scale
    of the untiled forward on the card."""
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling

    model = build_model(name, seed=0, device=dev)
    x0 = torch.from_numpy(rng.rand(1, 3, 128, 128).astype(np.float32)).to(dev)
    x2 = torch.roll(x0, (1, 2), (2, 3))
    with torch.no_grad():
        scale_flows(model, lambda: model._flow(x0, x2))
        (wi, wr), woffs, _, _ = model(x0, x2)
        mesh, axis_h = tile_grid("tile2x2", dev)
        K.reset_counters()
        with spatial_tiling(mesh, halo=16, axis_h=axis_h):
            (gi, gr), goffs, _, _ = model(*shard_frames(mesh, x0, x2))
            got = [gather_frames(mesh, t) for t in (gi, gr, *goffs)]
    spy = name == "MEMC_Net_s"
    assert K.launch_counts() == {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                                 "conv2d_small": WALKER_K4[name] + (
                                     15 if spy else int(name == "MEMC_Net_star")),
                                 "grid_sample": 0, "filter_interp_warp_tile": 2,
                                 "base_scatter_tile": 1, "fill_holes_carry": 1,
                                 "level_input_tile": 3 if spy else 0,
                                 "base_scatter_payload_tile": 0}
    for g, w in zip(got, (wi, wr, *woffs)):
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


def test_partitioned_ve_on_the_card_launches_tile_entries_and_matches(rng, dev):
    """MEMC_Net_VE's partitioned float32 forward on (1, 2, 2) at 128x128: one
    K1 tile launch (the 6B split warp), one K4 (the 7B ctx conv on
    halo-extended tiles) and the walkers' K4, nothing else, within 1e-4 of
    the output's scale of the untiled forward on the card."""
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling

    model = build_model("MEMC_Net_VE", seed=0, device=dev)
    base = torch.from_numpy(rng.rand(1, 3, 128, 128).astype(np.float32)).to(dev)
    frames = [torch.roll(base, (k - 3, 2 * (k - 3)), (2, 3)) for k in range(7)]
    with torch.no_grad():
        scale_flows(model, lambda: model(frames, debug=True)[1])
        want = model(frames, debug=True)
        mesh, axis_h = tile_grid("tile2x2", dev)
        K.reset_counters()
        with spatial_tiling(mesh, halo=16, axis_h=axis_h):
            got = [gather_frames(mesh, t)
                   for t in model(list(shard_frames(mesh, *frames)), debug=True)]
    assert K.launch_counts() == {"filter_interp_warp": 0, "base_scatter": 0, "fill_holes": 0,
                                 "conv2d_small": 1 + WALKER_K4["MEMC_Net_VE"], "grid_sample": 0,
                                 "filter_interp_warp_tile": 1, "base_scatter_tile": 0,
                                 "fill_holes_carry": 0, "level_input_tile": 0,
                                 "base_scatter_payload_tile": 0}
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


LEVEL_TILE_LEVELS = [(768, 1344), (96, 168), (24, 42)]  # 720p's levels 0, 3 and 5


def level_tile_case(rng, dev, dtype, grid, H, W, B=2, amp=20.0, frame=(768, 1344), halo=64):
    """The partition of ``frame`` on ``grid`` at the level H x W, and the
    tile entry's arguments for fst, snd (B, 3, H, W) and a coarse flow whose
    upsample reaches +-amp px."""
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling

    fst, snd, _ = level_case(rng, dev, dtype, H, W, B=B)
    f = np.clip(flow_field(rng, B, H // 2, W // 2, amp / 2).numpy(), -amp / 2, amp / 2)
    flow = torch.from_numpy(f).to(dev, dtype)
    mesh, axis_h = tile_grid(grid, dev)
    with spatial_tiling(mesh, halo=halo, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1) + frame, device=dev))
        p = active_partition()
        ft = p.split(fst)
        window, origins, level = p.level_input_window(p.split(flow), ft)
        whole = p.gather(p.split(snd))
    return p, (fst, snd, flow), (ft, whole, window, origins, *level)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
@pytest.mark.parametrize("H,W", LEVEL_TILE_LEVELS)
def test_level_input_tile_kernel_matches_plain(rng, dev, dtype, grid, H, W):
    """K5's tile entry at three 720p levels, +-20 px flows: merged, it equals
    the untiled kernel on the whole level bit for bit (the same float32
    steps on global coordinates); against its plain version fst exactly, up
    and the warp of the kernel's own up within 1e-5 (float32) or 2 bf16
    ulps; one launch per call (its one device operation is counted by
    chip_smoke.py phase 2: late in this file's run torch.profiler reports
    no device operation for short calls)."""
    p, (fst, snd, flow), args = level_tile_case(rng, dev, dtype, grid, H, W)
    got = gather_kernel.launch_level_input_tile(*args)
    ref = gather_kernel.level_input_tile_reference(*args)
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.equal(p.merge(got), gather_kernel.launch_level_input(fst, snd, flow))
    assert torch.equal(got[:, :3], ref[:, :3])
    up = p.merge(got[:, 6:])
    want = gather_kernel.reference(snd, gather_kernel.warp_grid(up))
    if dtype == torch.float32:
        assert float((got[:, 6:] - ref[:, 6:]).abs().max()) <= 1e-5 * 20
        assert float((p.merge(got[:, 3:6]) - want).abs().max()) <= 1e-5
    else:
        close(got[:, 6:], ref[:, 6:])
        close(p.merge(got[:, 3:6]), want)
    K.reset_counters()
    gather_kernel.level_input_tile(*args)
    assert K.launch_counts()["level_input_tile"] == 1


def test_level_input_tile_gradients_match_plain(rng, dev):
    _, _, args = level_tile_case(rng, dev, torch.float32, "tile2x2", 48, 84)
    fst, snd, flow = (a.detach().requires_grad_() for a in args[:3])
    ct = torch.randn(fst.shape[0], 8, *fst.shape[2:], device=dev)
    (gather_kernel.level_input_tile(fst, snd, flow, *args[3:]) * ct).sum().backward()
    xs = [a.detach().requires_grad_() for a in (fst, snd, flow)]
    (gather_kernel.level_input_tile_reference(*xs, *args[3:]) * ct).sum().backward()
    for a, c in zip((fst, snd, flow), xs):
        assert float((a.grad - c.grad).abs().max()) <= ATOL


# (grid, frame, level) -> the tile width (the widest of 4, 2, 1 pixels that
# divides it): 332 (4), 334 (2), 167 (1), 84 owning 84 and 83 (4, the last
# group partly owned), 42 owning 42 and 41 (2); on (1, 2, 2) 166 (2), 83 (1)
# and 80 (4), with tiles of 16, 8 and 48 rows
LEVEL_TILE_WIDTHS = [("tile4", (64, 1328), 0), ("tile4", (64, 1336), 0),
                     ("tile4", (64, 1336), 1), ("tile4", (64, 1336), 2),
                     ("tile4", (64, 1328), 3), ("tile2x2", (128, 1328), 2),
                     ("tile2x2", (128, 1328), 3), ("tile2x2", (192, 320), 1)]


def level_input_tile_into(args, out):
    """The tile entry's kernel writing into ``out`` (any alignment)."""
    from memcnet_tpu_torch.ops.cuda import _lib

    ft, snd, window, origins, GH, GW = args
    n, _, h, w = ft.shape
    err = _lib.lib().memc_spynet_level_input_tile(
        ft.data_ptr(), snd.data_ptr(), window.data_ptr(), origins.data_ptr(), out.data_ptr(), n,
        snd.shape[0], h, w, window.shape[2], window.shape[3], GH, GW,
        _lib.dtype_code(ft.dtype), _lib.stream_ptr(ft))
    _lib.check(err, "spynet_level_input_tile")
    return out


def misaligned(t):
    """A contiguous copy of ``t`` one element past an 8-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,frame,lvl", LEVEL_TILE_WIDTHS)
def test_level_input_tile_kernel_widths_and_alignment(rng, dev, dtype, grid, frame, lvl):
    """K5's tile entry at tile widths that 4 does not divide (even and odd,
    owned widths that end inside a group of 4 or 2), on (1, 4) (no H tiles)
    and (1, 2, 2): merged fst and up equal the untiled kernel's bit for
    bit, fst equals its plain version's, up and the warp of its own up are
    within 1e-5 (float32) or 2 bf16 ulps, the unowned positions' last five
    channels are zero; and an output or an fst one element past an 8-byte
    boundary gives the same bits."""
    H, W = frame[0] >> lvl, frame[1] >> lvl
    p, (fst, snd, flow), args = level_tile_case(rng, dev, dtype, grid, H, W, frame=frame,
                                                halo=16)
    got = gather_kernel.launch_level_input_tile(*args)
    ref = gather_kernel.level_input_tile_reference(*args)
    merged = p.merge(got)
    untiled = gather_kernel.launch_level_input(fst, snd, flow)
    assert torch.equal(merged[:, :3], untiled[:, :3]) and torch.equal(merged[:, 6:],
                                                                      untiled[:, 6:])
    assert torch.equal(got[:, :3], ref[:, :3])
    owned = ref[:, 3:].abs().sum(1) > 0
    assert not got[:, 3:][~owned[:, None].expand_as(got[:, 3:])].any()
    want = gather_kernel.reference(snd, gather_kernel.warp_grid(merged[:, 6:]))
    if dtype == torch.float32:
        assert float((got[:, 6:] - ref[:, 6:]).abs().max()) <= 1e-5 * 20
        assert float((merged[:, 3:6] - want).abs().max()) <= 1e-5
    else:
        close(got[:, 6:], ref[:, 6:])
        close(merged[:, 3:6], want)
    assert torch.equal(level_input_tile_into(args, misaligned(torch.zeros_like(got))), got)
    moved = (misaligned(args[0]),) + args[1:]
    assert torch.equal(gather_kernel.launch_level_input_tile(*moved), got)


# -- the op library on partitioned frames: K2's payload entry on tile origins -----------

# (grid, frame, level): even levels and levels whose tiles do not divide them
PAYLOAD_TILE_CASES = [("tile4", (64, 256), 0), ("tile2x2", (192, 320), 0),
                      ("tile4", (64, 320), 5), ("tile2x2", (192, 320), 6)]


def payload_tile_case(rng, dev, dtype, op, grid, frame, lvl):
    """(tiles of a +-20 px flow in ``dtype``, ``op``'s inputs -- N7's depth
    tiles, or N8's frame1 tiles and frame2's whole level -- their origins,
    samples, level size) on ``grid``."""
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling

    mesh, axis_h = tile_grid(grid, dev)
    H, W = frame[0] >> lvl, frame[1] >> lvl
    flow = torch.from_numpy(((rng.rand(2, 2, H, W) - 0.5) * 40.0).astype(np.float32))
    ins = payload_inputs(rng, op, 2, H, W, dev, dtype)
    with spatial_tiling(mesh, halo=16, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1) + frame, device=dev))
        f, *tiles = shard_frames(mesh, flow.to(dev, dtype), *ins)
        p = active_partition()
        n = f.shape[0]
        if op == "gated":
            tiles[1] = p.gather(tiles[1], (H, W))
        return f, tuple(tiles), p.origins((H, W), n, f.device), p.samples(n), (H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["depth", "gated"])
@pytest.mark.parametrize("grid, frame, lvl", PAYLOAD_TILE_CASES)
def test_payload_tile_entry_matches_plain(rng, dev, dtype, op, grid, frame, lvl):
    """K2's payload entry on tile origins, the payload built inside it,
    against its plain version: the last plane (depth sums in quarters, the
    gate's counts) exact, the sums within ATOL of their scale; one launch of
    its counter per call and nothing else."""
    f, ins, org, samples, (H, W) = payload_tile_case(rng, dev, dtype, op, grid, frame, lvl)
    K.reset_counters()
    got = P.payload_tile(op, f, ins, 0.1, org, samples, H, W)
    counts = K.launch_counts()
    assert counts["base_scatter_payload_tile"] == 1 and sum(counts.values()) == 1, counts
    ref = P.payload_tile_reference(op, f, ins, 0.1, org, samples, H, W)
    assert got.shape == (samples, 4 if op == "gated" else 3, H, W)
    assert torch.equal(got[:, -1], ref[:, -1])
    close(got, ref)


def test_payload_tile_entry_gradients_match_plain(rng, dev):
    """N8 on tiles: the gradient of the fused entry's sums reaches the flow,
    frame1 and frame2's whole level as autograd of its plain version does."""
    f, ins, org, samples, (H, W) = payload_tile_case(rng, dev, torch.float32, "gated",
                                                     "tile2x2", (192, 320), 0)
    xs = [x.detach().requires_grad_(True) for x in (f, *ins)]
    g = torch.randn(samples, 4, H, W, device=dev)
    got = torch.autograd.grad(P.payload_tile("gated", xs[0], xs[1:], 0.1, org, samples, H, W),
                              xs, g)
    want = torch.autograd.grad(
        P.payload_tile_reference("gated", xs[0], xs[1:], 0.1, org, samples, H, W), xs, g)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
def test_partitioned_op_library_on_the_card_matches_untiled(rng, dev, grid):
    """Every op of the library, and the grid sample and replication pad
    layers, on sharded frames (64x256 on (1, 4), 128x128 on (1, 2, 2), flows
    of +-20 px across tiles) against the untiled op on the card, forward and
    a VJP of a seeded cotangent, within ATOL of each output's scale; N7 and
    N8 launch K2's payload entry on tile origins once and K3's carry entry
    with the fill, the grid sample K5's general entry once, nothing else."""
    from memcnet_tpu_torch.nn import layers as L
    from memcnet_tpu_torch.parallel import gather_frames, shard_frames, spatial_tiling

    H, W = (64, 256) if grid == "tile4" else (128, 128)
    calls = [c for c in op_library_calls(rng, H=H, W=W, amp=20.0)
             if c[0] != "flow_project_down"]  # no tiled form, as in the JAX package
    image = torch.from_numpy(rng.rand(2, 3, H, W).astype(np.float32))
    grid_in = torch.from_numpy((rng.rand(2, H, W, 2) * 2.2 - 1.1).astype(np.float32))
    calls += [("replication_pad2d", lambda x: L.replication_pad2d(x, (2, 3, 1, 2)), [image],
               [True]),
              ("grid_sample_bilinear", L.grid_sample_bilinear, [image, grid_in], [True, True])]
    mesh, axis_h = tile_grid(grid, dev)

    def shard(name, i, x):  # the channels-last grid is tiled over its dims 1 and 2
        if name == "grid_sample_bilinear" and i == 1:
            return shard_frames(mesh, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return shard_frames(mesh, x)

    for name, fn, inputs, _ in calls:
        res = {}
        for tiled in (False, True):
            xs = [x.to(dev).requires_grad_(True) for x in inputs]
            K.reset_counters()
            if tiled:
                with spatial_tiling(mesh, halo=16, axis_h=axis_h):
                    shard_frames(mesh, torch.zeros(1, 1, H, W, device=dev))
                    out = fn(*(shard(name, i, x) for i, x in enumerate(xs)))
                    counts = K.launch_counts()
                    out = tuple(gather_frames(mesh, o) for o in
                                (out if isinstance(out, tuple) else (out,)))
            else:
                out = fn(*xs)
                out = out if isinstance(out, tuple) else (out,)
            cts = [torch.from_numpy(np.random.RandomState(1).randn(*o.shape).astype(np.float32))
                   .to(dev) for o in out]
            res[tiled] = ([o.detach() for o in out], torch.autograd.grad(out, xs, cts))
        want = dict.fromkeys(counts, 0)
        if "project" in name:
            want.update(base_scatter_payload_tile=1, fill_holes_carry=int("nofill" not in name))
        if name == "grid_sample_bilinear":
            want["grid_sample"] = 1
        assert counts == want, (name, counts)
        for a, b in zip(res[True][0] + list(res[True][1]), res[False][0] + list(res[False][1])):
            assert float((a - b).abs().max()) <= ATOL * max(1.0, float(b.abs().max())), name


# -- K4's float32 body and bf16 bits ----------------------------------------------------
#
# Last in the file: torch.profiler, which device_ops reads, drops the records
# of short calls late in a process, and these cases launch many kernels.
#
# K4's float32 body (3xTF32, csrc/conv_f32.cu) against its plain version: max
# abs err <= 5e-4, chip_smoke.py's rule at SPyNet's sums of up to 3,136 terms
# (the body drops lo * lo, under 2^-22 of each product)
F32_K4_ATOL = 5e-4
SPYNET_BASIC = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]


def spynet_conv_inputs(dev, cin, cout, h, w, seed, B=2):
    """SPyNet's conv inputs: x in [-2, 2), torch-0.2 default weights and bias."""
    from memcnet_tpu_torch.nn import init as I

    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((B, cin, h, w), generator=gen) * 4.0 - 2.0).to(dev)
    wt = I.torch_default_uniform((cout, cin, 7, 7), gen).to(dev)
    b = I.torch_default_uniform((cout,), gen, fan_in=cin * 49).to(dev)
    return x, wt, b


def f32_err(x, w, b, relu):
    got = conv_kernel.launch(x, w, b, relu=relu)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], w.shape[0], *x.shape[2:])
    return float((got - conv_kernel.reference(x, w, b, relu=relu)).abs().max())


@pytest.mark.parametrize("frame", [(768, 1344), (256, 448)])
@pytest.mark.parametrize("level", range(6))
def test_conv_f32_at_every_spynet_level(dev, frame, level):
    """Each of SPyNet's five convs at each level, B = 2: 720p (768x1344 down
    to 24x42, MEMC_Net_s served) and the train frames (256x448 down to
    8x14), one launch of the float32 body each."""
    h, w = frame[0] >> level, frame[1] >> level
    for j, (cin, cout) in enumerate(SPYNET_BASIC):
        x, wt, b = spynet_conv_inputs(dev, cin, cout, h, w, seed=10 * level + j)
        K.reset_counters()
        err = f32_err(x, wt, b, relu=j < len(SPYNET_BASIC) - 1)
        assert K.body_counts() == {"conv2d_small[float32]": 1}
        assert err <= F32_K4_ATOL, (h, w, cin, cout, err)


@pytest.mark.parametrize("K", [3, 5, 7])
@pytest.mark.parametrize("O", [2, 16, 32, 64])
@pytest.mark.parametrize("C", [3, 8, 16, 32, 64, 136])
def test_conv_f32_bias_relu_ragged(rng, dev, C, O, K):
    """Every channel chunking (C = 3: two taps a step) and output group of
    the float32 body, K 3, 5 and 7, widths 4 does not divide (W % 4 = 1, 2,
    3), with and without bias and ReLU; C = 136 sums 153 8-deep steps."""
    for H, W, bias, relu in ((21, 45, False, False), (19, 38, False, True),
                             (40, 75, True, False)):
        x = torch.from_numpy(rng.randn(2, C, H, W).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.randn(O, C, K, K) / np.sqrt(C * K * K)).astype(np.float32))
        b = torch.from_numpy(rng.randn(O).astype(np.float32) * 0.1).to(dev) if bias else None
        assert f32_err(x, w.to(dev), b, relu) <= F32_K4_ATOL, (H, W, bias, relu)


@pytest.mark.parametrize("grid", ["tile4", "tile2x2"])
@pytest.mark.parametrize("cin,cout", [(32, 64), (16, 2)])
def test_conv_f32_on_halo_extended_tiles(dev, grid, cin, cout):
    """SPyNet's convs through nn/layers.py::conv2d_k4 on partitioned frames:
    one float32 launch over the stacked tiles extended by 3 columns (and
    rows), equal to the plain conv of the whole frame within the rule."""
    from memcnet_tpu_torch.nn import layers as L
    from memcnet_tpu_torch.parallel import active_partition, shard_frames, spatial_tiling

    mesh, axis_h = tile_grid(grid, dev)
    x, w, b = spynet_conv_inputs(dev, cin, cout, 96, 256, seed=cin)
    relu = cout != 2
    want = conv_kernel.reference(x, w, b, relu=relu)
    K.reset_counters()
    with spatial_tiling(mesh, halo=16, axis_h=axis_h):
        shard_frames(mesh, torch.zeros(1, 1, 96, 256, device=dev))
        p = active_partition()
        got = p.merge(L.conv2d_k4(p.split(x), w, b, relu=relu))
    assert K.body_counts() == {"conv2d_small[float32]": 1}
    assert float((got - want).abs().max()) <= F32_K4_ATOL


# the spec walkers' 3x3 convs (models/mononet.py), (C, O): MonoNet5 thin's, then
# RectifyNet2's (64 -> 3 on the small-O variant, N = (o, kx))
WALKER_CONVS = [(6, 16), (16, 32), (32, 64), (256, 512), (512, 512), (41, 64), (64, 64),
                (64, 3)]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("cin,cout", WALKER_CONVS)
def test_conv_f32_at_the_walkers_3x3_shapes(dev, cin, cout, B):
    """K4's float32 body at the walkers' 3x3 shapes, 24x42 (a 720p trunk's
    deepest level), B = 1 and 4, bias, ReLU fused unless the conv is the last
    to 3 channels, kaiming weights as the models draw them: one launch,
    within F32_K4_ATOL of F.conv2d in float64."""
    import torch.nn.functional as F

    from memcnet_tpu_torch.nn import init as I

    gen = torch.Generator().manual_seed(1000 * cin + 10 * cout + B)
    x = torch.rand((B, cin, 24, 42), generator=gen) * 4.0 - 2.0
    w = I.kaiming_uniform((cout, cin, 3, 3), gen)
    b = torch.rand((cout,), generator=gen) - 0.5
    relu = cout != 3
    want = F.conv2d(x.double(), w.double(), b.double(), padding=1)
    want = want.clamp(min=0.0) if relu else want
    assert conv_kernel.f32_geometry(B, cin, 24, 42, cout, 3)["taps"] == (cout == 3)
    K.reset_counters()
    got = conv_kernel.conv2d_small(x.to(dev), w.to(dev), b.to(dev), relu=relu)
    assert K.body_counts() == {"conv2d_small[float32]": 1}
    assert float((got.cpu().double() - want).abs().max()) <= F32_K4_ATOL, (cin, cout, B)


@pytest.mark.parametrize("cin,cout,h,w", [(256, 512, 24, 42), (512, 512, 24, 42),
                                         (512, 256, 48, 84)])
def test_conv_f32_error_does_not_lean_toward_zero(dev, cin, cout, h, w):
    """The tensor cores cut each MMA's sum short, toward zero, at the scale of
    the accumulator it adds to: fed one running accumulator, K4's float32
    error leaned toward zero and grew with the input channels (at 512 -> 512,
    3x3, a max error of 2.6e-4 and a mean err x sign(exact) of -1.7e-5 on
    the H100).  Each 8-deep step summed from zero and added in float32 keeps
    the walkers' widest convs, B = 4, within 5e-5 of a float64 conv and that
    mean within +-1e-6."""
    import torch.nn.functional as F

    from memcnet_tpu_torch.nn import init as I

    gen = torch.Generator().manual_seed(cin + cout + h)
    x = torch.rand((4, cin, h, w), generator=gen) * 4.0 - 2.0
    wt = I.kaiming_uniform((cout, cin, 3, 3), gen)
    b = torch.rand((cout,), generator=gen) - 0.5
    want = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    err = conv_kernel.conv2d_small(x.to(dev), wt.to(dev), b.to(dev)).cpu().double() - want
    assert float(err.abs().max()) <= 5e-5
    assert abs(float((err * want.sign()).mean())) <= 1e-6


def span_kernels(prof, name):
    """Names of the device kernels launched under each host range ``name`` of
    a torch.profiler profile (each CPU event's kernels, over its subtree)."""
    found = []

    def walk(e):
        found.extend(k.name for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name:
            walk(e)
    return found


def test_memc_s_float32_walkers_run_on_k4_with_their_weights_packed_once(dev):
    """A MEMC_Net_s float32 forward at 128x640 (SPyNet's six levels, as at
    720p), B = 2, under inference_mode: 54 launches of K4's float32 body
    (SPyNet 30, thin trunk 12, branches 4, RectifyNet 8); a second forward
    packs no weight (every walker weight hits conv_kernel's cache); under the
    profiler memc.filters runs 16 of K4's kernels (trunk 12, branches 4) and
    memc.rectify 8, and neither a cuDNN, FFT or complex-GEMM kernel."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model("MEMC_Net_s", seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x0, x2 = (torch.rand(2, 3, 128, 640, device=dev, generator=g) for _ in range(2))
    with torch.inference_mode():
        K.reset_counters()
        model(x0, x2)
        assert K.body_counts() == {"conv2d_small[float32]": 30 + WALKER_K4["MEMC_Net_s"]}
        packed = list(conv_kernel._packed)
        K.reset_counters()
        model(x0, x2)
        assert K.body_counts() == {"conv2d_small[float32]": 30 + WALKER_K4["MEMC_Net_s"]}
        assert len(packed) >= 54 and set(conv_kernel._packed) == set(packed)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x0, x2)
            torch.cuda.synchronize()
    for span, n in (("memc.filters", 16), ("memc.rectify", 8)):
        names = span_kernels(prof, span)
        assert sum("conv2d_tf32x3" in k for k in names) == n, (span, names)
        assert not [k for k in names
                    if any(t in k.lower() for t in ("cudnn", "fft", "cf32", "xmma", "gemm"))], names


# bf16 K4 on fixed inputs: (C, O, K, H, W, bias and ReLU)
BF16_CASES = [(3, 64, 7, 64, 96, False), (8, 32, 7, 48, 84, True), (32, 64, 7, 33, 71, True),
              (64, 32, 7, 24, 42, True), (32, 16, 7, 37, 72, True), (16, 2, 7, 40, 64, False),
              (20, 24, 3, 33, 70, True), (6, 40, 5, 33, 70, True)]
# sha-256 of each case's bf16 output bytes from the bf16 body as it was before
# the float32 body became the tensor-core one (same inputs, same card type)
BF16_DIGESTS = {
    "3->64 k7 64x96": "fadefbe39dac772310a9709d8e437b62f6a62950e370ebadae0d2d0f7baf4479",
    "8->32 k7 48x84": "a3931f198815ba67359e61a4c071e24ff3cbf864afdcf233b4115bfc87b33a79",
    "32->64 k7 33x71": "b3c669f9eb9adde4484fbf4092ccc90bf644a2bdc810c4846b2417adf597a109",
    "64->32 k7 24x42": "2f314ffa54aa54f14b3fabdad8032a3b29c05f296939b25ac950acb2506aa37e",
    "32->16 k7 37x72": "df7cd3a63eae9f832212d5aee7e2ddefeb155b9fe9c7e6562295b0ae0d80235c",
    "16->2 k7 40x64": "6b6dfac7fe459161ce6fc43c6f05e1e0c0ab5d92c47a8fb0a87ac8a50f83ff5c",
    "20->24 k3 33x70": "d5a877360b5bad9b13cf858a8cb823c1bcea10790b01be1425f01e98bf1b6591",
    "6->40 k5 33x70": "43db73a0b8ca3bad623547d89f13f101454fe72e54d4a5f0c2e3467ea29a147b",
}


def bf16_digests(dev):
    import hashlib

    out = {}
    for C, O, k, H, W, bias in BF16_CASES:
        rng = np.random.RandomState(C * 1000 + O * 10 + k)
        x = torch.from_numpy(rng.randn(2, C, H, W).astype(np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((rng.randn(O, C, k, k) / np.sqrt(C * k * k)).astype(np.float32))
        b = torch.from_numpy(rng.randn(O).astype(np.float32) * 0.1).to(dev) if bias else None
        y = conv_kernel.launch(x, w.to(dev, torch.bfloat16), b, relu=bias)
        out[f"{C}->{O} k{k} {H}x{W}"] = hashlib.sha256(
            y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    return out


def test_conv_bf16_body_bits_unchanged(dev):
    """The bf16 body gives the same bits as before the float32 redesign."""
    assert bf16_digests(dev) == BF16_DIGESTS
