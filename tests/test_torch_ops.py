"""CPU parity of the PyTorch port's ops (memcnet_tpu_torch.ops) with the JAX
package, plus the port's own rules.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU every port kernel wrapper runs its plain PyTorch version; the JAX side
runs its XLA formulation or, for one case per kernel module, its Pallas
kernel in interpret mode.  Everything is float32.  Tolerances:
  * ATOL 1e-5: same arithmetic, different float32 summation order;
  * projection counts: exact (sums of 1.0 over integer landing cells);
  * gradients GATOL 1e-4: longer float32 chains (scatter + divide + fill).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from memcnet_tpu.models import ctx as jctx
from memcnet_tpu.nn import layers as JL
from memcnet_tpu.ops import projection as JP
from memcnet_tpu.ops import warp as JW
from memcnet_tpu.ops.pallas import conv_kernel as jck
from memcnet_tpu.ops.pallas import fill_kernel as jfk
from memcnet_tpu.ops.pallas import scatter_kernel as jsk

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch.cli import runner as TR
from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.models import ctx as tctx
from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops import warp as TW
from memcnet_tpu_torch.ops.cuda import _lib, conv_kernel, project_kernel

ATOL = 1e-5
GATOL = 1e-4
REPO = Path(__file__).resolve().parents[1]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def smooth_flow(rng, B, H, W, amp=6.0, invalid=True):
    """Low-frequency flow with random phases plus a block landing outside."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = np.zeros((B, 2, H, W), np.float32)
    for b in range(B):
        p = rng.uniform(0, 2 * np.pi, 2)
        out[b, 0] = amp * np.sin(2 * np.pi * ys / H + p[0]) * np.cos(2 * np.pi * xs / W)
        out[b, 1] = 0.6 * amp * np.cos(2 * np.pi * xs / W + p[1])
    out += rng.randn(B, 2, H, W).astype(np.float32) * 0.3
    if invalid:
        out[:, 0, :3, :5] = 500.0
    return out


# -- flow projection ---------------------------------------------------------


@pytest.mark.parametrize("fillhole,amp", [(True, 6.0), (False, 6.0), (True, 1.5)])
def test_flow_project_matches_jax(rng, fillhole, amp):
    flow = smooth_flow(rng, 2, 24, 40, amp)
    want = np.asarray(JP._global_flow_project(jnp.asarray(flow), fillhole=fillhole))
    got = TP.flow_project(t(flow), fillhole=fillhole).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flow_project_counts_exact(rng):
    flow = smooth_flow(rng, 2, 24, 40, 8.0)
    H, W = flow.shape[2:]
    valid, ixL, ixR, iyT, iyB = JP._landing_cells(jnp.asarray(flow))
    _, want = JP._scatter4(-jnp.asarray(flow), jnp.ones((2, H, W)), valid, ixL, ixR, iyT, iyB, H, W)
    _, got = TP.project(t(flow))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any() and (got.numpy() > 1).any()  # holes and overlaps


def test_flow_project_fixed_down_scan_matches_jax(rng):
    flow = smooth_flow(rng, 1, 24, 40, 8.0)
    want = np.asarray(JP._global_flow_project(jnp.asarray(flow), fillhole=True,
                                              fix_down_scan_bug=True))
    got = TP.flow_project(t(flow), fillhole=True, fix_down_scan_bug=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flow_project_grad_matches_jax_vjp(rng):
    flow = smooth_flow(rng, 1, 16, 24, 4.0)
    ct = rng.randn(*flow.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda f: JP._global_flow_project(f, fillhole=True), jnp.asarray(flow))
    (want,) = vjp(jnp.asarray(ct))
    f = t(flow).requires_grad_(True)
    TP.flow_project(f, fillhole=True).backward(t(ct))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=0, atol=GATOL)


def test_scatter_matches_pallas_interpret(rng):
    """Base scatter vs scatter_bands in interpret mode (test_pallas_scatter)."""
    B, H, W = 2, 32, 200
    flow = smooth_flow(rng, B, H, W, 1.5, invalid=False)
    valid, ixL, iyT = project_kernel.landing_cells(t(flow))
    ys = torch.arange(H, dtype=torch.int32).view(1, H, 1)
    xs = torch.arange(W, dtype=torch.int32).view(1, 1, W)
    payload = rng.randn(B, 3, H, W).astype(np.float32) * valid[:, None].numpy()
    plan = jsk.plan_bands(jnp.asarray((iyT - ys).numpy()), jnp.asarray((ixL - xs).numpy()),
                          jnp.asarray(valid.numpy()))
    assert bool(plan["ok"])
    want = np.asarray(jsk.scatter_bands(jnp.asarray(payload), plan, interpret=True))
    lin = torch.where(valid, iyT * W + ixL, torch.full_like(iyT, -1))
    got = project_kernel.scatter_reference(t(payload), lin).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("density", [0.15, 0.0])
def test_fill_matches_pallas_interpret(rng, density):
    """Hole fill vs fill_holes in interpret mode (test_pallas_fill), and vs
    the XLA scans."""
    B, H, W = 2, 24, 136
    cnt = (rng.rand(B, H, W) < density).astype(np.float32) * (1.0 + rng.rand(B, H, W))
    avg = rng.randn(B, 2, H, W).astype(np.float32) * (cnt > 0)[:, None]
    cnt = cnt.astype(np.float32)
    want = np.asarray(jfk.fill_holes(jnp.asarray(avg), jnp.asarray(cnt), interpret=True))
    want_xla = np.asarray(JP._directional_fill_xla(jnp.asarray(avg), jnp.asarray(cnt), False))
    got = project_kernel.fill_reference(t(avg), t(cnt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)


def test_flow_project_pallas_dispatch_matches(rng):
    """flow_project with the JAX package's Pallas scatter and fill forced
    (interpret mode) equals the port's."""
    flow = ((rng.rand(1, 2, 32, 128) - 0.5) * 30.0).astype(np.float32)
    jax.clear_caches()
    JP._fast_base_scatter.cache_clear()
    JP._FORCE_INTERPRET = True
    try:
        want = np.asarray(JP.flow_project(jnp.asarray(flow), fillhole=True))
    finally:
        JP._FORCE_INTERPRET = False
        JP._fast_base_scatter.cache_clear()
        jax.clear_caches()
    got = TP.flow_project(t(flow), fillhole=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- warp --------------------------------------------------------------------


@pytest.mark.parametrize("fs,amp", [(4, 6.0), (4, 0.0), (2, 3.0)])
def test_warp_split_matches_jax(rng, fs, amp):
    B, H, W = 2, 20, 36
    img0 = rng.rand(B, 3, H, W).astype(np.float32)
    img1 = rng.randn(B, 5, H, W).astype(np.float32)
    flow = smooth_flow(rng, B, H, W, amp)
    filt = rng.rand(B, fs * fs, H, W).astype(np.float32)
    cat = np.concatenate([img0, img1], 1)
    want = np.asarray(JW._xla_forward(jnp.asarray(cat), jnp.asarray(flow), jnp.asarray(filt), fs))
    got = TW.filter_interp_warp_split((t(img0), t(img1)), t(flow), t(filt), filter_size=fs)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=0, atol=ATOL)
    single = TW.filter_interp_warp(t(img0), t(flow), t(filt), filter_size=fs)
    np.testing.assert_array_equal(single.numpy(), got[0].numpy())


def test_warp_split_matches_pallas_interpret(rng):
    """Split warp vs the hcw2 band kernel in interpret mode (test_pallas_warp)."""
    B, H, W = 1, 16, 136
    img0 = rng.rand(B, 3, H, W).astype(np.float32)
    img1 = rng.rand(B, 8, H, W).astype(np.float32)
    flow = smooth_flow(rng, B, H, W, 4.0)
    filt = rng.rand(B, 16, H, W).astype(np.float32)
    want = JW._fast_forward_multi((jnp.asarray(img0), jnp.asarray(img1)), jnp.asarray(flow),
                                  jnp.asarray(filt), 4, interpret=True)
    got = TW.filter_interp_warp_split((t(img0), t(img1)), t(flow), t(filt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)


def test_warp_grad_matches_jax_vjp(rng):
    B, H, W = 1, 12, 20
    img = rng.rand(B, 4, H, W).astype(np.float32)
    flow = smooth_flow(rng, B, H, W, 3.0)
    filt = rng.rand(B, 16, H, W).astype(np.float32)
    ct = rng.randn(B, 4, H, W).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JW._xla_forward(a, b, c, 4),
                     jnp.asarray(img), jnp.asarray(flow), jnp.asarray(filt))
    want = vjp(jnp.asarray(ct))
    ins = [t(a).requires_grad_(True) for a in (img, flow, filt)]
    TW.filter_interp_warp(*ins).backward(t(ct))
    for x, w in zip(ins, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0, atol=GATOL)


def test_kernel_backward_is_autograd_of_plain_version(rng):
    """The autograd.Function backward helper equals autograd of the plain
    warp (it is what the CUDA path's backward runs)."""
    from memcnet_tpu_torch.ops.cuda import warp_kernel

    B, H, W = 1, 10, 14
    ims = (t(rng.rand(B, 3, H, W).astype(np.float32)), t(rng.rand(B, 2, H, W).astype(np.float32)))
    flow = t(smooth_flow(rng, B, H, W, 2.0))
    filt = t(rng.rand(B, 16, H, W).astype(np.float32))
    cts = [t(rng.randn(B, 3, H, W).astype(np.float32)), t(rng.randn(B, 2, H, W).astype(np.float32))]
    got = _lib.reference_grads(lambda fl, fi, *im: warp_kernel.reference(im, fl, fi, 4),
                               [flow, filt, *ims], [True, False, True, True], cts)
    assert got[1] is None
    xs = [x.clone().requires_grad_(True) for x in (flow, *ims)]
    outs = warp_kernel.reference(xs[1:], xs[0], filt, 4)
    want = torch.autograd.grad(outs, xs, cts)
    for g, w in zip([got[0], got[2], got[3]], want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_bf16_landing_cells_are_float32(rng):
    """A bf16 identity-filter warp with zero flow returns column 1001 at
    x=1001: landing coordinates are float32 (bf16 cannot hold 1001)."""
    H, W = 4, 1100
    src = torch.zeros(1, 1, H, W, dtype=torch.bfloat16)
    src[..., 1001] = 1.0
    flow = torch.zeros(1, 2, H, W, dtype=torch.bfloat16)
    filt = torch.zeros(1, 16, H, W, dtype=torch.bfloat16)
    filt[:, 5] = 1.0  # tap (1, 1) reads (int(y2), int(x2)) with weight 1 at zero flow
    out = TW.filter_interp_warp(src, flow, filt)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, src)
    valid, ixL, iyT = project_kernel.landing_cells(flow.float())
    assert int(ixL[0, 0, 1001]) == 1001 and bool(valid.all())


def test_bf16_spynet_warp_grid_is_float32():
    """A bf16 SPyNet warp with zero flow at W = 1344 returns column 1172 of
    the source to within one bf16 rounding: its base grid is float32.  (The
    JAX package builds it in bf16, spynet.py:77-81, and reads a column up to
    7 px away; ROADMAP.md Queue C.)"""
    from memcnet_tpu_torch.models import spynet as tspynet

    H, W = 4, 1344
    src = torch.zeros(1, 1, H, W, dtype=torch.bfloat16)
    src[..., 1172] = 1.0
    out = tspynet._backward_warp(src, torch.zeros(1, 2, H, W, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert float((out.float() - src.float()).abs().max()) <= 2.0 ** -8
    assert int(out[0, 0, 0].float().argmax()) == 1172


# -- ctx conv ------------------------------------------------------------------


@pytest.mark.parametrize("C,O,k,relu", [(3, 64, 7, False), (6, 32, 3, True), (8, 18, 5, True)])
def test_conv2d_small_matches_jax(rng, C, O, k, relu):
    x = rng.randn(2, C, 24, 40).astype(np.float32)
    w = (rng.randn(O, C, k, k) * 0.1).astype(np.float32)
    b = rng.randn(O).astype(np.float32) if relu else None
    want = np.asarray(jck._xla_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if b is None else jnp.asarray(b), relu))
    got = conv_kernel.conv2d_small(t(x), t(w), None if b is None else t(b), relu=relu).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_conv2d_small_matches_pallas_interpret(rng):
    x = rng.randn(2, 3, 24, 40).astype(np.float32)
    w = (rng.randn(32, 3, 7, 7) * 0.1).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    want = np.asarray(jck.conv2d_small(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       relu=True, interpret=True))
    got = conv_kernel.conv2d_small(t(x), t(w), t(b), relu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_ctx_forward_matches_jax(rng):
    x = rng.rand(2, 3, 32, 48).astype(np.float32)
    flat = {"ctxNet.conv1.weight": (rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)}
    want = np.asarray(jctx.forward({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(x)))
    net = tctx.ContextNet()
    load_jax_params(torch.nn.ModuleDict({"ctxNet": net}), flat)
    got = net(t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the conv itself is L.conv2d's 'same' conv
    y = (x - np.array([0.485] * 3, np.float32).reshape(1, 3, 1, 1)) / np.array(
        [0.229, 0.224, 0.224], np.float32).reshape(1, 3, 1, 1)
    ref = np.asarray(JL.conv2d(jnp.asarray(y), jnp.asarray(flat["ctxNet.conv1.weight"]), None,
                               stride=1, padding=3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


# -- the port's own rules ----------------------------------------------------

SLICE_MODULES = [
    "memcnet_tpu_torch", "memcnet_tpu_torch.cli.runner", "memcnet_tpu_torch.data.padding",
    "memcnet_tpu_torch.io.params", "memcnet_tpu_torch.models", "memcnet_tpu_torch.models.ctx",
    "memcnet_tpu_torch.models.edsr", "memcnet_tpu_torch.models.flownets",
    "memcnet_tpu_torch.models.memc_net", "memcnet_tpu_torch.models.mononet",
    "memcnet_tpu_torch.models.spynet",
    "memcnet_tpu_torch.nn.init", "memcnet_tpu_torch.nn.layers", "memcnet_tpu_torch.ops",
    "memcnet_tpu_torch.ops.cuda", "memcnet_tpu_torch.ops.cuda._lib",
    "memcnet_tpu_torch.ops.cuda.gather_kernel", "memcnet_tpu_torch.ops.cuda.project_kernel",
    "memcnet_tpu_torch.probe",
    "memcnet_tpu_torch.ops.projection", "memcnet_tpu_torch.ops.warp",
]


def _is_foreign(mod):
    return mod == "jax" or mod.startswith("jax.") or mod == "memcnet_tpu" \
        or mod.startswith("memcnet_tpu.")


def test_port_imports_no_jax_subprocess():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'memcnet_tpu' or m.startswith('memcnet_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax():
    """Static check over every module of the package and chip_smoke.py."""
    files = sorted((REPO / "memcnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_is_foreign(n) for n in names), (path, names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.build_model("MEMC_Net_star")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.PaddedInterp(torch.nn.Identity())
    assert TR.resolve_device("cpu").type == "cpu"


def test_get_model_lists_only_ported():
    assert TM.__all__ == ("MEMC_Net", "MEMC_Net_s", "MEMC_Net_star", "MEMC_Net_VE")
    for name in TM.__all__:
        assert isinstance(TM.get_model(name), torch.nn.Module)
    with pytest.raises(KeyError):
        TM.get_model("nope")


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros(1, 3, 8, 8)
    meta = torch.zeros(1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        _lib.on_cuda(x, meta)
