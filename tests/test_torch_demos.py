"""The port's three demos against the JAX package's, on the CPU in float32.

Each demo of memcnet_tpu_torch/cli runs with ``--device cpu`` on the same
synthetic fixture and the same ``--pretrained`` .pth as the JAX demo of the
same name.  The .pth holds the JAX package's ``init_params`` of one seed
(the two packages draw random weights from different generators, so only a
shared file makes their outputs comparable).  MEMC_Net_VE's EDSR rectifier,
kaiming-initialised, adds values in the thousands, which would turn nearly
every output byte into 0 or 255; in its .pth the rectifier's last conv is
scaled by VE_TAIL_SCALE, so fewer than half the bytes saturate and the
comparison sees the model's values.  MEMC_Net_star's xavier-initialised
rectifier needs no scaling.

Tolerances: output images and reconstructed stream frames within 1 level on
at most 0.5% of values (float32 sums in another order may flip a rounding);
ground-truth frames of the stream byte-equal; interpolation error within
0.01, PSNR within 0.05 dB, SSIM within 1e-3.  One JAX run per demo is shared
by the module's tests.
"""

import os
import subprocess
import sys

import imageio.v2 as iio
import jax.random as jr
import numpy as np
import pytest
import torch

from memcnet_tpu import models as JM
from memcnet_tpu.cli import demo_hd720p as jax_demo_hd720p
from memcnet_tpu.cli import demo_middlebury as jax_demo_middlebury
from memcnet_tpu.cli import demo_vimeo_ve as jax_demo_vimeo_ve
from memcnet_tpu.data.yuv import YUVWrite
from memcnet_tpu_torch.cli import demo_hd720p, demo_middlebury, demo_vimeo_ve
from memcnet_tpu_torch.probe import levels_apart, moving_frames

VE_TAIL_SCALE = 1e-3
SEQS = ("Alpha", "Beta")
HD_H, HD_W = 64, 128


def write_pth(path, net_name, tail_scale=1.0):
    """The JAX package's init_params(PRNGKey(0)) as a .pth state dict."""
    params = JM.get_model(net_name).init_params(jr.PRNGKey(0))
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}
    sd["rectifyNet.tail.0.weight"] *= tail_scale
    torch.save(sd, path)
    return str(path)


def only_subdir(d):
    (sub,) = os.listdir(d)
    return os.path.join(d, sub)


def saturated(u8):
    return float(np.mean((u8 == 0) | (u8 == 255)))


def assert_levels_close(got, want):
    """Within 1 level everywhere, and unequal on at most 0.5% of values."""
    most, share = levels_apart(got, want)
    print(f"  levels apart: at most {most}, on {share:.5f} of values")
    assert most <= 1 and share <= 0.005, (most, share)


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def star_pth(tmp_path_factory):
    return write_pth(tmp_path_factory.mktemp("pth") / "star.pth", "MEMC_Net_star")


@pytest.fixture(scope="module")
def middlebury(tmp_path_factory):
    root = tmp_path_factory.mktemp("middlebury")
    for i, name in enumerate(SEQS):
        f0, gt, f1 = moving_frames(10 + i, 3, 64, 96)
        for sub, fname, img in (("data", "frame10.png", f0), ("data", "frame11.png", f1),
                                ("gt", "frame10i11.png", gt)):
            os.makedirs(root / sub / name, exist_ok=True)
            iio.imwrite(str(root / sub / name / fname), img)
    return str(root / "data"), str(root / "gt")


@pytest.fixture(scope="module")
def hd_stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("hd") / "in.yuv"
    wr = YUVWrite(str(path))
    for f in moving_frames(3, 7, HD_H, HD_W):
        wr.write(f)
    wr.close()
    return str(path)


@pytest.fixture(scope="module")
def vimeo(tmp_path_factory):
    root = tmp_path_factory.mktemp("vimeo")
    frames = moving_frames(5, 7, 64, 96)
    seq = root / "sequences_sigma20_byMTLB" / "00001" / "0001"
    os.makedirs(seq)
    os.makedirs(root / "target" / "00001" / "0001")
    for i, f in enumerate(frames):
        iio.imwrite(str(seq / f"im{i + 1}.png"), f)
    iio.imwrite(str(root / "target" / "00001" / "0001" / "im4.png"), frames[3])
    return str(root)


def middlebury_args(data_gt, out, pth):
    data, gt = data_gt
    return ["--data-dir", data, "--gt-dir", gt, "--out-dir", str(out),
            "--net-name", "MEMC_Net_star", "--pretrained", pth]


def hd_args(src, out, pth):
    return ["--yuv", src, "--height", str(HD_H), "--width", str(HD_W), "--frames", "6",
            "--out-dir", str(out), "--net-name", "MEMC_Net_star", "--pretrained", pth,
            "--uid", "run"]


def ve_args(root, out, pth):
    return ["--root", root, "--out-dir", str(out), "--task", "denoise", "--pretrained", pth]


@pytest.fixture(scope="module")
def jax_middlebury(middlebury, star_pth, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mb")
    return jax_demo_middlebury.main(middlebury_args(middlebury, out, star_pth)), only_subdir(out)


@pytest.fixture(scope="module")
def jax_hd(hd_stream, star_pth, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_hd")
    return jax_demo_hd720p.main(hd_args(hd_stream, out, star_pth)), os.path.join(out, "run")


@pytest.fixture(scope="module")
def ve_pth(tmp_path_factory):
    return write_pth(tmp_path_factory.mktemp("pth") / "ve.pth", "MEMC_Net_VE", VE_TAIL_SCALE)


@pytest.fixture(scope="module")
def jax_vimeo(vimeo, ve_pth, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ve")
    return jax_demo_vimeo_ve.main(ve_args(vimeo, out, ve_pth)), str(out)


# ---------------------------------------------------------------- parity


def test_middlebury_demo_matches_jax(middlebury, star_pth, jax_middlebury, tmp_path, capsys):
    want, want_dir = jax_middlebury
    got = demo_middlebury.main(middlebury_args(middlebury, tmp_path, star_pth)
                               + ["--device", "cpu"])
    assert "interpolation error / PSNR" in capsys.readouterr().out
    got_dir = only_subdir(tmp_path)
    assert [r[0] for r in got] == [r[0] for r in want] == list(SEQS)
    for (_, ie, p), (_, ie_j, p_j) in zip(got, want):
        assert abs(ie - ie_j) <= 0.01 and abs(p - p_j) <= 0.05
    for name in SEQS:
        rec = iio.imread(os.path.join(got_dir, name, "frame10i11.png"))
        assert_levels_close(rec, iio.imread(os.path.join(want_dir, name, "frame10i11.png")))
        (diff_png,) = [f for f in os.listdir(os.path.join(got_dir, name)) if "_diff" in f]
        (diff_jax,) = [f for f in os.listdir(os.path.join(want_dir, name)) if "_diff" in f]
        assert_levels_close(iio.imread(os.path.join(got_dir, name, diff_png)),
                            iio.imread(os.path.join(want_dir, name, diff_jax)))
        share = saturated(rec)
        with capsys.disabled():
            print(f"middlebury {name}: saturated share {share:.4f}")
        assert share <= 0.5


def test_hd720p_demo_matches_jax(hd_stream, star_pth, jax_hd, tmp_path):
    (psnr_j, ssim_j), want_dir = jax_hd
    psnr_avg, ssim_avg = demo_hd720p.main(hd_args(hd_stream, tmp_path, star_pth)
                                          + ["--device", "cpu"])
    got_dir = os.path.join(tmp_path, "run")
    assert abs(psnr_avg - psnr_j) <= 0.05 and abs(ssim_avg - ssim_j) <= 1e-3
    for log, tol in (("in.yuv_psnr_Y.txt", 0.05), ("in.yuv_ssim_Y.txt", 1e-3)):
        got = np.loadtxt(os.path.join(got_dir, log))
        want = np.loadtxt(os.path.join(want_dir, log))
        assert got.shape == want.shape == (3,)
        assert float(np.abs(got - want).max()) <= tol
    frame = HD_H * HD_W * 3 // 2
    got = np.fromfile(os.path.join(got_dir, "in.yuv"), np.uint8).reshape(-1, frame)
    want = np.fromfile(os.path.join(want_dir, "in.yuv"), np.uint8).reshape(-1, frame)
    assert got.shape == want.shape == (6, frame)
    np.testing.assert_array_equal(got[0::2], want[0::2])  # ground truth, as read
    assert_levels_close(got[1::2], want[1::2])           # reconstructions
    share = saturated(got[1::2])
    print(f"hd720p: saturated share of the reconstructions' bytes {share:.4f}")
    assert share <= 0.5


def test_vimeo_ve_demo_matches_jax(vimeo, ve_pth, jax_vimeo, tmp_path):
    (psnr_j, ssim_j), want_dir = jax_vimeo
    p, s = demo_vimeo_ve.main(ve_args(vimeo, tmp_path, ve_pth) + ["--device", "cpu"])
    assert abs(p - psnr_j) <= 0.05 and abs(s - ssim_j) <= 1e-3
    rec = iio.imread(os.path.join(tmp_path, "00001", "0001", "im4.png"))
    assert_levels_close(rec, iio.imread(os.path.join(want_dir, "00001", "0001", "im4.png")))
    assert open(os.path.join(tmp_path, "metrics.txt")).read().startswith(
        "The average interpolation error / PSNR")
    share = saturated(rec)
    print(f"vimeo_ve: saturated share {share:.4f} (rectifier's last conv x {VE_TAIL_SCALE})")
    assert share <= 0.5


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("demo", ["middlebury", "hd720p", "vimeo_ve"])
def test_demos_run_on_cuda_by_default(demo, middlebury, hd_stream, vimeo, star_pth, ve_pth,
                                      tmp_path, monkeypatch):
    """Without --device every demo asks for the card, and raises where there
    is none; nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, args = {
        "middlebury": (demo_middlebury, middlebury_args(middlebury, tmp_path, star_pth)),
        "hd720p": (demo_hd720p, hd_args(hd_stream, tmp_path, star_pth)),
        "vimeo_ve": (demo_vimeo_ve, ve_args(vimeo, tmp_path, ve_pth)),
    }[demo]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)
    assert not os.listdir(tmp_path)


def test_bf16_reaches_the_compute_path(middlebury, star_pth, tmp_path, monkeypatch):
    """--dtype bfloat16 casts the weights and the inputs: the forward computes
    in bf16, not only the parameters."""
    made = []

    class Recording(demo_middlebury.PaddedInterp):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(demo_middlebury, "PaddedInterp", Recording)
    results = demo_middlebury.main(middlebury_args(middlebury, tmp_path, star_pth)
                                   + ["--device", "cpu", "--dtype", "bfloat16"])
    (fwd,) = made
    assert fwd.last_out_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in fwd.model.parameters())
    assert len(results) == 2 and all(np.isfinite(r[2]) for r in results)


def test_trace_dir_writes_a_trace(hd_stream, star_pth, tmp_path):
    trace = tmp_path / "trace"
    demo_hd720p.main(hd_args(hd_stream, tmp_path / "out", star_pth)
                     + ["--device", "cpu", "--frames", "2", "--trace-dir", str(trace)])
    path = trace / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "traceEvents" in path.read_text()[:2000]


def test_port_imports_no_jax():
    """Importing every module of memcnet_tpu_torch pulls in neither jax nor
    the JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import memcnet_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'memcnet_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'memcnet_tpu')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 30 else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
