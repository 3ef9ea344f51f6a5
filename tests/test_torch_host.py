"""The port's host modules against the JAX package's, on the CPU.

Metrics, YUV streams, config, the .pth import, the GOP scheduler and the
dataset readers of memcnet_tpu_torch are copies of the JAX package's (the port
imports nothing of it); each is held here against its counterpart on inputs
made from a seed with numpy, bit for bit.  The PNG codec (io/png.py, which
replaces imageio in the port) is held against imageio; the checkpoint round
trip and the Vimeo-90K prefetch's error path against themselves.
"""

import dataclasses
import os
import struct
import threading
import zlib

import imageio.v2 as iio
import jax.random as jr
import numpy as np
import pytest
import torch
from PIL import Image

from memcnet_tpu import data as JD
from memcnet_tpu import metrics as JMet
from memcnet_tpu import models as JM
from memcnet_tpu.data import vimeo90k as jax_vimeo
from memcnet_tpu.io import pth_import as jax_pth
from memcnet_tpu.parallel import gop as jax_gop
from memcnet_tpu.utils import config as jax_config
from memcnet_tpu.utils import tracing as jax_tracing
from memcnet_tpu_torch import data as TD
from memcnet_tpu_torch import metrics as TMet
from memcnet_tpu_torch.cli.runner import build_from_config, build_model
from memcnet_tpu_torch.data import vimeo90k as torch_vimeo
from memcnet_tpu_torch.io import checkpoint, png
from memcnet_tpu_torch.io import pth_import as torch_pth
from memcnet_tpu_torch.io.params import load_jax_params
from memcnet_tpu_torch.parallel import gop as torch_gop
from memcnet_tpu_torch.probe import moving_frames
from memcnet_tpu_torch.utils import config as torch_config
from memcnet_tpu_torch.utils import tracing as torch_tracing

SIZES = [(7, 9), (16, 24), (33, 17)]


def u8(rng, *shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("h,w", SIZES)
def test_metrics_equal_jax_bit_for_bit(h, w):
    rng = np.random.RandomState(h * w)
    rec, gt = u8(rng, h, w, 3), u8(rng, h, w, 3)
    y = rng.rand(3, h, w) * 1.4 - 0.2  # outside [0, 1] too: the clip
    np.testing.assert_array_equal(TMet.to_uint8_frame(y), JMet.to_uint8_frame(y))
    np.testing.assert_array_equal(TMet.to_uint8_frame(y.astype(np.float32)),
                                  JMet.to_uint8_frame(y.astype(np.float32)))
    assert TMet.interp_error(rec, gt) == JMet.interp_error(rec, gt)
    assert TMet.psnr(rec, gt) == JMet.psnr(rec, gt)
    assert TMet.psnr(gt, gt) == JMet.psnr(gt, gt) == 100.0
    assert TMet.ssim(rec, gt, multichannel=True) == JMet.ssim(rec, gt, multichannel=True)
    assert TMet.ssim(rec[..., 0], gt[..., 0]) == JMet.ssim(rec[..., 0], gt[..., 0])
    rf, gf = rec.astype(np.float64) / 255.0, gt.astype(np.float64) / 255.0
    assert TMet.ssim(rf, gf, multichannel=True) == JMet.ssim(rf, gf, multichannel=True)
    assert TMet.ssim(rf[..., 1], gf[..., 1]) == JMet.ssim(rf[..., 1], gf[..., 1])
    np.testing.assert_array_equal(TMet.rgb2yuv(rf), JMet.rgb2yuv(rf))
    yuv = JMet.rgb2yuv(rf)
    np.testing.assert_array_equal(TMet.yuv2rgb(yuv), JMet.yuv2rgb(yuv))
    np.testing.assert_array_equal(TMet.y_channel_u8(rec), JMet.y_channel_u8(rec))


def test_average_meter_and_stage_timers_match_jax():
    vals = [0.5, 2.0, 3.25]
    tm, jm = TMet.AverageMeter(), JMet.AverageMeter()
    for i, v in enumerate(vals):
        tm.update(v, n=i + 1)
        jm.update(v, n=i + 1)
    assert vars(tm) == vars(jm)
    tt, jt = torch_tracing.StageTimers(), jax_tracing.StageTimers()
    for t in (tt, jt):
        for _ in range(3):
            with t.item():
                with t.model():
                    pass
    assert tt.total.count == jt.total.count == 3 and tt.proc.count == 3
    for t in (tt, jt):
        t.proc.avg, t.total.avg = 0.0123, 0.0456
    assert tt.summary() == jt.summary()
    with torch_tracing.device_trace(None):
        pass


# ---------------------------------------------------------------- YUV


def write_stream(writer_cls, path, frames, **kw):
    wr = writer_cls(str(path), **kw)
    for f in frames:
        wr.write(f)
    wr.close()
    return open(path, "rb").read()


@pytest.mark.parametrize("h,w", [(8, 12), (24, 40)])
@pytest.mark.parametrize("rgb", [True, False])
def test_yuv_streams_cross_read(tmp_path, h, w, rgb):
    rng = np.random.RandomState(h + w)
    frames = [u8(rng, h, w, 3) for _ in range(3)]
    kw = {} if rgb else {"from_rgb": False}
    mine = write_stream(TD.YUVWrite, tmp_path / "port.yuv", frames, **kw)
    theirs = write_stream(JD.YUVWrite, tmp_path / "jax.yuv", frames, **kw)
    assert mine == theirs and len(mine) == 3 * h * w * 3 // 2
    for src in ("port.yuv", "jax.yuv"):
        tr = TD.YUVRead(str(tmp_path / src), h, w, to_rgb=rgb)
        jr_ = JD.YUVRead(str(tmp_path / src), h, w, to_rgb=rgb)
        assert tr.num_frames() == jr_.num_frames() == 3
        for i in (2, 0, 1):
            a, ok_a = tr.read(i)
            b, ok_b = jr_.read(i)
            assert ok_a and ok_b
            np.testing.assert_array_equal(a, b)
        assert tr.read(3) == (None, False) and jr_.read(3) == (None, False)
        tr.close()
        jr_.close()


def test_yuv_short_read(tmp_path):
    path = tmp_path / "short.yuv"
    path.write_bytes(bytes(8 * 12 * 3 // 2 + 10))  # one frame and a part of the next
    r = TD.YUVRead(str(path), 8, 12)
    assert r.read(0)[1] is True
    assert r.read() == (None, False)
    assert r.read(5) == (None, False)
    r.close()


# ---------------------------------------------------------------- PNG


def sample_image(rng, h, w, ch):
    """Noise, gradients, flat bands and a running-average texture: content
    on which an adaptive PNG encoder picks different filters."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w, ch), np.int64)
    for c in range(ch):
        img[..., c] = (3 * xs + 2 * ys + 40 * c) % 256
        img[4:10, :, c] = rng.randint(0, 256, (6, w))
        img[10:12, :, c] = rng.randint(0, 3, (2, w))  # near-flat noise: Paeth's ties
        img[12:16, :, c] = 7
        img[16:20, :, c] = (5 * xs[16:20]) % 256
    for y in range(21, h):
        for x in range(1, w):
            img[y, x] = (img[y, x - 1] + img[y - 1, x]) // 2 + rng.randint(0, 2, ch)
    img = (img % 256).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def filter_types(path):
    return set(row_filters(path))


def row_filters(path):
    """The filter type of each row of a PNG file, top to bottom."""
    data = open(path, "rb").read()
    header = struct.unpack(">IIBBBBB", data[16:29])
    w, h, ch = header[0], header[1], {0: 1, 2: 3, 6: 4}[header[3]]
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return [raw[y * (w * ch + 1)] for y in range(h)]


def encode_with_filter(img, ftype):
    """A PNG whose every row carries filter type ``ftype`` (PNG spec 9.2)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    colour = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_reads_what_imageio_writes(tmp_path, ch):
    img = sample_image(np.random.RandomState(ch), 30, 23, ch)
    path = str(tmp_path / "im.png")
    iio.imwrite(path, img)
    assert {1, 2, 4} <= filter_types(path)  # the encoder's adaptive choices
    got = png.imread(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, iio.imread(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_reads_each_filter_type(tmp_path, ch, ftype):
    """Every row under one filter type, imageio as the oracle of the file:
    this covers Average (3), which imageio's encoder does not choose."""
    img = sample_image(np.random.RandomState(10 + ch), 26, 19, ch)
    path = tmp_path / "im.png"
    path.write_bytes(encode_with_filter(img, ftype))
    assert filter_types(str(path)) == {ftype}
    np.testing.assert_array_equal(iio.imread(str(path)), img)
    np.testing.assert_array_equal(png.imread(str(path)), img)


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_imageio_reads_what_the_port_writes(tmp_path, ch):
    img = sample_image(np.random.RandomState(20 + ch), 25, 31, ch)
    path = str(tmp_path / "im.png")
    png.imwrite(path, img)
    assert filter_types(path) == {0}
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(png.imread(path), img)


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_imageio_reads_what_the_port_writes_adaptive(tmp_path, ch):
    """The writer's adaptive filters, as libpng picks them: Paeth on most rows
    of a textured frame (the rows the plain reader takes one Python step per
    byte for), other types elsewhere."""
    if ch == 1:
        img = sample_image(np.random.RandomState(30), 21, 33, ch)
    else:
        img = np.ascontiguousarray(moving_frames(ch, 1, 21, 33)[0])
        if ch == 4:
            img = np.concatenate([img, img[..., :1]], axis=2)
    path = str(tmp_path / "im.png")
    png.imwrite(path, img, adaptive=True)
    kinds = row_filters(path)
    assert len(set(kinds)) > 1 if ch == 1 else np.mean(np.array(kinds) == 4) > 0.5
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(png.imread(path), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    rng = np.random.RandomState(0)
    Image.fromarray(u8(rng, 6, 7), mode="L").convert("P").save(tmp_path / "palette.png")
    Image.fromarray(rng.randint(0, 65536, (6, 7)).astype(np.uint16)).save(tmp_path / "d16.png")
    good = encode_with_filter(u8(rng, 6, 7, 3), 0)
    ihdr = bytearray(good[8:33])
    ihdr[20] = 1  # interlace method: Adam7
    ihdr[21:25] = struct.pack(">I", zlib.crc32(bytes(ihdr[4:21])))
    (tmp_path / "interlaced.png").write_bytes(good[:8] + bytes(ihdr) + good[33:])
    for name, what in (("palette", "palette"), ("d16", "16-bit"), ("interlaced", "interlaced")):
        with pytest.raises(ValueError, match=what):
            png.imread(str(tmp_path / f"{name}.png"))
    with pytest.raises(ValueError):
        png.imwrite(str(tmp_path / "f.png"), np.zeros((4, 4, 3), np.float32))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("argv", [
    [],
    ["--net-name", "MEMC_Net_s", "--seed", "3", "--task", "sr", "--dtype", "bfloat16",
     "--pretrained", "w.pth", "--save-which", "0", "--filter-size", "2", "--channels", "3",
     "--uid", "u7"],
])
def test_config_from_argv_matches_jax(argv):
    """The port's config holds the JAX config's serving fields and the
    trainer's fields the port reads: the same names, types and defaults,
    and the same values from the same argv."""
    import argparse

    cfgs = []
    for mod in (torch_config, jax_config):
        ap = mod.add_config_args(argparse.ArgumentParser())
        cfgs.append(dataclasses.asdict(mod.config_from_args(ap.parse_args(argv), seed=4)))
    assert cfgs[0] == {k: cfgs[1][k] for k in cfgs[0]}
    jax_fields = {f.name: (str(f.type), f.default) for f in dataclasses.fields(jax_config.Config)}
    assert {f.name: (str(f.type), f.default) for f in dataclasses.fields(torch_config.Config)} == \
        {k: jax_fields[k] for k in cfgs[0]}
    assert set(cfgs[0]) == {"net_name", "seed", "channels", "filter_size", "task", "save_which",
                            "pretrained", "uid", "dtype", "lr", "epsilon", "alpha"}


class _FrozenClock:
    """Stands in for the ``datetime`` module of a config module: ``now()``
    is one fixed time."""

    class datetime:
        @staticmethod
        def now():
            import datetime

            return datetime.datetime(2026, 3, 7, 9, 5, 41)


@pytest.mark.parametrize("uid", ["u7", None])
def test_make_run_dir_matches_jax(uid, tmp_path, monkeypatch):
    """``Config.make_run_dir(root)`` makes the JAX method's directory under
    ``root`` in place of ``save_path``: the same ``<uid>-<%a-%b-%d-%H:%M>``
    name on a frozen clock (without a uid, the port's seeded
    ``random.Random`` draws the integer that the JAX method draws from the
    global ``random`` seeded alike), and an ``args.txt`` equal to the JAX
    one on the port's fields."""
    import json
    import random

    for mod in (torch_config, jax_config):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)
    kw = dict(net_name="MEMC_Net_s", seed=3, task="sr", uid=uid, dtype="bfloat16",
              alpha=(1.0, 0.5))
    state = random.getstate()
    try:
        random.seed(11)
        jax_dir = jax_config.Config(save_path=str(tmp_path / "jax"), **kw).make_run_dir()
    finally:
        random.setstate(state)
    port_dir = torch_config.Config(**kw).make_run_dir(str(tmp_path / "port"),
                                                      rng=random.Random(11))
    assert os.path.dirname(port_dir) == str(tmp_path / "port")
    name = os.path.basename(port_dir)
    assert name == os.path.basename(jax_dir)
    assert name.endswith("-Sat-Mar-07-09:05") and (uid is None or name.startswith(uid + "-"))
    with open(os.path.join(jax_dir, "args.txt")) as f:
        jax_args = json.load(f)
    with open(os.path.join(port_dir, "args.txt")) as f:
        port_args = json.load(f)
    assert port_args == {k: jax_args[k] for k in port_args}
    assert set(port_args) == {f.name for f in dataclasses.fields(torch_config.Config)}
    # exist_ok: a second call on the same uid and minute returns the same directory
    again = torch_config.Config(**kw).make_run_dir(str(tmp_path / "port"), rng=random.Random(11))
    assert again == port_dir


def test_make_run_dir_draws_the_uid_from_its_rng(tmp_path):
    """Without a uid, one seed gives one uid twice; a fresh generator is made
    where none is given."""
    import random

    cfg = torch_config.Config()
    uids = [os.path.basename(cfg.make_run_dir(str(tmp_path / str(k)),
                                              rng=random.Random(5))).split("-")[0]
            for k in range(2)]
    assert uids[0] == uids[1] == str(random.Random(5).randint(0, 100000))
    free = os.path.basename(cfg.make_run_dir(str(tmp_path / "free"))).split("-")[0]
    assert 0 <= int(free) <= 100000


@pytest.mark.parametrize("flag", ["--lr", "--batch-size", "--num-epoch", "--task-param",
                                  "--alpha", "--dataset-path"])
def test_demos_refuse_trainer_flags(flag, monkeypatch):
    """A flag of the JAX demos that the port's demo does not read is
    accepted and ignored, as the JAX demos do: the run gets the config of
    the same command line without it (``--lr`` and ``--alpha`` set the
    trainer's fields, which the demo does not read)."""
    from memcnet_tpu_torch.cli import demo_hd720p

    seen = []
    monkeypatch.setattr(demo_hd720p, "run", lambda cfg, *a, **k: seen.append(cfg))
    demo_hd720p.main(["--yuv", "x.yuv", flag, "1", "--device", "cpu"])
    demo_hd720p.main(["--yuv", "x.yuv", "--device", "cpu"])
    got, plain = (dataclasses.asdict(c) for c in seen)
    name = flag[2:].replace("-", "_")
    if name in plain:
        assert got.pop(name) != plain.pop(name)
    assert got == plain


# ---------------------------------------------------------------- .pth import


@pytest.fixture(scope="module")
def memc_params():
    """The JAX package's MEMC_Net init (BatchNorm MonoNets: the port's module
    has num_batches_tracked buffers the JAX dict lacks)."""
    flat = JM.get_model("MEMC_Net").init_params(jr.PRNGKey(3))
    return {k: np.array(v, np.float32) for k, v in flat.items()}


def port_memc():
    return build_model("MEMC_Net", seed=5, device="cpu")


def both_imports(state, strict=False, tmp_path=None):
    """(port module, port report), (JAX params, JAX report) of one state."""
    path = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    module, report = torch_pth.import_pth(port_memc(), path, strict=strict)
    jparams = JM.get_model("MEMC_Net").init_params(jr.PRNGKey(4))
    jnew, jreport = jax_pth.import_pth(jparams, path, strict=strict)
    return (module, report), (jnew, jreport)


def assert_same_report(report, jreport):
    """loaded and skipped in the file's order, as the JAX package lists them;
    missing in the module's order, the JAX package's in its parameter
    dict's, so they are compared as sets."""
    assert report["loaded"] == jreport["loaded"]
    assert report["skipped"] == jreport["skipped"]
    assert sorted(report["missing"]) == sorted(jreport["missing"])
    assert len(report["missing"]) == len(set(report["missing"]))


def test_pth_import_full_matches_load_jax_params(memc_params, tmp_path):
    (module, report), (jnew, jreport) = both_imports(memc_params, tmp_path=tmp_path)
    assert_same_report(report, jreport)
    assert report["loaded"] == list(memc_params) and not report["skipped"] and not report["missing"]
    want = load_jax_params(port_memc(), memc_params).state_dict()
    got = module.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in jnew.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_pth_import_partial_extra_and_missing(memc_params, tmp_path):
    keys = list(memc_params)
    state = {k: memc_params[k] for i, k in enumerate(keys) if i % 3}
    state["extra.weight"] = np.zeros((2, 2), np.float32)
    state["moduleBN.num_batches_tracked"] = np.array(7)  # counted on neither side
    fresh = port_memc().state_dict()
    (module, report), (_, jreport) = both_imports(state, tmp_path=tmp_path)
    assert_same_report(report, jreport)
    assert report["skipped"] == ["extra.weight"]
    assert sorted(report["missing"]) == sorted(k for i, k in enumerate(keys) if not i % 3)
    got = module.state_dict()
    for k in report["missing"]:
        assert torch.equal(got[k], fresh[k]), k  # keeps its init
    for k in report["loaded"]:
        np.testing.assert_array_equal(got[k].numpy(), memc_params[k])


def test_pth_import_refuses_a_shape_mismatch_and_strict_gaps(memc_params, tmp_path):
    k0 = next(iter(memc_params))
    bad = dict(memc_params)
    bad[k0] = np.zeros((1,) + memc_params[k0].shape, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        both_imports(bad, tmp_path=tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_pth.import_state_dict({k0: memc_params[k0]}, {k0: bad[k0]})
    for state in ({**memc_params, "extra.weight": np.zeros(2, np.float32)},
                  {k: v for k, v in memc_params.items() if k != k0}):
        with pytest.raises(KeyError, match="strict"):
            torch_pth.import_state_dict(port_memc(), state, strict=True)
        with pytest.raises(KeyError, match="strict"):
            jax_pth.import_state_dict(memc_params, state, strict=True)
    (_, report), (_, jreport) = both_imports(memc_params, strict=True, tmp_path=tmp_path)
    assert_same_report(report, jreport)


def test_pth_wrapper_and_build_from_config(memc_params, tmp_path):
    path = str(tmp_path / "wrapped.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in memc_params.items()},
                "epoch": 3}, path)
    loaded = torch_pth.load_pth_state_dict(path)
    assert set(loaded) == set(memc_params)
    for k, v in jax_pth.load_pth_state_dict(path).items():
        np.testing.assert_array_equal(loaded[k], v)
    cfg = torch_config.Config(net_name="MEMC_Net", pretrained=path, dtype="bfloat16")
    model = build_from_config(cfg, device="cpu")
    k0 = next(iter(memc_params))
    assert model.state_dict()[k0].dtype == torch.bfloat16
    assert torch.equal(model.state_dict()[k0], torch.from_numpy(memc_params[k0]).bfloat16())


def test_checkpoint_round_trip(tmp_path):
    model = port_memc()
    with torch.no_grad():
        for b in model.buffers():
            if b.dtype == torch.long:
                b.fill_(11)
    opt = {"state": {0: {"exp_avg": torch.ones(3)}}, "param_groups": [{"lr": 2e-3}]}
    path = checkpoint.save(str(tmp_path / "ckpt.pt"), model, opt_state=opt, step=42)
    ck = checkpoint.load(path)
    assert set(ck) == {"params", "opt_state", "step"} and ck["step"] == 42
    assert torch.equal(ck["opt_state"]["state"][0]["exp_avg"], torch.ones(3))
    other = build_model("MEMC_Net", seed=9, device="cpu")
    checkpoint.load_params(other, ck["params"])
    for (k, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    # a state dict without num_batches_tracked, and the config's pretrained path
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    path2 = checkpoint.save(str(tmp_path / "sd.pt"), sd)
    assert set(checkpoint.load(path2)) == {"params"}
    built = build_from_config(torch_config.Config(net_name="MEMC_Net", seed=9, pretrained=path2),
                              device="cpu")
    for k, v in sd.items():
        assert torch.equal(built.state_dict()[k], v), k


# ---------------------------------------------------------------- GOPs


def gop_tuples(gops):
    return [(g.gop_id, g.start, g.stop, g.step, g.pairs()) for g in gops]


@pytest.mark.parametrize("n,gop_len,step", [(101, 16, 2), (7, 16, 2), (9, 4, 2), (40, 9, 3),
                                            (3, 16, 2), (17, 16, 2)])
def test_split_gops_matches_jax(n, gop_len, step):
    assert gop_tuples(torch_gop.split_gops(n, gop_len, step)) == \
        gop_tuples(jax_gop.split_gops(n, gop_len, step))


def test_gop_scheduler_journal_restart_matches_jax(tmp_path):
    for nproc in (1, 3):
        for slot in range(nproc):
            journals = {}
            for tag, mod in (("port", torch_gop), ("jax", jax_gop)):
                journal = str(tmp_path / f"{tag}_{nproc}_{slot}.txt")
                s = mod.GopScheduler(101, gop_len=16, step=2, process_index=slot,
                                     process_count=nproc, journal_path=journal)
                for g in s.pending()[:2]:
                    s.mark_done(g)
                again = mod.GopScheduler(101, gop_len=16, step=2, process_index=slot,
                                         process_count=nproc, journal_path=journal)
                journals[tag] = (gop_tuples(again.local_gops()), gop_tuples(again.pending()),
                                 again.progress(), open(journal).read())
            assert journals["port"] == journals["jax"]
    s = torch_gop.GopScheduler(9)  # no torch.distributed process group: one process
    assert (s.process_index, s.process_count) == (0, 1)


def test_stitch_parts_matches_jax(tmp_path):
    h, w, n, gop_len, nproc = 4, 6, 30, 8, 3
    frame = h * w * 3 // 2
    rng = np.random.RandomState(1)
    gops = torch_gop.split_gops(n, gop_len)
    chunks = [u8(rng, len(g.pairs()) * 2 * frame).tobytes() for g in gops]
    parts = []
    for p in range(nproc):
        path = str(tmp_path / f"s.part{p}")
        with open(path, "wb") as f:
            f.write(b"".join(c for g, c in zip(gops, chunks) if g.gop_id % nproc == p))
        parts.append(path)
    kw = dict(n_frames=n, height=h, width=w, gop_len=gop_len)
    torch_gop.stitch_parts(parts, str(tmp_path / "port.yuv"), **kw)
    jax_gop.stitch_parts(parts, str(tmp_path / "jax.yuv"), **kw)
    got = (tmp_path / "port.yuv").read_bytes()
    assert got == (tmp_path / "jax.yuv").read_bytes() == b"".join(chunks)
    with open(parts[1], "r+b") as f:
        f.truncate(frame)
    with pytest.raises(ValueError, match="truncated"):
        torch_gop.stitch_parts(parts, str(tmp_path / "bad.yuv"), **kw)


# ---------------------------------------------------------------- readers


def png_at(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    iio.imwrite(path, img)


def assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, (list, tuple)):
            assert_items_equal(a, b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_middlebury_reader_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    data, gt = str(tmp_path / "data"), str(tmp_path / "gt")
    for name, ch, has_gt in (("Army", 3, True), ("Dog", 4, True), ("Walk", 3, False)):
        for f in ("frame10.png", "frame11.png"):
            png_at(os.path.join(data, name, f), u8(rng, 9, 13, ch))
        if has_gt:
            png_at(os.path.join(gt, name, "frame10i11.png"), u8(rng, 9, 13, 3))
    got_ds, want_ds = TD.MiddleburyOther(data, gt), JD.MiddleburyOther(data, gt)
    assert got_ds.names == want_ds.names and len(got_ds) == 3
    got, want = list(got_ds), list(want_ds)
    assert [g[3] for g in got] == ["Army", "Walk"]  # the RGBA sequence is skipped
    assert got[1][2] is None
    assert_items_equal(got, want)


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.RandomState(2)
    for task_dir in torch_vimeo.TASK_DIRS.values():
        for vid, seqs in (("00001", ("0001", "0002")), ("00002", ("0007",))):
            for seq in seqs:
                for i in range(7):
                    png_at(str(root / task_dir / vid / seq / f"im{i + 1}.png"), u8(rng, 6, 10, 3))
                png_at(str(root / "target" / vid / seq / "im4.png"), u8(rng, 6, 10, 3))
    (root / "sequences_sigma20_byMTLB" / "readme.txt").write_text("not a video")
    return str(root)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("task", sorted(torch_vimeo.TASK_DIRS))
def test_vimeo90k_reader_matches_jax(vimeo_root, task, prefetch):
    assert torch_vimeo.TASK_DIRS == jax_vimeo.TASK_DIRS
    paths = torch_vimeo.list_sequences(vimeo_root, task)
    assert paths == jax_vimeo.list_sequences(vimeo_root, task) and len(paths) == 3
    got = list(torch_vimeo.Vimeo90K(vimeo_root, task, prefetch=prefetch))
    want = list(jax_vimeo.Vimeo90K(vimeo_root, task, prefetch=prefetch))
    assert_items_equal(got, want)
    short = {"denoise": "dn", "sr": "sr", "deblock": "db"}[task]
    ds = TD.DATASETS[f"Vimeo_90K_{short}"](vimeo_root, prefetch=prefetch)
    assert ds.task == task and len(ds) == 3
    assert sorted(TD.DATASETS) == sorted(JD.DATASETS)


def test_vimeo_triplet_matches_jax(vimeo_root):
    kw = dict(crop=(4, 8), seed=3, frames=("im1.png", "im4.png", "im7.png"))
    root = os.path.join(vimeo_root, "sequences_blur_byMTLB")
    got, want = torch_vimeo.VimeoTriplet(root, **kw), jax_vimeo.VimeoTriplet(root, **kw)
    assert got.paths == want.paths and len(got) == 3
    assert_items_equal([got[i] for i in range(3)], [want[i] for i in range(3)])
    assert_items_equal(list(got.batches(2, epochs=2)), list(want.batches(2, epochs=2)))


def test_vimeo_prefetch_raises_a_read_error_in_the_consumer(vimeo_root, tmp_path):
    """A missing target in the second window: the prefetch thread hands the
    error to the consumer, which raises it (the JAX reader hangs here)."""
    import shutil

    root = tmp_path / "vimeo"
    shutil.copytree(vimeo_root, root)
    os.remove(root / "target" / "00001" / "0002" / "im4.png")
    seen, caught = [], []

    def consume():
        try:
            for item in torch_vimeo.Vimeo90K(str(root), "denoise", prefetch=2):
                seen.append(item[2])
        except FileNotFoundError as e:
            caught.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the consumer hangs on a failed read"
    assert seen == ["00001/0001"] and len(caught) == 1 and "im4.png" in str(caught[0])


def test_vimeo_prefetch_stops_with_an_early_consumer(vimeo_root):
    """A consumer that stops after one window ends the prefetch thread."""
    before = threading.active_count()
    it = iter(torch_vimeo.Vimeo90K(vimeo_root, "sr", prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_vbm4d_and_bayessr_readers_match_jax(tmp_path):
    from memcnet_tpu.data import vbm4d as jax_vbm4d
    from memcnet_tpu_torch.data import vbm4d as torch_vbm4d

    rng = np.random.RandomState(4)
    root = str(tmp_path / "vbm4d")
    for video in ("gbus", "gmissa"):
        for i in range(1, 5):
            name = f"f{i:04d}.png"
            for d in ("noisy_sigma20_imgs_3ch", "blocky_H264qp35_imgs", "noise_free_imgs"):
                png_at(os.path.join(root, d, video, name), u8(rng, 5, 8, 3))
    for task, param in (("denoise", (20,)), ("deblock", (35,))):
        got = list(TD.VBM4D(root, task, task_param=param))
        want = list(JD.VBM4D(root, task, task_param=param))
        assert len(got) == 8
        assert_items_equal(got, want)
    with pytest.raises(ValueError):
        torch_vbm4d.input_dir(root, "sr", (4,))
    assert torch_vbm4d.VIDEOS == jax_vbm4d.VIDEOS

    bayes = str(tmp_path / "bayes")
    for video, n in (("city", 5), ("walk", 2)):
        for i in range(n):
            png_at(os.path.join(bayes, video, "original", f"{i:03d}.png"), u8(rng, 5, 8, 3))
    got, want = list(TD.BayesSR(bayes)), list(JD.BayesSR(bayes))
    assert len(got) == 7
    assert_items_equal(got, want)
