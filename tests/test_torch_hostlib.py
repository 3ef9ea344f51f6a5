"""The port's host library against the JAX package's: the native YUV
library (memcnet_tpu_torch/native, built with g++ at first use), the Torch7
.t7 import and the flow visualisation, and the HD720p demo reading through
the native reader.

The JAX package builds its library in place, with no lock, the first time
a process asks for it, and a process that loads a half-written file reports
the library unavailable for the rest of its life (ROADMAP.md Queue C).  Under
xdist several workers race for that build, so where the JAX binding reports
no library in this worker, ``jax_native`` binds the JAX package's own,
unmodified source built with the same flags into a private directory
(written, then renamed) for the module's duration.

Tolerances: the native functions and reader byte-equal to the JAX
package's native ones (the same C++ built from a copy of the source), and
within 1 level of the numpy ``data.yuv`` oracle (float64 rounding at a
truncation, as tests/test_native.py holds the JAX ones); the .t7 import and
flowviz exactly equal to the JAX package's.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from memcnet_tpu import native as jnative
from memcnet_tpu.io import t7_import as jt7
from memcnet_tpu.utils import flowviz as jviz

from memcnet_tpu_torch import native
from memcnet_tpu_torch.cli import demo_hd720p
from memcnet_tpu_torch.data.yuv import YUVRead, YUVWrite
from memcnet_tpu_torch.io import import_spynet_t7, load_t7_tensor, save_t7_tensor
from memcnet_tpu_torch.metrics import y_channel_u8
from memcnet_tpu_torch.models import spynet
from memcnet_tpu_torch.probe import moving_frames
from memcnet_tpu_torch.utils import flowviz as tviz


def private_jax_native(directory):
    """The JAX package's yuv_native.cpp, unmodified, built with its flags (the
    port's ``CXX_FLAGS`` are the same) into ``directory`` -- written under a
    temporary name, then renamed -- loaded and declared as the JAX binding
    declares it (``native._declare``: the same API)."""
    lib_path = directory / "libmemcnet_native.so"
    if not lib_path.exists():
        tmp = directory / f"libmemcnet_native.so.tmp{os.getpid()}"
        subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(tmp), jnative._SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    native._declare(lib)
    return lib


def bind_jax_native(mp, directory):
    """Where the JAX binding reports no library in this worker (it lost the
    build race), bind ``private_jax_native(directory)`` into it through the
    MonkeyPatch ``mp``.  Returns True if it bound one."""
    if jnative.available():
        return False
    mp.setattr(jnative, "_lib", private_jax_native(directory))
    return True


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library in this worker, whatever another
    worker's in-place build did to it."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native libraries are built at first use")
    with pytest.MonkeyPatch.context() as mp:
        bind_jax_native(mp, tmp_path_factory.mktemp("jax_native"))
        yield jnative


@pytest.fixture
def built(jax_native):
    assert native.available(), native.build_error()
    assert jax_native.available()


def write_stream(path, frames_yuv):
    with open(path, "wb") as f:
        for planes in frames_yuv:
            for p in planes:
                p.tofile(f)
    return str(path)


def rand_frame(rng, h, w):
    return (rng.randint(0, 256, (h, w)).astype(np.uint8),
            rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8))


def within_a_level(got, want):
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------- native


def test_native_builds_into_the_build_dir(built):
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT and lib.exists()
    assert native.build_error() is None
    assert native.build() == lib  # keyed by the source: built once


def test_native_conversions_byte_equal_jax(built, rng, tmp_path):
    h, w = 16, 24
    y, u, v = rand_frame(rng, h, w)
    rgb = native.yuv420_to_rgb(y, u, v)
    np.testing.assert_array_equal(rgb, jnative.yuv420_to_rgb(y, u, v))
    ref = YUVRead(write_stream(tmp_path / "s.yuv", [(y, u, v)]), h, w)
    want, ok = ref.read(0)
    ref.close()
    assert ok
    within_a_level(rgb, want)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for got, jwant in zip(native.rgb_to_yuv420(img), jnative.rgb_to_yuv420(img)):
        np.testing.assert_array_equal(got, jwant)
    wr = YUVWrite(str(tmp_path / "o.yuv"))
    wr.write(img)
    wr.close()
    raw = np.fromfile(tmp_path / "o.yuv", np.uint8)
    within_a_level(native.rgb_to_yuv420(img)[0], raw[:h * w].reshape(h, w))
    np.testing.assert_array_equal(native.rgb_to_y(img), jnative.rgb_to_y(img))
    within_a_level(native.rgb_to_y(img), y_channel_u8(img))


@pytest.mark.parametrize("stride,order", [(2, [0, 2, 4, 1, 3, 0]), (1, [0, 1, 2, 3, 4])])
def test_native_reader_byte_equal_jax(built, rng, tmp_path, stride, order):
    """Strided reads, a random revisit, and (stride 1, after a prefetch of
    frame 0) each read staged by the one before."""
    h, w = 16, 24
    src = write_stream(tmp_path / "s.yuv", [rand_frame(rng, h, w) for _ in range(5)])
    rd = native.NativeYUVReader(src, h, w, stride=stride)
    jrd = jnative.NativeYUVReader(src, h, w, stride=stride)
    ref = YUVRead(src, h, w)
    assert rd.num_frames() == jrd.num_frames() == ref.num_frames() == 5
    if stride == 1:
        rd.prefetch(0)
    for i in order:
        got, ok = rd.read(i)
        jwant, jok = jrd.read(i)
        want, rok = ref.read(i)
        assert ok and jok and rok
        np.testing.assert_array_equal(got, jwant)
        within_a_level(got, want)
    for r in (rd, jrd, ref):
        r.close()


def test_jax_side_survives_a_lost_build_race(rng, tmp_path, monkeypatch):
    """A worker whose JAX binding loaded a half-written library remembers it
    as unavailable (``_lib`` None, ``_tried`` True): the repair binds the
    private build, and the conversions and the reader compare byte-equal to
    the JAX package's code again."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native libraries are built at first use")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert not jnative.available()
    assert bind_jax_native(monkeypatch, tmp_path)
    assert jnative.available() and not bind_jax_native(monkeypatch, tmp_path)
    h, w = 16, 24
    y, u, v = rand_frame(rng, h, w)
    np.testing.assert_array_equal(native.yuv420_to_rgb(y, u, v), jnative.yuv420_to_rgb(y, u, v))
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for got, want in zip(native.rgb_to_yuv420(img), jnative.rgb_to_yuv420(img)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.rgb_to_y(img), jnative.rgb_to_y(img))
    src = write_stream(tmp_path / "s.yuv", [rand_frame(rng, h, w) for _ in range(3)])
    rd, jrd = native.NativeYUVReader(src, h, w), jnative.NativeYUVReader(src, h, w)
    for i in (0, 2, 1):
        (got, ok), (want, jok) = rd.read(i), jrd.read(i)
        assert ok and jok
        np.testing.assert_array_equal(got, want)
    rd.close()
    jrd.close()


def test_native_reader_eof_and_missing_file(built, rng, tmp_path):
    src = write_stream(tmp_path / "s.yuv", [rand_frame(rng, 8, 8)])
    rd = native.NativeYUVReader(src, 8, 8)
    assert rd.read(1) == (None, False)
    assert rd.read(-1) == (None, False)
    assert rd.read(0)[1]
    rd.close()
    rd.close()  # a second close is a no-op
    with pytest.raises(OSError):
        native.NativeYUVReader(tmp_path / "missing.yuv", 8, 8)


def test_hd720p_demo_reads_through_the_native_reader(built, tmp_path, monkeypatch):
    """On --device cpu the demo reads with NativeYUVReader (3 reads per
    pair), and its output stream and logs equal a run read by YUVRead."""
    h, w = 64, 128
    src = str(tmp_path / "in.yuv")
    wr = YUVWrite(src)
    for f in moving_frames(3, 5, h, w):
        wr.write(f)
    wr.close()
    reads = []
    real_read = native.NativeYUVReader.read
    monkeypatch.setattr(native.NativeYUVReader, "read",
                        lambda self, i: reads.append(i) or real_read(self, i))
    outs = {}
    for tag in ("native", "numpy"):
        if tag == "numpy":
            monkeypatch.setattr(native, "available", lambda: False)
        out = tmp_path / tag
        demo_hd720p.main(["--yuv", src, "--height", str(h), "--width", str(w), "--frames", "4",
                          "--out-dir", str(out), "--net-name", "MEMC_Net_star", "--uid", "u",
                          "--device", "cpu"])
        outs[tag] = {name: (out / "u" / name).read_bytes()
                     for name in ("in.yuv", "in.yuv_psnr_Y.txt", "in.yuv_ssim_Y.txt")}
        if tag == "native":
            assert reads == [0, 2, 1, 2, 4, 3]
    assert outs["native"] == outs["numpy"]
    assert len(outs["native"]["in.yuv"]) == 4 * h * w * 3 // 2


# ---------------------------------------------------------------- .t7


def spynet_state(prefix="flownets"):
    return {f"{prefix}.{k}": torch.zeros_like(v) for k, v in spynet.SPyNet().state_dict().items()}


def test_t7_round_trip_and_jax_files(rng, tmp_path):
    arr = rng.randn(4, 3, 7, 7).astype(np.float32)
    save_t7_tensor(tmp_path / "port.t7", arr)
    np.testing.assert_array_equal(load_t7_tensor(tmp_path / "port.t7"), arr)
    assert (tmp_path / "port.t7").read_bytes() == _jax_bytes(tmp_path, arr)
    jt7.save_t7_tensor(tmp_path / "jax.t7", arr[:, :, ::2, 1:])  # a strided view, as written
    np.testing.assert_array_equal(load_t7_tensor(tmp_path / "jax.t7"), arr[:, :, ::2, 1:])


def _jax_bytes(tmp_path, arr):
    jt7.save_t7_tensor(tmp_path / "jax_same.t7", arr)
    return (tmp_path / "jax_same.t7").read_bytes()


def test_t7_reader_takes_doubles_and_refuses_other_classes(tmp_path):
    import struct

    def string(s):
        return struct.pack("<i", len(s)) + s.encode()

    body = (struct.pack("<ii", 4, 1) + string("V 1") + string("torch.DoubleTensor")
            + struct.pack("<i", 1) + struct.pack("<q", 3) + struct.pack("<q", 1)
            + struct.pack("<q", 1) + struct.pack("<ii", 4, 2) + string("V 1")
            + string("torch.DoubleStorage") + struct.pack("<q", 3)
            + np.array([1.5, -2.0, 3.25]).tobytes())
    (tmp_path / "d.t7").write_bytes(body)
    got = load_t7_tensor(tmp_path / "d.t7")
    assert got.dtype == np.float64 and got.tolist() == [1.5, -2.0, 3.25]
    np.testing.assert_array_equal(got, jt7.load_t7_tensor(tmp_path / "d.t7"))
    (tmp_path / "b.t7").write_bytes(body.replace(b"torch.DoubleTensor", b"torch.LongTensor__"))
    for load in (load_t7_tensor, jt7.load_t7_tensor):
        with pytest.raises(ValueError):
            load(tmp_path / "b.t7")


@pytest.mark.parametrize("model", ["4", "F"])
def test_import_spynet_t7_equals_jax(rng, tmp_path, model):
    """Files written by the JAX save_t7_tensor under the reference's names
    for levels 1-5 (level 6 only for a model other than '3' and '4', which
    read level 5's), one bias missing: the port's import equals the JAX
    import, and its result loads into the port's SPyNet."""
    state = spynet_state()
    for lvl in range(6 if model == "F" else 5):
        for conv in range(5):
            stem = tmp_path / f"modelL{lvl + 1}_{model}-{conv + 1}"
            w = state[f"flownets.moduleBasic.{lvl}.moduleBasic.{2 * conv}.weight"]
            jt7.save_t7_tensor(f"{stem}-weight.t7", rng.randn(*w.shape).astype(np.float32))
            if (lvl, conv) != (2, 3):
                jt7.save_t7_tensor(f"{stem}-bias.t7", rng.randn(w.shape[0]).astype(np.float32))
    got, report = import_spynet_t7(state, str(tmp_path), model=model)
    want, jreport = jt7.import_spynet_t7({k: v.numpy() for k, v in state.items()},
                                         str(tmp_path), model=model)
    assert report == jreport
    assert report["missing"] == ["flownets.moduleBasic.2.moduleBasic.6.bias"]
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    if model == "4":  # level 6 took level 5's files
        assert torch.equal(got["flownets.moduleBasic.5.moduleBasic.0.weight"],
                           got["flownets.moduleBasic.4.moduleBasic.0.weight"])
    net = spynet.SPyNet()
    net.load_state_dict({k[len("flownets."):]: v for k, v in got.items()})
    with pytest.raises(ValueError):
        bad = dict(state)
        bad["flownets.moduleBasic.0.moduleBasic.0.weight"] = torch.zeros(1)
        import_spynet_t7(bad, str(tmp_path), model=model)


# ---------------------------------------------------------------- flowviz


def test_flo_round_trip_both_ways(rng, tmp_path):
    flow = rng.randn(7, 9, 2).astype(np.float32) * 5
    tviz.write_flo(flow, tmp_path / "t.flo")
    jviz.write_flo(flow, tmp_path / "j.flo")
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tviz.read_flo(tmp_path / "j.flo"), flow)
    np.testing.assert_array_equal(jviz.read_flo(tmp_path / "t.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(b"XXXX" + (tmp_path / "t.flo").read_bytes()[4:])
    for mod in (tviz, jviz):
        with pytest.raises(ValueError):
            mod.read_flo(tmp_path / "bad.flo")
    with pytest.raises(ValueError):
        tviz.write_flo(flow[..., :1], tmp_path / "x.flo")


def test_color_wheel_and_compute_color_equal_jax(rng):
    np.testing.assert_array_equal(tviz.make_color_wheel(), jviz.make_color_wheel())
    u = rng.randn(12, 13) * 0.8
    v = rng.randn(12, 13) * 0.8
    u[0, 0] = np.nan
    np.testing.assert_array_equal(tviz.compute_color(u, v), jviz.compute_color(u, v))


@pytest.mark.parametrize("max_flow", [None, 3.0, -50.0])
def test_flow_to_color_equals_jax(rng, max_flow):
    flow = rng.randn(16, 20, 2).astype(np.float32) * 4
    flow[0, :3] = 2e9  # unknown: black
    flow[1, 1] = 0.0
    got = tviz.flow_to_color(flow, max_flow=max_flow)
    np.testing.assert_array_equal(got, jviz.flow_to_color(flow, max_flow=max_flow))
    assert (got[0, :3] == 0).all()
    zero = tviz.flow_to_color(np.zeros((3, 4, 2), np.float32))
    assert (zero == 255).all()


def test_port_host_modules_do_not_import_jax():
    """The copies read nothing of the JAX package: their sources name no
    jax or memcnet_tpu import."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("memcnet_tpu_torch/native/__init__.py", "memcnet_tpu_torch/io/t7_import.py",
                "memcnet_tpu_torch/utils/flowviz.py"):
        tree = ast.parse(open(os.path.join(root, rel)).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m and m.split(".")[0] in ("jax", "memcnet_tpu")], rel
