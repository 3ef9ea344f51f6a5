"""ctypes binding of the port's native host library (``yuv_native.cpp``, a
copy of memcnet_tpu/native's): YUV420 <-> RGB conversions and a prefetching
YUV420 reader.

At first use the library is built with ``g++ -O3 -shared -fPIC -pthread
-std=c++17`` into ``memcnet_tpu_torch/_build/native-<hash of the source and
flags>/`` (listed in ``.gitignore``), in a temporary directory renamed into
place, so that processes building at once (test workers) do not clash and a
later process reuses the library.  Where it cannot be built (no g++),
``available()`` is False, ``build_error()`` says why, and callers read with
the numpy ``data.yuv.YUVRead``, as the JAX HD720p demo does.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "yuv_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libmemcnet_native.so"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def build():
    """Compile the library unless one for this exact source exists; returns
    its path.  Raises RuntimeError if g++ is missing or fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native YUV library is built at first use")
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"g++ failed (rc {res.returncode}):\n{res.stdout}{res.stderr}")
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def _declare(lib):
    u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    lib.yuv420_to_rgb.argtypes = [u8p, u8p, u8p, i64, i64, u8p]
    lib.rgb_to_yuv420.argtypes = [u8p, i64, i64, u8p, u8p, u8p]
    lib.rgb_to_y.argtypes = [u8p, i64, i64, u8p]
    lib.yuv_reader_open.argtypes = [ctypes.c_char_p, i64, i64]
    lib.yuv_reader_open.restype = ctypes.c_void_p
    lib.yuv_reader_num_frames.argtypes = [ctypes.c_void_p]
    lib.yuv_reader_num_frames.restype = i64
    lib.yuv_reader_prefetch.argtypes = [ctypes.c_void_p, i64]
    lib.yuv_reader_read_rgb.argtypes = [ctypes.c_void_p, i64, i64, u8p]
    lib.yuv_reader_read_rgb.restype = ctypes.c_int
    lib.yuv_reader_close.argtypes = [ctypes.c_void_p]


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError) as e:
                _error = f"{type(e).__name__}: {e}"
    return _lib


def available():
    """True if the library is built (building it on the first call)."""
    return _load() is not None


def build_error():
    """Why the library is unavailable, or None."""
    _load()
    return _error


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def yuv420_to_rgb(y, u, v):
    """(H, W) uint8 Y and (H/2, W/2) uint8 U, V planes -> (H, W, 3) uint8 RGB."""
    lib = _need()
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.yuv420_to_rgb(_u8p(y), _u8p(u), _u8p(v), h, w, _u8p(out))
    return out


def rgb_to_yuv420(rgb):
    """(H, W, 3) uint8 RGB -> ((H, W), (H/2, W/2), (H/2, W/2)) uint8 planes."""
    lib = _need()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    y = np.empty((h, w), np.uint8)
    u = np.empty((h // 2, w // 2), np.uint8)
    v = np.empty((h // 2, w // 2), np.uint8)
    lib.rgb_to_yuv420(_u8p(rgb), h, w, _u8p(y), _u8p(u), _u8p(v))
    return y, u, v


def rgb_to_y(rgb):
    """(H, W, 3) uint8 RGB -> (H, W) uint8 Y plane (the HD720p demo's
    PSNR-Y protocol)."""
    lib = _need()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), np.uint8)
    lib.rgb_to_y(_u8p(rgb), h, w, _u8p(out))
    return out


class NativeYUVReader:
    """Prefetching YUV420 stream reader (a background pread thread in C++)
    with ``data.yuv.YUVRead``'s ``read(frame) -> (rgb, ok)``.  ``stride``
    is the access pattern: each read stages frame + stride while it converts
    this one (the HD720p demo reads step 2)."""

    def __init__(self, path, h, w, stride=1):
        self._lib = _need()
        self.h, self.w = h, w
        self.stride = stride
        self._handle = self._lib.yuv_reader_open(str(path).encode(), h, w)
        if not self._handle:
            raise OSError(f"cannot open {path}")

    def num_frames(self):
        return int(self._lib.yuv_reader_num_frames(self._handle))

    def prefetch(self, frame):
        self._lib.yuv_reader_prefetch(self._handle, frame)

    def read(self, frame):
        out = np.empty((self.h, self.w, 3), np.uint8)
        ok = self._lib.yuv_reader_read_rgb(self._handle, frame, self.stride, _u8p(out))
        return (out, True) if ok else (None, False)

    def close(self):
        if self._handle:
            self._lib.yuv_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
