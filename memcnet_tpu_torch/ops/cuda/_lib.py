"""Build and load the port's CUDA kernels.

The sources live in ``memcnet_tpu_torch/csrc``.  At first use every ``.cu``
file is compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` into an object file, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  Besides the
kernels it holds one host function, ``csrc/png.cu``'s PNG unfilter, which
io/png.py calls where the toolkit is installed.  The library goes
into ``memcnet_tpu_torch/_build/<hash of the sources and flags>/`` (listed in
``.gitignore``), so a later process with the same sources reuses it.  The
compiler's ``-Xptxas -v`` report is kept beside it in ``build.log``.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libmemcnet_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lock = threading.Lock()
_lib = None
build_info = {}  # {"seconds": float, "dir": str, "cached": bool} of this process's build


class LaunchCounter:
    """Counts the launches of one kernel: its wrapper adds one each time it
    launches the kernel on the card, and nowhere else."""

    def __init__(self, name):
        self.name = name
        self.count = 0

    def reset(self):
        self.count = 0


def nvcc_path():
    """The CUDA toolkit's nvcc, or None where it is not installed."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc():
    nvcc = nvcc_path()
    if nvcc:
        return nvcc
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of memcnet_tpu_torch are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels unless a library for these exact sources exists.
    Returns the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(seconds=0.0, dir=str(out_dir), cached=True)
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cus, _ = _sources()
    procs = []
    for src in cus:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME), *(str(o) for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n" + "\n".join(log))
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, dir=str(out_dir), cached=False)
    return lib_path


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.memc_error_string.argtypes = [i]
    lib.memc_error_string.restype = ctypes.c_char_p
    lib.memc_filter_interp_warp.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    lib.memc_filter_interp_warp.restype = i
    lib.memc_project_sums.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.memc_project_sums.restype = i
    lib.memc_project_fill.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.memc_project_fill.restype = i
    lib.memc_conv2d_small.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.memc_conv2d_small.restype = i
    lib.memc_conv2d_igemm.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.memc_conv2d_igemm.restype = i
    lib.memc_grid_sample.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.memc_grid_sample.restype = i
    lib.memc_spynet_level_input.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.memc_spynet_level_input.restype = i
    lib.memc_png_unfilter.argtypes = [ctypes.c_char_p, vp, i, i, i]
    lib.memc_png_unfilter.restype = i


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            _declare(handle)
            _lib = handle
    return _lib


def check(err, what):
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = _lib.memc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype):
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]


def on_cuda(*tensors):
    """True if every tensor is on a CUDA device, False if every one is on the
    CPU; raises on a mix.  Decides kernel vs plain version in the wrappers."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on one CUDA device or all on the CPU, got {kinds}")


def check_cuda_args(what, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on different devices ({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def reference_grads(fn, inputs, needs, grad_outputs):
    """Backward of a kernel = autograd of its plain version: re-run ``fn`` on
    detached copies of ``inputs`` and pull ``grad_outputs`` back to the inputs
    flagged in ``needs`` (None elsewhere), as the JAX custom_vjps do."""
    import torch

    with torch.enable_grad():
        xs = [x.detach().requires_grad_(bool(n)) for x, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if g is not None and o.requires_grad]
        wanted = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True)
            if pairs and wanted else [None] * len(wanted))
    return [next(got) if n else None for n in needs]
