"""Torch7 ``.t7`` tensor reader and SPyNet weight importer (a copy of
memcnet_tpu/io/t7_import.py for the port, which imports nothing of the JAX
package).

The reference loads SPyNet weights from per-conv Torch7 tensor files with
``torch.utils.serialization.load_lua`` (networks/SPyNet/Network.py:101-108,
files ``models/modelL{level}_{model}-{conv}-{weight,bias}.t7``).  Modern torch
dropped ``load_lua``, so this is a minimal reader for the subset those files
use: one serialized ``torch.FloatTensor`` / ``torch.DoubleTensor`` in
Torch7's default binary format.

Format (torch7 File:writeObject): each object is
  int32 type-tag (1=number, 2=string, 3=table, 4=torch class, ...)
  for torch classes: int32 heap-index, then version string ("V <n>") and
  class-name string (int32 length + bytes), then the class payload.
Tensor payload: int32 ndim, int64[ndim] sizes, int64[ndim] strides,
int64 storage offset (1-based), then the Storage object (another torch
class: int64 count + raw elements).
"""

import struct

import numpy as np

_TYPE_TORCH = 4

_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
}
_TENSOR_STORAGE = {
    "torch.FloatTensor": "torch.FloatStorage",
    "torch.DoubleTensor": "torch.DoubleStorage",
}


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.heap = {}

    def _read(self, n):
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated .t7 file")
        self.pos += n
        return b

    def i32(self):
        return struct.unpack("<i", self._read(4))[0]

    def i64(self):
        return struct.unpack("<q", self._read(8))[0]

    def string(self):
        return self._read(self.i32()).decode("latin-1")

    def torch_object(self):
        tag = self.i32()
        if tag != _TYPE_TORCH:
            raise ValueError(f"expected a torch object, got type tag {tag}")
        idx = self.i32()
        if idx in self.heap:
            return self.heap[idx]
        version = self.string()
        if version.startswith("V "):
            cls = self.string()
        else:  # pre-versioning files: the "version" WAS the class name
            cls = version
        obj = self._read_class(cls)
        self.heap[idx] = obj
        return obj

    def _read_class(self, cls):
        if cls in _TENSOR_STORAGE:
            ndim = self.i32()
            sizes = [self.i64() for _ in range(ndim)]
            strides = [self.i64() for _ in range(ndim)]
            offset = self.i64() - 1  # 1-based
            storage = self.torch_object()
            if ndim == 0:
                return np.empty((0,), storage.dtype)
            return np.lib.stride_tricks.as_strided(
                storage[offset:],
                shape=sizes,
                strides=[s * storage.itemsize for s in strides],
            ).copy()
        if cls in _STORAGE_DTYPES:
            dt = np.dtype(_STORAGE_DTYPES[cls])
            n = self.i64()
            return np.frombuffer(self._read(n * dt.itemsize), dt).copy()
        raise ValueError(f"unsupported torch class in .t7 file: {cls}")


def load_t7_tensor(path):
    """Read a .t7 file holding one torch Float/Double tensor -> np.ndarray."""
    with open(path, "rb") as f:
        return _Reader(f.read()).torch_object()


def save_t7_tensor(path, arr):
    """Write `arr` as a torch.FloatTensor .t7 (round-trip/test helper)."""
    arr = np.ascontiguousarray(arr, np.float32)
    out = []

    def i32(v):
        out.append(struct.pack("<i", v))

    def i64(v):
        out.append(struct.pack("<q", v))

    def string(s):
        i32(len(s))
        out.append(s.encode("latin-1"))

    i32(_TYPE_TORCH)
    i32(1)  # heap index
    string("V 1")
    string("torch.FloatTensor")
    i32(arr.ndim)
    for s in arr.shape:
        i64(s)
    strides = [st // arr.itemsize for st in arr.strides]
    for s in strides:
        i64(s)
    i64(1)  # storage offset (1-based)
    i32(_TYPE_TORCH)
    i32(2)
    string("V 1")
    string("torch.FloatStorage")
    i64(arr.size)
    out.append(arr.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def import_spynet_t7(state_dict, models_dir, model="4", prefix="flownets"):
    """Load the reference's per-conv SPyNet .t7 weights into a
    {name: tensor} state dict (the JAX params' names, e.g. a SPyNet model's
    or MEMC_Net_s's ``state_dict()``).

    File schema (networks/SPyNet/Network.py:101-108):
      modelL{level+1}_{model}-{conv+1}-weight.t7 / -bias.t7,
    level 0..5 onto ``{prefix}.moduleBasic.{level}.moduleBasic.{2*conv}``.
    Level 6 (index 5) reads level 5's files for the chairs-trained models
    '3' and '4', as the reference does (Network.py:95-98).  Each tensor keeps
    the type and device of the entry it replaces.  Returns (the new state
    dict, for ``load_state_dict``; {"loaded": [...], "missing": [...]})."""
    import os

    import torch

    loaded, missing = [], []
    state = dict(state_dict)
    for lvl in range(6):
        src_lvl = lvl
        if lvl == 5 and model in ("3", "4"):
            src_lvl = 4  # Network.py:95-98
        for conv in range(5):
            stem = os.path.join(models_dir, f"modelL{src_lvl + 1}_{model}-{conv + 1}")
            key = f"{prefix}.moduleBasic.{lvl}.moduleBasic.{2 * conv}"
            for part, suffix in (("weight", "-weight.t7"), ("bias", "-bias.t7")):
                path = stem + suffix
                pkey = f"{key}.{part}"
                if not os.path.exists(path):
                    missing.append(pkey)
                    continue
                arr = load_t7_tensor(path)
                cur = state[pkey]
                if tuple(arr.shape) != tuple(cur.shape):
                    raise ValueError(f"{path}: shape {arr.shape} != expected {tuple(cur.shape)}")
                state[pkey] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                    dtype=cur.dtype, device=cur.device)
                loaded.append(pkey)
    return state, {"loaded": loaded, "missing": missing}
