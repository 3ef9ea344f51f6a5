"""8-bit PNG reader and writer on the standard library (zlib, struct).

The JAX package reads and writes PNGs through imageio; the port does not
depend on it.  ``imread`` returns what ``imageio.v2.imread`` returns for the
files it takes: non-interlaced 8-bit greyscale, RGB or RGBA, with any of the
five filter types per row, as an (H, W), (H, W, 3) or (H, W, 4) uint8 array.
Anything else (palette, grey with alpha, other bit depths, interlacing)
raises ``ValueError``.  Where the CUDA toolkit is installed, the rows are
unfiltered by ``memc_png_unfilter`` (csrc/png.cu, host code in the kernels'
library, which runs without the interpreter lock); elsewhere by its plain
Python version, which takes one Python step per byte of an Average or Paeth
row.  ``imwrite`` writes the same three kinds, with filter type 0 on every
row, or with the filter type libpng picks for each row.
"""

import struct
import zlib

import numpy as np

from memcnet_tpu_torch.ops.cuda import _lib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def unfilter_plain(raw, h, stride, bpp):
    """Undo the per-row filters (PNG spec 9.2) of ``raw`` into (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per sample, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one to its left
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def unfilter(raw, h, stride, bpp):
    """``unfilter_plain`` through csrc/png.cu's ``memc_png_unfilter`` where
    the CUDA toolkit is installed (the first call then builds the kernels'
    library, as a first launch would), else ``unfilter_plain`` itself."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    if _lib.nvcc_path() is None:
        return unfilter_plain(raw, h, stride, bpp)
    out = np.empty((h, stride), np.uint8)
    bad = _lib.lib().memc_png_unfilter(bytes(raw), out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has unknown filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def imread(path):
    """Read an 8-bit greyscale, RGB or RGBA PNG as (H, W[, C]) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _compression, _filter, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit samples are read")
    if colour not in _CHANNELS:
        kind = {3: "palette", 4: "greyscale with alpha"}.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: {kind} PNG; only greyscale, RGB and RGBA are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced files are read")
    ch = _CHANNELS[colour]
    img = unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def filter_rows(img, bpp):
    """(5, h, stride) uint8: every row of the (h, stride) uint8 ``img`` under
    each of the five filter types (PNG spec 9.2)."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    return np.stack([(x - pred) & 0xFF for pred in preds]).astype(np.uint8)


def imwrite(path, img, adaptive=False):
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 array as a PNG: filter
    type 0 on every row, or with ``adaptive`` the type libpng picks by
    default for each row, the least sum of its filtered bytes read as
    signed (slower to write; what real files hold)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 arrays, got {img.dtype}")
    ch = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if ch not in _COLOUR_TYPE:
        raise ValueError(f"PNG writer takes (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = img.shape[:2]
    flat = img.reshape(h, w * ch)
    rows = np.zeros((h, 1 + w * ch), np.uint8)
    if adaptive:
        each = filter_rows(flat, ch)
        signed = np.minimum(each, 256 - each.astype(np.int32))
        kinds = np.argmin(signed.sum(axis=2), axis=0)
        rows[:, 0] = kinds
        rows[:, 1:] = each[kinds, np.arange(h)]
    else:
        rows[:, 1:] = flat
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))
