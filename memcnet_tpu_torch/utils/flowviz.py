"""Middlebury .flo I/O and flow -> color-wheel visualization (a copy of
memcnet_tpu/utils/flowviz.py for the port, which imports nothing of the JAX
package).

Capability parity with the reference's PYTHON_Flow2Color trees (shipped as two
identical copies under networks/FlowNetS/ and networks/SPyNet/ -- one module
here).

Reference semantics (file:line in the reference checkout, under
networks/FlowNetS/PYTHON_Flow2Color/):
  * read_flo / write_flo: readFlowFile.py:14-53, writeFlowFile.py:16-55 —
    little-endian: 4-byte tag ("PIEH" == float32 202021.25), int32 w, int32 h,
    then h*w*2 float32 interleaved (u, v).
  * flow_to_color: flowToColor.py:14-69 + computeColor.py:12-90 — normalize
    by max radius (or caller-supplied max_flow), map angle onto a 55-entry
    RY/YG/GC/CB/BM/MR color wheel, desaturate toward white inside the unit
    radius, darken 0.75x outside, zero out unknown (|u| or |v| > 1e9) pixels.

Pure numpy — this is host-side visualization/IO, not device compute.
"""

import numpy as np

TAG_FLOAT = 202021.25
TAG_STRING = b"PIEH"
UNKNOWN_FLOW_THRESH = 1e9


def read_flo(path):
    """Read a Middlebury .flo file -> (H, W, 2) float32 flow."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, count=1)
        if tag.size == 0 or tag[0] != TAG_FLOAT:
            raise ValueError(
                f"read_flo({path}): bad tag {tag!r} (big-endian or not a .flo?)"
            )
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        if not (1 <= w <= 99999 and 1 <= h <= 99999):
            raise ValueError(f"read_flo({path}): implausible size {w}x{h}")
        data = np.fromfile(f, np.float32, count=h * w * 2)
    if data.size != h * w * 2:
        raise ValueError(f"read_flo({path}): truncated payload ({data.size})")
    return data.reshape(h, w, 2)


def write_flo(flow, path):
    """Write (H, W, 2) flow to a Middlebury .flo file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flo: expected (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(TAG_STRING)
        np.array([w, h], np.int32).tofile(f)
        np.ascontiguousarray(flow, np.float32).tofile(f)


def make_color_wheel():
    """55-entry Middlebury color wheel (computeColor.py:12-54)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def compute_color(u, v):
    """Map normalized flow (|.| <= ~1) to RGB uint8 (computeColor.py:57-90)."""
    u = np.array(u, np.float64, copy=True)
    v = np.array(v, np.float64, copy=True)
    nan_idx = np.isnan(u) | np.isnan(v)
    u[nan_idx] = 0.0
    v[nan_idx] = 0.0

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75
        img[..., i] = np.floor(255 * col * (1 - nan_idx)).clip(0, 255).astype(np.uint8)
    return img


def flow_to_color(flow, max_flow=None):
    """Flow (H, W, 2) -> RGB uint8 visualization (flowToColor.py:14-69).

    max_flow > 0 pins the normalization radius; max_flow < 0 sets a floor.
    """
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow_to_color: expected (H, W, 2), got {flow.shape}")
    u = np.array(flow[..., 0], np.float64, copy=True)
    v = np.array(flow[..., 1], np.float64, copy=True)

    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0.0
    v[unknown] = 0.0

    maxrad = float(np.max(np.sqrt(u * u + v * v))) if u.size else 0.0
    if max_flow is not None:
        if max_flow > 0:
            maxrad = max_flow
        elif max_flow < 0:
            maxrad = max(maxrad, -max_flow)

    eps = 1e-6
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[unknown] = 0
    return img
