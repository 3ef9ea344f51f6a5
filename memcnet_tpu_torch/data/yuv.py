"""YUV420 planar stream I/O (reference: yuv_frame_io.py:32-181; a copy of
memcnet_tpu/data/yuv.py).

Random-access frame reads with nearest x2 chroma upsampling and RGB
conversion; writes with 2x chroma decimation.  The reference's Fortran-order
reshape + transpose is kept as it is.
"""

import os

import numpy as np

from memcnet_tpu_torch.metrics.quality import rgb2yuv, yuv2rgb


class YUVRead:
    def __init__(self, filepath, h, w, fmt="yuv420", to_rgb=True):
        if fmt != "yuv420":
            raise ValueError(f"only yuv420 streams are read, got {fmt!r}")
        self.h = h
        self.w = w
        self.fp = open(filepath, "rb")
        self.frame_length = int(1.5 * h * w)
        self.y_length = h * w
        self.uv_length = int(0.25 * h * w)
        self.to_rgb = to_rgb

    def num_frames(self):
        return os.fstat(self.fp.fileno()).st_size // self.frame_length

    def read(self, offset_frame=None):
        if offset_frame is not None:
            self.fp.seek(offset_frame * self.frame_length, 0)
        y = np.fromfile(self.fp, np.uint8, count=self.y_length)
        u = np.fromfile(self.fp, np.uint8, count=self.uv_length)
        v = np.fromfile(self.fp, np.uint8, count=self.uv_length)
        if y.size < self.y_length or u.size < self.uv_length or v.size < self.uv_length:
            return None, False
        # Fortran reshape to (w, h) + transpose == C reshape to (h, w)
        # (yuv_frame_io.py:60-67)
        y = y.reshape(self.w, self.h, order="F").T
        u = u.reshape(self.w // 2, self.h // 2, order="F").T
        v = v.reshape(self.w // 2, self.h // 2, order="F").T
        # nearest x2 chroma upsample (yuv_frame_io.py:69-70)
        u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[: self.h, : self.w]
        v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[: self.h, : self.w]
        if self.to_rgb:
            yuv = np.stack((y / 255.0, u / 255.0 - 0.5, v / 255.0 - 0.5), axis=-1)
            rgb = (255.0 * np.clip(yuv2rgb(yuv), 0.0, 1.0)).astype("uint8")
            return rgb, True
        return np.stack((y, u, v), axis=-1), True

    def close(self):
        self.fp.close()


class YUVWrite:
    def __init__(self, filepath, from_rgb=True):
        self.fp = open(filepath, "wb")
        self.from_rgb = from_rgb

    def write(self, frame):
        h, w, c = frame.shape
        if c != 3:
            raise ValueError(f"frames are (H, W, 3), got {frame.shape}")
        if self.from_rgb:
            yuv = rgb2yuv(frame / 255.0)
            y = yuv[:, :, 0]
            u = np.clip(yuv[:, :, 1] + 0.5, 0.0, 1.0)[::2, ::2]
            v = np.clip(yuv[:, :, 2] + 0.5, 0.0, 1.0)[::2, ::2]
            y = (255.0 * y).astype("uint8")
            u = (255.0 * u).astype("uint8")
            v = (255.0 * v).astype("uint8")
        else:
            y = frame[:, :, 0]
            u = frame[::2, ::2, 1]
            v = frame[::2, ::2, 2]
        y.flatten().tofile(self.fp)
        u.flatten().tofile(self.fp)
        v.flatten().tofile(self.fp)
        return True

    def close(self):
        self.fp.close()
