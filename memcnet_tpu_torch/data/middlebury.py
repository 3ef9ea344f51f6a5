"""Middlebury 'other' interpolation pairs (demo_MiddleBury.py:18-21,72-80;
port of memcnet_tpu/data/middlebury.py): frame10.png + frame11.png per
sequence dir, ground truth frame10i11.png."""

import os

import numpy as np

from memcnet_tpu_torch.io.png import imread


def read_frame(path):
    """A PNG as (C, H, W) float32 in [0, 1]."""
    return np.transpose(imread(path), (2, 0, 1)).astype("float32") / 255.0


class MiddleburyOther:
    """Yields (x0, x1, gt_or_None, name); skips non-RGB sequences
    (demo_MiddleBury.py:93-94)."""

    def __init__(self, data_dir, gt_dir=None):
        self.data_dir = data_dir
        self.gt_dir = gt_dir
        self.names = sorted(
            d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
        )

    def __len__(self):
        return len(self.names)

    def __iter__(self):
        for name in self.names:
            first = os.path.join(self.data_dir, name, "frame10.png")
            second = os.path.join(self.data_dir, name, "frame11.png")
            x0, x1 = read_frame(first), read_frame(second)
            if x0.shape[0] != 3:
                continue
            gt = None
            if self.gt_dir is not None:
                gt_path = os.path.join(self.gt_dir, name, "frame10i11.png")
                if os.path.exists(gt_path):
                    gt = read_frame(gt_path)
            yield x0, x1, gt, name
