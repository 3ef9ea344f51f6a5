"""Vimeo-90K enhancement datasets (sr / denoise / deblock); port of
memcnet_tpu/data/vimeo90k.py.

Reference: datasets_benchmark/listdatasets.py:13-104 and the registry modules
Vimeo_90K_{sr,dn,db}.  Each sample is a 7-frame window from a task-specific
degraded directory plus the clean center target im4.png:

  denoise -> sequences_sigma20_byMTLB/        (listdatasets.py:17-18)
  sr      -> sequences_blur_byMTLB/           (:19-20)
  deblock -> input_H264qp37_byFFmpeg/         (:21-22)
  target  -> target/im4.png                   (:23,37)

Frames return as float32 [0,1], (3,H,W) each.  A lightweight iterable with
optional double-buffered prefetch replaces torch DataLoader workers; a read
that fails in the prefetch thread is raised again in the consumer.
"""

import os
import queue
import threading

import numpy as np

from memcnet_tpu_torch.data.middlebury import read_frame

TASK_DIRS = {
    "denoise": "sequences_sigma20_byMTLB",
    "sr": "sequences_blur_byMTLB",
    "deblock": "input_H264qp37_byFFmpeg",
}


def load_window(root, im_path, task):
    """One 7-frame window + target (Vimeo_90K_loader, listdatasets.py:13-77)."""
    root_input = os.path.join(root, TASK_DIRS[task], im_path)
    root_target = os.path.join(root, "target", im_path)
    frames = [read_frame(os.path.join(root_input, f"im{i + 1}.png")) for i in range(7)]
    target = read_frame(os.path.join(root_target, "im4.png"))
    return frames, target


def list_sequences(root, task):
    """All <video>/<seq> paths present in the task input dir."""
    base = os.path.join(root, TASK_DIRS[task])
    out = []
    for vid in sorted(os.listdir(base)):
        vdir = os.path.join(base, vid)
        if not os.path.isdir(vdir):
            continue
        for seq in sorted(os.listdir(vdir)):
            if os.path.isdir(os.path.join(vdir, seq)):
                out.append(os.path.join(vid, seq))
    return out


class Vimeo90K:
    """Iterable dataset: yields (frames[7], target, path)."""

    def __init__(self, root, task, paths=None, prefetch=2):
        if task not in TASK_DIRS:
            raise ValueError(f"task {task!r} is not one of {sorted(TASK_DIRS)}")
        self.root = root
        self.task = task
        self.paths = paths if paths is not None else list_sequences(root, task)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        frames, target = load_window(self.root, self.paths[i], self.task)
        return frames, target, self.paths[i]

    def __iter__(self):
        if self.prefetch <= 0:
            for i in range(len(self)):
                yield self[i]
            return
        q = queue.Queue(maxsize=self.prefetch)
        closed = threading.Event()

        def worker():
            try:
                for i in range(len(self)):
                    if closed.is_set():
                        return
                    q.put(("item", self[i]))
                q.put(("end", None))
            except Exception as e:  # handed to the consumer, which raises it
                q.put(("error", e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, value = q.get()
                if kind == "error":
                    raise value
                if kind == "end":
                    return
                yield value
        finally:
            # a consumer that stops early: free a put that waits for room,
            # so the worker sees `closed` and ends
            closed.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


class VimeoTriplet:
    """Vimeo-90K triplet dataset for interpolation TRAINING.

    The reference ships no trainer, but its documented hyperparameters
    (my_args.py:41-59) and the MEMC-Net paper train interpolation on the
    Vimeo-90K triplet split: sequences/<video>/<seq>/im{1,2,3}.png with im2
    the ground-truth middle frame.  Accepts either that layout (with optional
    tri_trainlist.txt / tri_testlist.txt) or any directory tree whose leaves
    hold im1/im2/im3.

    Yields (x0, gt, x1) float32 (3,H,W) triples; `crop` takes a random HxW
    patch (train-time augmentation).
    """

    def __init__(self, root, list_file=None, crop=None, seed=0,
                 frames=("im1.png", "im2.png", "im3.png")):
        self.root = root
        self.frames = frames
        self.crop = crop
        self.rng = np.random.RandomState(seed)
        if list_file:
            with open(os.path.join(root, list_file)) as f:
                self.paths = [ln.strip() for ln in f if ln.strip()]
            self.base = os.path.join(root, "sequences")
        else:
            self.base, self.paths = self._scan(root)

    def _scan(self, root):
        base = os.path.join(root, "sequences") if os.path.isdir(
            os.path.join(root, "sequences")) else root
        out = []
        for dirpath, _dirnames, filenames in sorted(os.walk(base)):
            if all(f in filenames for f in self.frames):
                out.append(os.path.relpath(dirpath, base))
        return base, out

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        d = os.path.join(self.base, self.paths[i])
        x0, gt, x1 = (read_frame(os.path.join(d, f)) for f in self.frames)
        if self.crop:
            ch, cw = self.crop
            _, H, W = x0.shape
            y = self.rng.randint(0, H - ch + 1)
            x = self.rng.randint(0, W - cw + 1)
            x0, gt, x1 = (a[:, y:y + ch, x:x + cw] for a in (x0, gt, x1))
        return x0, gt, x1

    def batches(self, batch_size, *, epochs=None, shuffle=True):
        """Yield (x0, gt, x1) float32 (B,3,H,W) batches, dropping remainders."""
        epoch = 0
        while epochs is None or epoch < epochs:
            order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[int(i)] for i in order[s:s + batch_size]]
                yield tuple(np.stack([it[k] for it in items]) for k in range(3))
            epoch += 1


def Vimeo_90K_sr(root, **kw):
    return Vimeo90K(root, "sr", **kw)


def Vimeo_90K_dn(root, **kw):
    return Vimeo90K(root, "denoise", **kw)


def Vimeo_90K_db(root, **kw):
    return Vimeo90K(root, "deblock", **kw)
