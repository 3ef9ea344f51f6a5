"""Where the rows of an op's inputs lie in the frame: whole frames, or the
tiles of a partitioned frame (``parallel/partition.py``).

The op library reads and writes at data-dependent cells anywhere in the
frame, so it computes on the frame's global coordinates through one of two
objects with one interface:

  * ``WholeFrame``: each row is a whole frame (the untiled ops);
  * ``TileFrame``: each row is a tile of a partitioned frame, of the level or
    derived extent ``size``, as the JAX ops run on ``frame_sharding``-placed
    arrays, where GSPMD gathers and reduces whatever a data-dependent index
    needs.  Reads go through ``whole`` (``Partition.gather``: the level
    whole, one per sample) and ``take``; writes scatter into a whole-frame
    buffer per sample (``flat``) and reach the tiles through ``rows``
    (``Partition.reduce``).  There is no halo budget and no flow clamp.

  size         the frame's (H, W) at the rows' level or extent
  samples_of(n)
               whole frames behind n rows (tile j is of sample j % samples)
  origins(n, device)
               (tiles) (n, 4) int32 global origin (y0, x0) and owned (h, w);
               None for whole frames
  coords(n, h, w, device)
               (ys (n | 1, h, 1), xs (n | 1, 1, w)) float32 global positions
  owned(x)     (n, h, w) bool of the pixels the rows x own, or None (all)
  whole(x)     the frames (samples, C, H, W) of rows x
  window(x, r) rows x extended by r positions on each side, the frame's edge
               repeated beyond it
  take(src, iy, ix)
               src (samples, C, H, W) at the global cells (iy, ix) (n, h, w)
  flat(lin, K) indices (n, K, h * w) of K planes at the global cells lin = iy
               W + ix into a flat (samples, K, H, W) buffer
  rows(s)      the rows' part of whole-frame sums s (samples, K, H, W)

``frame_of(x)`` picks the one of the active ``spatial_tiling`` context.
"""

import torch
import torch.nn.functional as F


def coords(n, h, w, origins, device):
    """(ys (n | 1, h, 1), xs (n | 1, 1, w)) float32: the frame positions of
    n rows of h x w, whole frames (``origins`` None) or tiles at ``origins``
    (n, 4) int32 (y0, x0, own_h, own_w)."""
    ys = torch.arange(h, device=device).view(1, h, 1)
    xs = torch.arange(w, device=device).view(1, 1, w)
    if origins is not None:
        o = origins.long()
        ys, xs = o[:, 0].view(n, 1, 1) + ys, o[:, 1].view(n, 1, 1) + xs
    return ys.float(), xs.float()


def take(src, iy, ix, W):
    """src (samples, C, H, W) at the cells (iy, ix) (n, h, w) of n rows, row
    j of sample j % samples (the tile index outermost): (n, C, h, w)."""
    n, h, w = iy.shape
    S, C = src.shape[:2]
    T = n // S
    lin = (iy.long() * W + ix.long()).reshape(T, S, h * w).transpose(0, 1)
    lin = lin.reshape(S, 1, T * h * w).expand(S, C, T * h * w)
    got = src.reshape(S, C, -1).gather(2, lin)
    return got.view(S, C, T, h, w).permute(2, 0, 1, 3, 4).reshape(n, C, h, w)


class _Frame:
    """Reads and writes at the frame's global cells, per sample (row j is of
    sample j % samples, the tile index outermost)."""

    def take(self, src, iy, ix):
        return take(src, iy, ix, self.size[1])

    def flat(self, lin, K):
        n = lin.shape[0]
        H, W = self.size
        sample = torch.arange(n, device=lin.device) % self.samples_of(n)
        base = ((sample.view(n, 1) * K + torch.arange(K, device=lin.device).view(1, K))
                * (H * W)).view(n, K, 1)
        return base + lin.reshape(n, 1, -1).long()


class WholeFrame(_Frame):
    """Each row is a whole H x W frame."""

    def __init__(self, x):
        self.size = tuple(x.shape[-2:])

    def samples_of(self, n):
        return n

    def origins(self, n, device):
        return None

    def coords(self, n, h, w, device):
        return coords(n, h, w, None, device)

    def owned(self, x):
        return None

    def whole(self, x):
        return x

    def window(self, x, r):
        return F.pad(x, (r, r, r, r), mode="replicate")

    def rows(self, s):
        return s


class TileFrame(_Frame):
    """Each row is a tile of the partition ``part``, of the level or derived
    extent ``size`` (gh, gw)."""

    def __init__(self, part, size):
        self.part, self.size = part, tuple(size)

    def samples_of(self, n):
        return self.part.samples(n)

    def origins(self, n, device):
        """(n, 4) int32: each row's global (y0, x0) and owned (h, w)."""
        return self.part.origins(self.size, n, device)

    def coords(self, n, h, w, device):
        return coords(n, h, w, self.origins(n, device), device)

    def owned(self, x):
        m = self.part.mask(x, self.size)
        return None if m is None else m[:, 0] > 0

    def whole(self, x):
        return self.part.gather(x, self.size)

    def window(self, x, r):
        p = self.part
        x = p.clamped_take(x, self.size, self.size, lo=(r, r), hi=(r, r))
        return x if p.h else F.pad(x, (0, 0, r, r), mode="replicate")

    def rows(self, s):
        return self.part.reduce(s)


def frame_of(x):
    """The frame of the rows x: their partition's tiles at x's level or
    extent where frames are sharded under the active ``spatial_tiling``
    context, else whole frames."""
    # imported when called: memcnet_tpu_torch.parallel imports the models
    from memcnet_tpu_torch.parallel.context import active_partition

    part = active_partition()
    return WholeFrame(x) if part is None else TileFrame(part, part.extent(x))
