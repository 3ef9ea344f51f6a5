"""GOP (group-of-pictures) work scheduler for streaming video runs (port of
memcnet_tpu/parallel/gop.py).

The reference's streaming entry point (demo_HD720p.py:68-151) walks frames
0..N step 2 on one GPU.  Here the stream is cut into GOPs: independent,
restartable work units, distributed round-robin across processes.  The
process index and count come from torch.distributed when it is initialised,
and are 0 and 1 otherwise.

Failure semantics: a GOP is the checkpoint/restart granule.  Completions are
journaled (one id per line, append-only, fsync'd); on restart, journaled GOPs
are skipped, so a crashed process's work can be re-run by pointing any
process at the same journal with its process slot.
"""

import os
from dataclasses import dataclass

import torch.distributed as dist


def _process_slot():
    """(index, count) of this process: torch.distributed's rank and world
    size when it is initialised, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Gop:
    """Half-open frame range [start, stop) walked with `step`.

    Interpolation work items are (i, i+step) -> mid frame i+step//2, for
    i in range(start, stop - step + 1, step) (demo_HD720p.py:68-71 geometry).
    """

    gop_id: int
    start: int
    stop: int
    step: int = 2

    def pairs(self):
        # i in [start, stop - step): the boundary pair (stop-step, stop)
        # belongs to the NEXT gop (which starts at stop - step), so pairs
        # partition the stream exactly.
        return [
            (i, i + self.step, i + self.step // 2)
            for i in range(self.start, self.stop - self.step, self.step)
        ]


def split_gops(n_frames, gop_len=16, step=2):
    """Cut [0, n_frames) into GOPs of `gop_len` frames with `step`-frame
    overlap so every (i, i+step) pair belongs to exactly one GOP."""
    if gop_len <= step:
        raise ValueError(f"gop_len {gop_len} must exceed step {step}")
    gops = []
    start = 0
    gid = 0
    while start + step < n_frames:
        stop = min(start + gop_len, n_frames)
        gops.append(Gop(gid, start, stop, step))
        gid += 1
        start = stop - step  # overlap: last frame of a GOP starts the next pair
        if stop == n_frames:
            break
    return gops


class GopScheduler:
    """Static round-robin GOP assignment across processes + completion journal."""

    def __init__(self, n_frames, *, gop_len=16, step=2, process_index=None,
                 process_count=None, journal_path=None):
        if process_index is None or process_count is None:
            rank, world = _process_slot()
            process_index = rank if process_index is None else process_index
            process_count = world if process_count is None else process_count
        self.process_index = process_index
        self.process_count = process_count
        self.gops = split_gops(n_frames, gop_len, step)
        self.journal_path = journal_path
        self._done = set()
        if journal_path and os.path.exists(journal_path):
            with open(journal_path) as f:
                self._done = {int(line) for line in f if line.strip()}

    def local_gops(self):
        """All GOPs owned by this process (round-robin by gop_id)."""
        return [g for g in self.gops if g.gop_id % self.process_count == self.process_index]

    def pending(self):
        """Owned GOPs not yet journaled as complete."""
        return [g for g in self.local_gops() if g.gop_id not in self._done]

    def mark_done(self, gop):
        gid = gop.gop_id if isinstance(gop, Gop) else int(gop)
        self._done.add(gid)
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                f.write(f"{gid}\n")
                f.flush()
                os.fsync(f.fileno())

    def progress(self):
        mine = self.local_gops()
        done = sum(1 for g in mine if g.gop_id in self._done)
        return done, len(mine)


def stitch_parts(part_paths, out_path, *, n_frames, height, width,
                 gop_len=16, step=2, frames_per_pair=2):
    """Merge per-process `.partN` YUV420 stream segments into the single-process
    output order.

    Each process writes its owned GOPs (round-robin by gop_id, GopScheduler
    semantics) sequentially into its own part file; within a GOP every frame
    pair contributes `frames_per_pair` frames (demo_hd720p writes IMAGE1 +
    reconstruction, demo_HD720p.py:149-151).  Stitching walks gops in gop_id
    order and copies each GOP's byte chunk from its owner's part file, so the
    result is byte-identical to a 1-process run.  All GOPs must be complete
    (journal-complete) — a truncated trailing GOP raises.

    part_paths: list indexed by process slot (len == process_count).
    """
    frame_bytes = height * width * 3 // 2  # YUV420 planar
    gops = split_gops(n_frames, gop_len, step)
    nproc = len(part_paths)
    offsets = [0] * nproc
    handles = [open(p, "rb") for p in part_paths]
    try:
        with open(out_path, "wb") as out:
            for g in gops:
                owner = g.gop_id % nproc
                nbytes = len(g.pairs()) * frames_per_pair * frame_bytes
                h = handles[owner]
                h.seek(offsets[owner])
                chunk = h.read(nbytes)
                if len(chunk) != nbytes:
                    raise ValueError(
                        f"part {owner} truncated at gop {g.gop_id}: "
                        f"wanted {nbytes} bytes, got {len(chunk)}")
                offsets[owner] += nbytes
                out.write(chunk)
    finally:
        for h in handles:
            h.close()
    return out_path
