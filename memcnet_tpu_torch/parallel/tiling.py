"""Spatial tiling with halo exchange (port of memcnet_tpu/parallel/tiling.py):
the W pixel axis (and with ``axis_h`` the H axis) is split into tiles over
mesh axes, and the warp and the projection exchange boundary bands with
their ring neighbours instead of reading whole frames.

Semantic contract, as in the JAX package:
  * ``tiled_filter_interp_warp`` equals the global ``filter_interp_warp``
    for flows with |fx| <= halo - filter_size (the halo budget); horizontal
    flow is clamped to that budget, and vertical flow to halo_h -
    filter_size when H is tiled.  The validity gates use global
    coordinates; global-edge tiles replicate their own border into the
    halo, which reproduces the global op's edge clamp.
  * ``tiled_flow_project`` scatters each tile into a halo-extended buffer
    (flow clamped to +-(halo - 1), and vertically to +-(halo_h - 1) when H
    is tiled), folds the +1 neighbours at that buffer's edge, sends the
    spilled bands to the ring neighbours (the last tile folds the global far
    border back; edge tiles take no wraparound spill), divides by the count
    and, with the fill, continues each hole search into the other tiles
    (the nearest tile wins; the reference's dead down search stays dead).
  * W must be divisible by the tile count (H by the tile_h count); the
    projection needs W / t >= 2 halo (and H / t_h >= 2 halo_h).

Global tensors go in and come out of the ``tiled_*`` ops;
``parallel.ring.TileRing`` splits them into tiles and merges them back, and
carries the ring shifts.  ``warp_tiles`` and ``project_tiles`` are the
tile-local steps alone, which partitioned frames (``parallel.partition``)
run with no split and no merge.  Their kernels are the tile entries of K1
(``warp_kernel.warp_tile``), K2 (``project_kernel.tile_sums``) and K3
(``project_kernel.tile_fill``) on CUDA tensors and their plain versions on
CPU tensors.  Coordinates are float32
whatever the activations' type; the JAX version builds them in
``flow.dtype``, up to 4 px off above 256 in bf16.  ``batch_axis`` is
accepted for the JAX signature: the ops work per sample, so the batch's
placement does not change them.
"""

import torch

from memcnet_tpu_torch.ops.cuda import project_kernel, warp_kernel
from memcnet_tpu_torch.parallel.ring import TileRing


def _grid(mesh, shape, axis, axis_h, halo, halo_h):
    """(tile width, tile height, row halo; 0 where H is not tiled)."""
    _, _, H, W = shape
    t = mesh.shape[axis]
    th = mesh.shape[axis_h] if axis_h else 1
    if W % t or H % th:
        raise ValueError(f"a {H}x{W} frame does not split into {th} x {t} tiles")
    hh = (halo_h if halo_h is not None else halo) if axis_h else 0
    return W // t, H // th, hh


def _ring(mesh, batch, axis, axis_h):
    return TileRing(mesh, ((axis, -1),) + (((axis_h, -2),) if axis_h else ()), batch)


def _origins(ring, axis, axis_h, Wl, Hl, device):
    """(n, 2) int32: each tile's (x, y) origin in the whole frame."""
    x0 = ring.index(axis, device) * Wl
    y0 = ring.index(axis_h, device) * Hl if axis_h else torch.zeros_like(x0)
    return torch.stack([x0, y0], dim=1).to(torch.int32)


def _exchange_halo(img, ring, axis, halo, dim):
    """Bring ``halo`` slices from each ring neighbour along ``dim`` (-1
    columns, -2 rows); global-edge tiles replicate their own border."""
    t = ring.size(axis)
    n = img.shape[dim]
    lead = img.narrow(dim, 0, halo)
    trail = img.narrow(dim, n - halo, halo)
    if t > 1:
        from_prev = ring.shift(trail, axis, 1)   # the previous tile's trailing edge
        from_next = ring.shift(lead, axis, -1)   # the next tile's leading edge
    else:
        from_prev, from_next = trail, lead
    idx = ring.index(axis, img.device).view(-1, *([1] * (img.dim() - 1)))
    from_prev = torch.where(idx == 0, img.narrow(dim, 0, 1).expand_as(from_prev), from_prev)
    from_next = torch.where(idx == t - 1, img.narrow(dim, n - 1, 1).expand_as(from_next),
                            from_next)
    return torch.cat([from_prev, img, from_next], dim=dim)


def warp_tiles(ring, images, flow, filt, *, frame, filter_size=4, halo=64, axis="tile",
               axis_h=None, halo_h=None):
    """The tile-local warp: tiles (n, C_k, Hl, Wl) of channel-split sources,
    their flow and filter tiles, ``ring`` over their batch and the frame's
    global (H, W) in; the warped tiles out, one per source."""
    H, W = frame
    Hl, Wl = images[0].shape[-2:]
    hh = (halo_h if halo_h is not None else halo) if axis_h else 0
    if halo > Wl or hh > Hl:
        raise ValueError(f"halo {halo}x{hh} exceeds the {Hl}x{Wl} tile")
    exts = []
    for im in images:
        ext = _exchange_halo(im, ring, axis, halo, -1)
        if axis_h:  # rows second: the W-extended tile's corner halos ride along
            ext = _exchange_halo(ext, ring, axis_h, hh, -2)
        exts.append(ext)
    origins = _origins(ring, axis, axis_h, Wl, Hl, flow.device)
    return warp_kernel.warp_tile(exts, flow, filt, origins, halo, hh, filter_size, W, H)


def tiled_filter_interp_warp_split(mesh, images, flow, filt, *, filter_size=4, halo=64,
                                   axis="tile", batch_axis=None, axis_h=None, halo_h=None):
    """The tiled warp of channel-split sources sharing one flow and filter
    (up to 4, as K1 takes them): the sources are never concatenated.
    Returns one whole-frame result per source."""
    images = tuple(images)
    _grid(mesh, images[0].shape, axis, axis_h, halo, halo_h)
    B, _, H, W = images[0].shape
    ring = _ring(mesh, B, axis, axis_h)
    outs = warp_tiles(ring, [ring.split(im) for im in images], ring.split(flow),
                      ring.split(filt), frame=(H, W), filter_size=filter_size, halo=halo,
                      axis=axis, axis_h=axis_h, halo_h=halo_h)
    return tuple(ring.merge(o) for o in outs)


def tiled_filter_interp_warp(mesh, image, flow, filt, *, filter_size=4, halo=64, axis="tile",
                             batch_axis=None, axis_h=None, halo_h=None):
    """The tiled adaptive warp of image (B, C, H, W) along flow (B, 2, H, W)
    with filter (B, fs^2, H, W): whole frames in, the whole warped frame
    out."""
    return tiled_filter_interp_warp_split(
        mesh, (image,), flow, filt, filter_size=filter_size, halo=halo, axis=axis,
        batch_axis=batch_axis, axis_h=axis_h, halo_h=halo_h)[0]


def _fold_and_exchange_spill(pay, ring, axis, halo, dim):
    """Fold the global far-border +1 contribution back (last tile), then add
    the halo spill bands into the ring neighbours along ``dim``.  pay: (n,
    3, He, We) sums of an extended buffer whose own region is [halo, len -
    halo) along ``dim``; edge tiles take no wraparound spill."""
    t = ring.size(axis)
    idx = ring.index(axis, pay.device).view(-1, 1, 1, 1)
    n = pay.shape[dim]

    def sl(start, size):  # of the current pay
        return pay.narrow(dim, start, size)

    border = sl(n - halo - 1, 1)
    border = torch.where(idx == t - 1, border + sl(n - halo, 1), border)
    pay = torch.cat([sl(0, n - halo - 1), border, sl(n - halo, halo)], dim=dim)
    lead, trail = sl(0, halo), sl(n - halo, halo)
    if t > 1:
        from_prev = ring.shift(trail, axis, 1)
        from_next = ring.shift(lead, axis, -1)
    else:
        from_prev, from_next = trail, lead
    zero = torch.zeros((), dtype=pay.dtype, device=pay.device)
    from_prev = torch.where(idx == 0, zero, from_prev)
    from_next = torch.where(idx == t - 1, zero, from_next)
    return torch.cat([sl(0, halo), sl(halo, halo) + from_prev, sl(2 * halo, n - 4 * halo),
                      sl(n - 2 * halo, halo) + from_next, sl(n - halo, halo)], dim=dim)


def _edge_message(has, avg, dim, last):
    """Per line along ``dim`` of has (n, Hl, Wl): (found, value) of its last
    (or first) projected pixel, packed (n, 3, L) float32: the summary a
    tile passes to the next tile of a chained hole search."""
    L = has.shape[dim]
    shape = [1, 1, 1]
    shape[dim] = L
    pos = torch.arange(L, device=has.device).view(shape)
    if last:
        i = torch.where(has, pos, -1).amax(dim)
    else:
        i = torch.where(has, pos, L).amin(dim)
    found = (i >= 0) & (i < L)
    at = i.clamp(0, L - 1).unsqueeze(1).unsqueeze(dim + 1).expand(-1, 2, -1, -1)
    v = avg.gather(dim + 1, at).squeeze(dim + 1)
    return torch.cat([found.float()[:, None], v], dim=1)


def _carry(msg, ring, axis, step):
    """The nearest tile's message along ``axis`` (from lower tile indices
    when step = 1, higher when -1): t - 1 ring hops, the first tile holding
    a value wins and the global edge masks the wraparound."""
    t = ring.size(axis)
    idx = ring.index(axis, msg.device).view(-1, 1)
    have = torch.zeros_like(msg[:, 0], dtype=torch.bool)
    val = torch.zeros_like(msg[:, 1:])
    for k in range(1, t):
        msg = ring.shift(msg, axis, step)
        ok = (idx >= k) if step > 0 else (idx <= t - 1 - k)
        fresh = (msg[:, 0] > 0) & ok
        val = torch.where((fresh & ~have)[:, None], msg[:, 1:], val)
        have = have | fresh
    return torch.cat([have.float()[:, None], val], dim=1)


def _row_carries(avg, has, ring, axis):
    """The left and right carries of each row, (n, 3, Hl) each."""
    return (_carry(_edge_message(has, avg, 2, last=True), ring, axis, 1),
            _carry(_edge_message(has, avg, 2, last=False), ring, axis, -1))


def _up_carry(avg, has, ring, axis_h):
    """The up carry of each column, (n, 3, Wl)."""
    return _carry(_edge_message(has, avg, 1, last=True), ring, axis_h, 1)


def tiled_fill_reference(avg, cnt, ring, axis, axis_h, dtype, left=None, right=None, up=None):
    """The tiled fill's plain composition: the carries not given made by
    ``_edge_message`` and ``_carry`` over the ring (``up`` only where H is
    tiled), then ``carry_fill_reference``."""
    has = cnt > 0.0
    if left is None:
        left, right = _row_carries(avg, has, ring, axis)
    if up is None and axis_h:
        up = _up_carry(avg, has, ring, axis_h)
    return project_kernel.carry_fill_reference(avg, cnt, left, right, up, dtype)


def _tiled_fill(avg, cnt, ring, axis, axis_h, dtype):
    """The hole fill of the cropped tiles, each search continued into the
    other tiles: left and right over ``axis``, up over ``axis_h`` when H is
    tiled (tile-local otherwise); down dead.  K3's tile entry fills from
    ``avg, cnt`` alone along an axis stacked in this process's batch, and
    takes the carries of an axis across ranks; ``tiled_fill_reference`` is
    its CPU path and its backward."""
    stacks = (ring.stacked(axis), ring.stacked(axis_h) if axis_h else None)
    left = right = up = None
    across_h = axis_h and stacks[1] is None
    if stacks[0] is None or across_h:
        has = cnt > 0.0
        if stacks[0] is None:
            left, right = _row_carries(avg, has, ring, axis)
        if across_h:
            up = _up_carry(avg, has, ring, axis_h)
    return project_kernel.tile_fill(
        avg, cnt, stacks, left, right, up, dtype,
        lambda a, c, lf, rt, u: tiled_fill_reference(a, c, ring, axis, axis_h, dtype, lf, rt, u))


def _tile_average(ring, flow, frame, halo, axis, axis_h, halo_h):
    """The tiles' float32 average (n, 2, Hl, Wl) and count (n, Hl, Wl) of
    flow tiles (n, 2, Hl, Wl): the scatter, the spill exchange, the crop and
    the divide."""
    H, W = frame
    Hl, Wl = flow.shape[-2:]
    hh = (halo_h if halo_h is not None else halo) if axis_h else 0
    if Wl < 2 * halo or (hh and Hl < 2 * hh):
        raise ValueError(f"the projection needs tiles of at least twice the halo: {Hl}x{Wl} "
                         f"tiles, halo {hh}x{halo}")
    origins = _origins(ring, axis, axis_h, Wl, Hl, flow.device)
    pay = project_kernel.tile_sums(flow, origins, halo, hh, W, H)
    pay = _fold_and_exchange_spill(pay, ring, axis, halo, -1)
    if axis_h:
        pay = _fold_and_exchange_spill(pay, ring, axis_h, hh, -2)[:, :, hh:hh + Hl]
    pay = pay[..., halo:halo + Wl]
    cnt = pay[:, 2]
    return pay[:, :2] / torch.where(cnt > 0.0, cnt, 1.0)[:, None], cnt


def _tiled_average(mesh, flow, halo, axis, axis_h, halo_h):
    """``_tile_average`` of whole frames, and their ring."""
    _grid(mesh, flow.shape, axis, axis_h, halo, halo_h)
    B, _, H, W = flow.shape
    ring = _ring(mesh, B, axis, axis_h)
    avg, cnt = _tile_average(ring, ring.split(flow), (H, W), halo, axis, axis_h, halo_h)
    return avg, cnt, ring


def project_tiles(ring, flow, *, frame, halo=64, fillhole=False, axis="tile", axis_h=None,
                  halo_h=None):
    """The tile-local flow projection: flow tiles (n, 2, Hl, Wl), ``ring``
    over their batch and the frame's global (H, W) in; the projected tiles
    in the flow's type out."""
    avg, cnt = _tile_average(ring, flow, frame, halo, axis, axis_h, halo_h)
    if fillhole:
        return _tiled_fill(avg, cnt, ring, axis, axis_h, flow.dtype)
    return avg.to(flow.dtype)


def tiled_flow_project(mesh, flow, *, halo=64, fillhole=False, axis="tile", batch_axis=None,
                       axis_h=None, halo_h=None):
    """The tiled flow projection of flow (B, 2, H, W): whole frames in, the
    whole projected flow (B, 2, H, W) in the flow's type out.  With
    ``axis_h`` the column spills are exchanged first over the whole
    extended rows, so a corner spill reaches its diagonal neighbour in two
    hops."""
    _grid(mesh, flow.shape, axis, axis_h, halo, halo_h)
    B, _, H, W = flow.shape
    ring = _ring(mesh, B, axis, axis_h)
    return ring.merge(project_tiles(ring, ring.split(flow), frame=(H, W), halo=halo,
                                    fillhole=fillhole, axis=axis, axis_h=axis_h, halo_h=halo_h))
