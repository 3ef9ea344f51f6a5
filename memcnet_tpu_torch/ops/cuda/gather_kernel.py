"""K5: the bilinear grid-sample kernel and SPyNet's level input built around
it, their plain versions and their launch count.

Replaces the TPU kernel ``memcnet_tpu/ops/pallas/gather_kernel.py::
gather_bands`` (kernel ``_gather_kernel``), whose one model use is
``grid_sample_bilinear`` in SPyNet's backward warp.  CUDA source:
``memcnet_tpu_torch/csrc/gather.cu``, two entries over one tap function.

``grid_sample``: ``F.grid_sample(x, grid, mode='bilinear',
padding_mode='zeros', align_corners=True)`` written as ``_grid_sample_xla``
(memcnet_tpu/nn/layers.py:334-360) writes it: unnormalise ``(g + 1) * (W - 1)
/ 2``, floor, four bilinear taps, each out-of-range tap zeroed.  Coordinates,
weights and sums are float32 whatever x's type, and the result is rounded
once to x's type, as the Pallas kernel does.  Any grid size (B, Ho, Wo, 2) is
served, one thread per output pixel.

``level_input``: the input of one SPyNet level, ``cat(fst, warp(snd, up),
up)`` with ``up`` the coarse flow upsampled x2 (bilinear, align_corners=True),
times 2 and replicate-padded to an odd level's size, and the warp a grid
sample on the float32 grid ``warp_grid(up)``.  On the card it is one launch:
the kernel computes ``up`` and the grid per pixel in the float32 order of
the PyTorch CUDA ops that ``level_input_reference`` runs, so ``up`` equals
theirs bit for bit.

``level_input_tile``: the same level input on the tiles of a partitioned
frame (parallel/partition.py), on the frame's global coordinates: the
tile's fst, the second frame's whole level (``Partition.gather``: a flow
may sample anywhere), the coarse flow's window with the 0-1 halo that the
global upsample reads (``Partition.level_input_window``) and each tile's
global origin.  The upsample lerps, the linspace and the ``(W - 1) / 2``
scale are the frame level's, the replicate pad falls only at the frame's
bottom and right edges, and the float32 order is the untiled kernel's, so a
tile's fst and up channels equal the untiled kernel's bit for bit.  The
positions a stacked tile holds beyond those it owns (padding to the widest
tile) get zeros in the warp and up channels.  One launch per level serves
every stacked tile.

What bounds all three on the H100: memory.  The level input reads the coarse
flow, fst and snd once and writes its 8 channels once (60 MB at 768x1344,
B = 2, bf16), where the separate ops wrote and re-read a float32 grid and the
concat.  The TPU band plan, zero-ring pre-pad, lane padding and ``gather_ok``
budget were DMA geometry; a CUDA thread reads any address, and the zero ring
becomes a bounds test per tap.
"""

import numpy as np
import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import _lib

# one count per launch of either entry: SPyNet launches K5 once per level
counter = _lib.LaunchCounter("grid_sample")
# the tile entry's: once per level on partitioned frames
tile_counter = _lib.LaunchCounter("level_input_tile")


def reference(x, grid):
    """Plain PyTorch version: the 4-tap formulation, float32, rounded once."""
    B, C, H, W = x.shape
    _, Ho, Wo, _ = grid.shape
    g = grid.float()
    gx = (g[..., 0] + 1.0) * (W - 1) / 2.0
    gy = (g[..., 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    x0 = x0.long()
    y0 = y0.long()
    src = x.float().reshape(B, C, H * W)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, Ho * Wo)
        v = torch.gather(src, 2, lin.expand(B, C, Ho * Wo)).reshape(B, C, Ho, Wo)
        return v * inb[:, None]

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
           + tap(y0, x0 + 1) * (wx * (1 - wy))[:, None]
           + tap(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
           + tap(y0 + 1, x0 + 1) * (wx * wy)[:, None])
    return out.to(x.dtype)


def launch(x, grid):
    what = "grid_sample"
    B, C, H, W = x.shape
    if grid.dim() != 4 or grid.shape[0] != B or grid.shape[3] != 2:
        raise ValueError(f"{what}: grid {tuple(grid.shape)} is not (B, Ho, Wo, 2) for x "
                         f"{tuple(x.shape)}")
    code = _lib.dtype_code(x.dtype)
    x = x.contiguous()
    grid = grid.float().contiguous()
    _lib.check_cuda_args(what, x, grid)
    lib = _lib.lib()
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    err = lib.memc_grid_sample(x.data_ptr(), grid.data_ptr(), out.data_ptr(),
                               B, C, H, W, Ho, Wo, code, _lib.stream_ptr(x))
    _lib.check(err, what)
    counter.count += 1
    return out


class _GridSampleFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain version for x and
    grid (as ``_gs_fast_op``'s VJP is that of ``_grid_sample_xla``)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x, grid)
        return launch(x, grid)

    @staticmethod
    def backward(ctx, g):
        x, grid = ctx.saved_tensors
        gx, gg = _lib.reference_grads(reference, [x, grid], list(ctx.needs_input_grad[:2]), [g])
        return gx, gg


def grid_sample(x, grid):
    """Bilinear, zeros, align_corners=True grid sample: the kernel on CUDA
    tensors, the plain version on CPU tensors.  x (B, C, H, W), grid
    (B, Ho, Wo, 2) -> (B, C, Ho, Wo) in x's type."""
    if _lib.on_cuda(x, grid):
        return _GridSampleFunction.apply(x, grid)
    return reference(x, grid)


# -- SPyNet's level input ------------------------------------------------------


def warp_grid(flow):
    """The normalised (B, H, W, 2) float32 sampling grid of a (B, 2, H, W)
    flow in pixels: the identity grid plus the flow (Network.py:120-134).
    Float32 whatever the flow's type: the JAX package builds it in the flow's
    type (spynet.py:77-81), which in bf16 puts the sampled column up to 7 px
    off at W = 1344 (ROADMAP.md Queue C)."""
    _, _, H, W = flow.shape
    f = flow.float()
    gx = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=f.device).view(1, 1, W)
    gy = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=f.device).view(1, H, 1)
    return torch.stack([gx + f[:, 0] / ((W - 1) / 2.0), gy + f[:, 1] / ((H - 1) / 2.0)], dim=-1)


def level_input_reference(fst, snd, flow):
    """Plain version of the level input: SPyNet's level steps as separate
    ops.  ``up`` = ``nn/layers.py::upsample_bilinear`` of the coarse flow
    times 2.0, ``replication_pad2d`` to fst's size on an odd level; then
    ``cat(fst, reference(snd, warp_grid(up)), up)``."""
    up = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
    pad_b = fst.shape[2] - up.shape[2]
    pad_r = fst.shape[3] - up.shape[3]
    if pad_b or pad_r:
        up = F.pad(up, (0, pad_r, 0, pad_b), mode="replicate")
    return torch.cat([fst, reference(snd, warp_grid(up)), up], dim=1)


def launch_level_input(fst, snd, flow):
    what = "spynet_level_input"
    if fst.dim() != 4 or fst.shape[1] != 3 or snd.shape != fst.shape:
        raise ValueError(f"{what}: fst {tuple(fst.shape)} and snd {tuple(snd.shape)} are not "
                         "one (B, 3, H, W) shape")
    B, _, H, W = fst.shape
    if tuple(flow.shape) != (B, 2, H // 2, W // 2) or H < 2 or W < 2:
        raise ValueError(f"{what}: flow {tuple(flow.shape)} is not (B, 2, H // 2, W // 2) for "
                         f"a level of {tuple(fst.shape)}")
    if not fst.dtype == snd.dtype == flow.dtype:
        raise TypeError(f"{what}: fst, snd and flow must have one type, got {fst.dtype}, "
                        f"{snd.dtype}, {flow.dtype}")
    code = _lib.dtype_code(fst.dtype)
    _lib.check_cuda_args(what, fst, snd, flow)
    out = torch.empty((B, 8, H, W), dtype=fst.dtype, device=fst.device)
    err = _lib.lib().memc_spynet_level_input(fst.data_ptr(), snd.data_ptr(), flow.data_ptr(),
                                             out.data_ptr(), B, H, W, code, _lib.stream_ptr(fst))
    _lib.check(err, what)
    counter.count += 1
    return out


class _LevelInputFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain composition for
    fst, snd and flow."""

    @staticmethod
    def forward(ctx, fst, snd, flow):
        ctx.save_for_backward(fst, snd, flow)
        return launch_level_input(fst, snd, flow)

    @staticmethod
    def backward(ctx, g):
        return tuple(_lib.reference_grads(level_input_reference, list(ctx.saved_tensors),
                                          list(ctx.needs_input_grad[:3]), [g]))


def level_input(fst, snd, flow):
    """The input of one SPyNet level: fst, snd (B, 3, H, W), the coarse flow
    (B, 2, H // 2, W // 2) in pixels, one type -> (B, 8, H, W)
    ``cat(fst, warp(snd, up), up)``.  The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _lib.on_cuda(fst, snd, flow):
        return _LevelInputFunction.apply(fst, snd, flow)
    return level_input_reference(fst, snd, flow)


# -- SPyNet's level input on the tiles of a partitioned frame -----------------


def _up_taps(pos, g):
    """(i0, i1, l0, l1) of the x2 align_corners upsample from g positions at
    the global output positions ``pos`` (int64), in float32 as the kernel's
    up_lerp: the replicate pad of an odd level clamps pos to 2g - 1."""
    scale = float(np.float32(g - 1) / np.float32(2 * g - 1))
    src = pos.clamp(max=2 * g - 1).float() * scale
    i0 = src.long()
    l1 = src - i0.float()
    return i0, i0 + (i0 < g - 1).long(), 1.0 - l1, l1


def level_input_tile_reference(fst, snd, flow, origins, GH, GW):
    """Plain version of the tile entry: fst (n, 3, h, w) tiles, snd (S, 3,
    GH, GW) whole levels (tile j samples snd[j % S]), flow (n, 2, hc, wc)
    windows of the coarse flow, origins (n, 6) int32 (y0, x0, cy0, cx0,
    owned h, owned w) -> (n, 8, h, w) ``cat(fst, warp(snd, up), up)`` on the
    global coordinates, zero beyond the owned positions in the last five
    channels."""
    n, _, h, w = fst.shape
    hc, wc = flow.shape[2:]
    o = origins.long()
    Y = o[:, 0:1] + torch.arange(h, device=o.device)  # (n, h)
    X = o[:, 1:2] + torch.arange(w, device=o.device)
    yi0, yi1, yl0, yl1 = _up_taps(Y, GH // 2)
    xi0, xi1, xl0, xl1 = _up_taps(X, GW // 2)
    f = flow.float()

    def cols(i):  # (n, 2, hc, w) of the window's columns i - cx0
        idx = (i - o[:, 3:4]).clamp(0, wc - 1)
        return f.gather(3, idx[:, None, None, :].expand(n, 2, hc, w))

    rowlerp = xl0[:, None, None, :] * cols(xi0) + xl1[:, None, None, :] * cols(xi1)

    def rows(i):  # (n, 2, h, w) of the window's rows i - cy0
        idx = (i - o[:, 2:3]).clamp(0, hc - 1)
        return rowlerp.gather(2, idx[:, None, :, None].expand(n, 2, h, w))

    v = yl0[:, None, :, None] * rows(yi0) + yl1[:, None, :, None] * rows(yi1)
    up = v.to(fst.dtype) * 2.0
    owned = ((torch.arange(h, device=o.device) < o[:, 4:5])[:, :, None]
             & (torch.arange(w, device=o.device) < o[:, 5:6])[:, None, :])  # (n, h, w)
    warped = reference(tile_sources(snd, n), tile_grid(up, origins, GH, GW))
    keep = owned[:, None]
    return torch.cat([fst, torch.where(keep, warped, 0.0), torch.where(keep, up, 0.0)], dim=1)


def tile_sources(snd, n):
    """The whole level each of n tiles samples: snd[j % S] for tile j."""
    return snd.index_select(0, torch.arange(n, device=snd.device) % snd.shape[0])


def tile_grid(up, origins, GH, GW):
    """``warp_grid`` of the tiles' up (n, 2, h, w) on the level's global
    coordinates: the normalised float32 (n, h, w, 2) grid over GH x GW."""
    _, _, h, w = up.shape
    o = origins.long()
    Y = (o[:, 0:1] + torch.arange(h, device=o.device)).clamp(max=GH - 1)
    X = (o[:, 1:2] + torch.arange(w, device=o.device)).clamp(max=GW - 1)
    u = up.float()
    gx = torch.linspace(-1.0, 1.0, GW, dtype=torch.float32, device=u.device)
    gy = torch.linspace(-1.0, 1.0, GH, dtype=torch.float32, device=u.device)
    return torch.stack([gx[X][:, None, :] + u[:, 0] / ((GW - 1) / 2.0),
                        gy[Y][:, :, None] + u[:, 1] / ((GH - 1) / 2.0)], dim=-1)


def launch_level_input_tile(fst, snd, flow, origins, GH, GW):
    what = "spynet_level_input_tile"
    if fst.dim() != 4 or fst.shape[1] != 3:
        raise ValueError(f"{what}: fst {tuple(fst.shape)} is not (n, 3, h, w)")
    n, _, h, w = fst.shape
    S = snd.shape[0]
    if tuple(snd.shape) != (S, 3, GH, GW) or S == 0 or n % S or GH < 2 or GW < 2:
        raise ValueError(f"{what}: snd {tuple(snd.shape)} is not a whole (S, 3, {GH}, {GW}) "
                         f"level of the {n} tiles")
    if flow.dim() != 4 or flow.shape[:2] != (n, 2):
        raise ValueError(f"{what}: flow {tuple(flow.shape)} is not (n, 2, hc, wc)")
    if tuple(origins.shape) != (n, 6) or origins.dtype != torch.int32:
        raise ValueError(f"{what}: origins must be (n, 6) int32, got {tuple(origins.shape)} "
                         f"{origins.dtype}")
    if not fst.dtype == snd.dtype == flow.dtype:
        raise TypeError(f"{what}: fst, snd and flow must have one type, got {fst.dtype}, "
                        f"{snd.dtype}, {flow.dtype}")
    code = _lib.dtype_code(fst.dtype)
    _lib.check_cuda_args(what, fst, snd, flow, origins)
    out = torch.empty((n, 8, h, w), dtype=fst.dtype, device=fst.device)
    err = _lib.lib().memc_spynet_level_input_tile(
        fst.data_ptr(), snd.data_ptr(), flow.data_ptr(), origins.data_ptr(), out.data_ptr(),
        n, S, h, w, flow.shape[2], flow.shape[3], GH, GW, code, _lib.stream_ptr(fst))
    _lib.check(err, what)
    tile_counter.count += 1
    return out


class _LevelInputTileFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain version for fst,
    snd and flow."""

    @staticmethod
    def forward(ctx, fst, snd, flow, origins, GH, GW):
        ctx.save_for_backward(fst, snd, flow, origins)
        ctx.level = (GH, GW)
        return launch_level_input_tile(fst, snd, flow, origins, GH, GW)

    @staticmethod
    def backward(ctx, g):
        fst, snd, flow, origins = ctx.saved_tensors

        def plain(f, s, fl):
            return level_input_tile_reference(f, s, fl, origins, *ctx.level)

        grads = _lib.reference_grads(plain, [fst, snd, flow], list(ctx.needs_input_grad[:3]),
                                     [g])
        return (*grads, None, None, None)


def level_input_tile(fst, snd, flow, origins, GH, GW):
    """SPyNet's level input on the tiles of a partitioned frame (see the
    module docstring; ``level_input_tile_reference`` for the arguments):
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if _lib.on_cuda(fst, snd, flow, origins):
        return _LevelInputTileFunction.apply(fst, snd, flow, origins, GH, GW)
    return level_input_tile_reference(fst, snd, flow, origins, GH, GW)
