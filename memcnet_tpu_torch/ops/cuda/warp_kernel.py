"""K1: the adaptive filter-interpolation warp kernel, its plain version and
its launch count.

Replaces the TPU kernel ``memcnet_tpu/ops/pallas/warp_kernel.py::
filter_interp_warp_bands_hcw2`` (and with it the A/B variants
``filter_interp_warp_bands_hcw``, ``filter_interp_warp_bands`` and
``filter_interp_warp_tiles``, which compute the same function).  CUDA source:
``memcnet_tpu_torch/csrc/warp.cu``.

What bounds it on the H100: memory -- every input plane read once and every
output plane written once.  Its design (csrc/warp.cu): a block owns a 32 x 8
pixel tile; each thread computes its pixel's fs^2 tap weights once, in
float32 from float32 landing coordinates; the block stages the bounding box
of its patches in shared memory two channels at a time (coalesced loads,
channels interleaved) and sums every tap from there, or gathers from global
memory where the box is too wide or the launch has at most 4 channels.
Sources and outputs stay separate tensors, so frame and context are never
concatenated.  The TPU band plans, the ``hcw_ok`` budget and the
``lax.cond`` XLA fallback existed for TPU DMA alignment and have no
counterpart.

Landing coordinates are float32 whatever the activation type: the JAX bf16
path builds its pixel grid in bf16 (``ops/warp.py::_base_coords``), which
cannot represent most x above 256.

The tile entry (``warp_tile``, ``memc_filter_interp_warp_tile``: the same
kernel with its TILE flag) serves the tiled warp of ``parallel/tiling.py``:
the JAX package's ``parallel/tiling.py::_local_filter_interp``, which runs no
Pallas kernel.  Each sample is one tile: its sources extended by a halo,
its flow and filter and its output at the tile's size, its origin in the
whole frame per sample.  The flow is clamped to the halo budget, the gate
reads whole-frame coordinates, and the taps are clamped to the extended
tile.  It bounds like K1 over the extended sources: at star's shape in four
tiles of 336 columns with a 64-column halo it reads the sources 464/336 =
1.38 times.  Counted by ``tile_counter``.
"""

import ctypes

import torch

from memcnet_tpu_torch.ops.cuda import _lib

counter = _lib.LaunchCounter("filter_interp_warp")
tile_counter = _lib.LaunchCounter("filter_interp_warp_tile")
MAX_SOURCES = 4  # csrc/warp.cu kMaxSources


class _WarpSources(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p * MAX_SOURCES),
        ("out", ctypes.c_void_p * MAX_SOURCES),
        ("channels", ctypes.c_int * MAX_SOURCES),
        ("n", ctypes.c_int),
    ]


def valid_and_taps(flow, H, W):
    """Validity gate, integer tap base and subpixel fractions, all from
    float32 landing coordinates (memcnet_tpu/ops/warp.py:94-112)."""
    f = flow.float()
    fx, fy = f[:, 0], f[:, 1]
    xs = torch.arange(W, dtype=torch.float32, device=f.device).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=f.device).view(1, H, 1)
    x2 = xs + fx
    y2 = ys + fy
    valid = ((x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
             & (fx.abs() < W / 2.0) & (fy.abs() < H / 2.0))
    # int() truncation == floor on the valid domain (x2 >= 0)
    ix = x2.to(torch.int32).clamp(0, W - 1)
    iy = y2.to(torch.int32).clamp(0, H - 1)
    alpha = x2 - ix.float()
    beta = y2 - iy.float()
    return valid, ix.long(), iy.long(), alpha, beta


def reference(images, flow, filt, filter_size=4):
    """Plain PyTorch version (the formulation of
    memcnet_tpu/ops/warp.py::_xla_forward, one tap at a time).  Returns one
    warped tensor per source; invalid pixels pass the source through with its
    gradient detached."""
    fs, half = filter_size, filter_size // 2
    B, _, H, W = images[0].shape
    dt = images[0].dtype
    valid, ix, iy, alpha, beta = valid_and_taps(flow, H, W)
    filt32 = filt.float()
    taps = []
    for j in range(fs):
        wy = beta if j >= half else 1.0 - beta
        row = (iy + 1 - half + j).clamp(0, H - 1) * W
        for i in range(fs):
            wx = alpha if i >= half else 1.0 - alpha
            # weight rounded to the source type, as the XLA formulation does
            w = (filt32[:, j * fs + i] * wy * wx).to(dt).float()
            lin = (row + (ix + 1 - half + i).clamp(0, W - 1)).view(B, 1, H * W)
            taps.append((w, lin))
    outs = []
    for img in images:
        C = img.shape[1]
        flat = img.reshape(B, C, H * W)
        acc = None
        for w, lin in taps:
            v = torch.gather(flat, 2, lin.expand(B, C, H * W)).view(B, C, H, W).float()
            acc = w[:, None] * v if acc is None else acc + w[:, None] * v
        outs.append(torch.where(valid[:, None], acc.to(dt), img.detach()))
    return tuple(outs)


def launch(images, flow, filt, filter_size=4):
    """Run the CUDA kernel on CUDA tensors; returns one output per source."""
    what = "filter_interp_warp"
    if not 1 <= len(images) <= MAX_SOURCES:
        raise ValueError(f"{what}: takes 1..{MAX_SOURCES} sources, got {len(images)}")
    B, _, H, W = images[0].shape
    dt = images[0].dtype
    code = _lib.dtype_code(dt)
    fs = filter_size
    if fs not in (2, 4):
        raise ValueError(f"{what}: the kernel is built for filter_size 2 and 4, got {fs}")
    imgs = [im.contiguous() for im in images]
    flow32 = flow.float().contiguous()
    filt_c = filt.to(dt).contiguous()
    for im in imgs:
        if im.dtype != dt or im.dim() != 4 or im.shape[0] != B or im.shape[2:] != (H, W):
            raise ValueError(f"{what}: sources must share batch, size and type")
    if flow32.shape != (B, 2, H, W) or filt_c.shape != (B, fs * fs, H, W):
        raise ValueError(f"{what}: flow {tuple(flow.shape)} / filter {tuple(filt.shape)} "
                         f"do not match sources {(B, H, W)} with filter_size {fs}")
    _lib.check_cuda_args(what, flow32, filt_c, *imgs)
    lib = _lib.lib()
    outs = [torch.empty_like(im) for im in imgs]
    s = _WarpSources()
    for k, (im, out) in enumerate(zip(imgs, outs)):
        s.src[k] = im.data_ptr()
        s.out[k] = out.data_ptr()
        s.channels[k] = im.shape[1]
    s.n = len(imgs)
    err = lib.memc_filter_interp_warp(
        ctypes.byref(s), flow32.data_ptr(), filt_c.data_ptr(), B, H, W, fs, code,
        _lib.stream_ptr(flow32))
    _lib.check(err, what)
    counter.count += 1
    return tuple(outs)


class _WarpFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain version (the JAX
    custom_vjp differentiates its XLA formulation the same way)."""

    @staticmethod
    def forward(ctx, flow, filt, filter_size, *images):
        ctx.filter_size = filter_size
        ctx.save_for_backward(flow, filt, *images)
        return launch(images, flow, filt, filter_size)

    @staticmethod
    def backward(ctx, *grads):
        flow, filt, *images = ctx.saved_tensors
        fs = ctx.filter_size
        needs = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 *ctx.needs_input_grad[3:]]
        g = _lib.reference_grads(
            lambda fl, fi, *ims: reference(ims, fl, fi, fs),
            [flow, filt, *images], needs, grads)
        return (g[0], g[1], None, *g[2:])


def warp(images, flow, filt, filter_size=4):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    images = tuple(images)
    if _lib.on_cuda(flow, filt, *images):
        return _WarpFunction.apply(flow, filt, filter_size, *images)
    return reference(images, flow, filt, filter_size)


# -- the tile entry --------------------------------------------------------------


def tile_taps(flow, origins, halo, halo_h, filter_size, W, H):
    """The tile entry's gate, integer tap base in the extended tile (iy, ix)
    and subpixel fractions, from float32 whole-frame coordinates of the flow
    clamped to the halo budget.  flow: (n, 2, Hl, Wl); origins: (n, 2) int32
    (x, y) of each tile in the H x W frame; halo_h = 0: H is not tiled."""
    n, _, Hl, Wl = flow.shape
    f = flow.float()
    fx = f[:, 0].clamp(-(halo - filter_size), halo - filter_size)
    fy = f[:, 1]
    if halo_h:
        fy = fy.clamp(-(halo_h - filter_size), halo_h - filter_size)
    xo = origins[:, 0].long().view(n, 1, 1)
    yo = origins[:, 1].long().view(n, 1, 1)
    x2 = (xo + torch.arange(Wl, device=f.device).view(1, 1, Wl)).float() + fx
    y2 = (yo + torch.arange(Hl, device=f.device).view(1, Hl, 1)).float() + fy
    valid = ((x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
             & (fx.abs() < W / 2.0) & (fy.abs() < H / 2.0))
    ix = x2.to(torch.int32).clamp(0, W - 1)
    iy = y2.to(torch.int32).clamp(0, H - 1)
    return valid, iy.long() - yo + halo_h, ix.long() - xo + halo, x2 - ix.float(), y2 - iy.float()


def tile_reference(exts, flow, filt, origins, halo, halo_h, filter_size, W, H):
    """Plain version of the tile entry (memcnet_tpu/parallel/tiling.py::
    _local_filter_interp, with ``reference``'s arithmetic): exts are the
    halo-extended sources (n, C_k, Hl + 2 halo_h, Wl + 2 halo); returns one
    (n, C_k, Hl, Wl) output per source, the extended tile's centre passed
    through (gradient detached) where the gate fails."""
    fs, half = filter_size, filter_size // 2
    n, _, He, We = exts[0].shape
    Hl, Wl = He - 2 * halo_h, We - 2 * halo
    dt = exts[0].dtype
    valid, iy, ix, alpha, beta = tile_taps(flow, origins, halo, halo_h, fs, W, H)
    filt32 = filt.float()
    taps = []
    for j in range(fs):
        wy = beta if j >= half else 1.0 - beta
        row = (iy + 1 - half + j).clamp(0, He - 1) * We
        for i in range(fs):
            wx = alpha if i >= half else 1.0 - alpha
            w = (filt32[:, j * fs + i] * wy * wx).to(dt).float()
            lin = (row + (ix + 1 - half + i).clamp(0, We - 1)).view(n, 1, Hl * Wl)
            taps.append((w, lin))
    outs = []
    for ext in exts:
        C = ext.shape[1]
        flat = ext.reshape(n, C, He * We)
        acc = None
        for w, lin in taps:
            v = torch.gather(flat, 2, lin.expand(n, C, Hl * Wl)).view(n, C, Hl, Wl).float()
            acc = w[:, None] * v if acc is None else acc + w[:, None] * v
        centre = ext[:, :, halo_h:halo_h + Hl, halo:halo + Wl]
        outs.append(torch.where(valid[:, None], acc.to(dt), centre.detach()))
    return tuple(outs)


def launch_tile(exts, flow, filt, origins, halo, halo_h, filter_size, W, H):
    """Run the tile entry on CUDA tensors; returns one output per source."""
    what = "filter_interp_warp_tile"
    if not 1 <= len(exts) <= MAX_SOURCES:
        raise ValueError(f"{what}: takes 1..{MAX_SOURCES} sources, got {len(exts)}")
    fs = filter_size
    if fs not in (2, 4) or halo < fs or (halo_h and halo_h < fs):
        raise ValueError(f"{what}: filter_size 2 or 4 and halos of at least it, got {fs}, "
                         f"{halo}, {halo_h}")
    n, _, He, We = exts[0].shape
    Hl, Wl = He - 2 * halo_h, We - 2 * halo
    dt = exts[0].dtype
    code = _lib.dtype_code(dt)
    srcs = [e.contiguous() for e in exts]
    flow32 = flow.float().contiguous()
    filt_c = filt.to(dt).contiguous()
    org = origins.to(torch.int32).contiguous()
    for e in srcs:
        if e.dtype != dt or e.dim() != 4 or e.shape[0] != n or e.shape[2:] != (He, We):
            raise ValueError(f"{what}: sources must share batch, size and type")
    if flow32.shape != (n, 2, Hl, Wl) or filt_c.shape != (n, fs * fs, Hl, Wl) \
            or org.shape != (n, 2):
        raise ValueError(f"{what}: flow {tuple(flow.shape)}, filter {tuple(filt.shape)} and "
                         f"origins {tuple(origins.shape)} do not match {n} tiles of {Hl}x{Wl}")
    _lib.check_cuda_args(what, flow32, filt_c, org, *srcs)
    outs = [torch.empty((n, e.shape[1], Hl, Wl), dtype=dt, device=e.device) for e in srcs]
    s = _WarpSources()
    for k, (e, out) in enumerate(zip(srcs, outs)):
        s.src[k] = e.data_ptr()
        s.out[k] = out.data_ptr()
        s.channels[k] = e.shape[1]
    s.n = len(srcs)
    err = _lib.lib().memc_filter_interp_warp_tile(
        ctypes.byref(s), flow32.data_ptr(), filt_c.data_ptr(), org.data_ptr(), n, Hl, Wl, halo,
        halo_h, H, W, fs, code, _lib.stream_ptr(flow32))
    _lib.check(err, what)
    tile_counter.count += 1
    return tuple(outs)


class _WarpTileFunction(torch.autograd.Function):
    """The tile entry forward; backward is autograd of ``tile_reference``."""

    @staticmethod
    def forward(ctx, flow, filt, origins, geom, *exts):
        ctx.geom = geom
        ctx.save_for_backward(flow, filt, origins, *exts)
        return launch_tile(exts, flow, filt, origins, *geom)

    @staticmethod
    def backward(ctx, *grads):
        flow, filt, origins, *exts = ctx.saved_tensors
        needs = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], *ctx.needs_input_grad[4:]]
        g = _lib.reference_grads(
            lambda fl, fi, *es: tile_reference(es, fl, fi, origins, *ctx.geom),
            [flow, filt, *exts], needs, grads)
        return (g[0], g[1], None, None, *g[2:])


def warp_tile(exts, flow, filt, origins, halo, halo_h, filter_size, W, H):
    """The tile entry on CUDA tensors, its plain version on CPU tensors."""
    exts = tuple(exts)
    if _lib.on_cuda(flow, filt, origins, *exts):
        return _WarpTileFunction.apply(flow, filt, origins,
                                       (halo, halo_h, filter_size, W, H), *exts)
    return tile_reference(exts, flow, filt, origins, halo, halo_h, filter_size, W, H)
