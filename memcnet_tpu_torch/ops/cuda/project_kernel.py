"""K2 and K3: the flow projection as one op on the card -- K2 the base
scatter, border folds and divide, K3 the hole fill -- its plain versions and
its launch counts.

Replaces the TPU kernels ``memcnet_tpu/ops/pallas/scatter_kernel.py::
scatter_bands`` (K2) and ``memcnet_tpu/ops/pallas/fill_kernel.py::fill_holes``
(K3) and the XLA glue around them (``memcnet_tpu/ops/projection.py::
_scatter4``, the divide, ``_directional_fill``).  CUDA source:
``memcnet_tpu_torch/csrc/project.cu``.  A call is at most four device
operations: K2 -- a memset, ``project_scatter_kernel`` and
``project_fold_kernel`` -- counted as one launch of ``base_scatter``, and,
with the fill, K3 -- ``project_fill_kernel`` -- counted as one launch of
``fill_holes``.  K2's payload entry (``payload_project``) serves the depth-
weighted and brightness-gated projections (``ops/projection.py``): the same
three operations on a float32 payload of P = 3 or 4 planes, also counted as
one launch of ``base_scatter``.

Function, per source pixel p with flow f: it lands at p + f, in float32
whatever the flow's type, and if that is inside [0, W-1] x [0, H-1] it adds
(-fx, -fy, 1) to its base cell (trunc(y + fy), trunc(x + fx)) -> the base
sums S (B, 3, H, W).  The three other landing neighbours are the border
folds of S (``fold``), and the average is sum / count where count > 0.  With
the fill, every pixel with count 0 takes the mean of the nearest projected
value to its left, to its right and above it, over the directions that have
one (``memcnet_tpu/ops/projection.py::_directional_fill_xla`` with
``fix_down_scan_bug=False``: the down-scan is dead in the reference,
my_lib_kernel.cu:1799; with the JAX opt-in ``fix_down_scan_bug`` K3 also
takes the nearest value below).  The result is cast to the flow's type once.

The payload entry: the flow sets the landing cells as above, and the P
planes of the payload (zero where a gate fails) are scattered there, folded,
and planes 0 .. P-2 divided by plane P-1 where it is > 0; with the fill,
"has a value" is plane P-1 > 0 (a sum of depths or a count of gated pixels).

What bounds it on the H100: memory (read the flow, write the result).  Its
design: float ``atomicAdd`` into S, which stays in L2; one gather pass per
target pixel for both folds and the divide, which with the fill also packs
"count > 0" into bit masks by rows and by columns, each with one summary bit
per non-empty word (``Masks``); the fill finds each nearest value with bit
scans of its word and, past it, of the summary word, so a search reads
O(1 + L / 1024) words of a line of L pixels however long the run of holes.
The TPU scatter's band plans turned the scatter into shifted vector adds, and
the TPU fill carried the up search from band to band in ``carry_ref``, which
needs grid steps that run in order; CUDA blocks do not.  Float sums land in a
run-dependent order; counts (sums of 1.0) are exact.

The tile entries serve ``parallel/tiling.py::tiled_flow_project`` (the JAX
package's tiled projection, which runs no Pallas kernel: its scatter lands in
a halo-extended buffer).  K2's (``tile_sums``; ``memc_project_tile_sums``:
a memset, ``project_tile_scatter_kernel``, ``project_raw_fold_kernel``,
counted by ``tile_scatter_counter``) scatters each tile's (-fx, -fy, 1),
the flow clamped to the halo budget and gated in whole-frame coordinates,
into its extended buffer and folds the +1 neighbours at that buffer's edges,
with no divide: the spill exchange comes first.  K3's (``carry_fill``;
``memc_project_fill_carry``: a memset, ``project_mask_kernel``,
``project_fill_kernel`` with carries, counted by ``carry_counter``) fills a
cropped tile, taking the carry from the other tiles wherever the tile's own
search finds nothing: the nearest tile wins.

K2's payload entry on tile origins (``payload_tile_sums``;
``memc_project_payload_tile``: a memset, ``project_payload_tile_scatter_kernel``
and ``project_raw_fold_kernel`` of P planes, counted by
``payload_tile_counter``) serves the depth-weighted and gated projections on
partitioned frames (``ops/projection.py``), which the JAX package runs on
``frame_sharding``-placed arrays: each owned pixel of a tile scatters its P
planes at the frame's landing cell -- tile origin + local position, in
float32 -- into its sample's whole-frame buffer, with no flow clamp and no
halo; then both +1 folds at the frame's border.  The divide follows
``parallel/partition.py``'s reduce, which gives each tile its part.
"""

import functools
import math
from collections import namedtuple

import torch

from memcnet_tpu_torch.ops.cuda import _lib

scatter_counter = _lib.LaunchCounter("base_scatter")  # K2
fill_counter = _lib.LaunchCounter("fill_holes")       # K3
tile_scatter_counter = _lib.LaunchCounter("base_scatter_tile")  # K2's tile entry
carry_counter = _lib.LaunchCounter("fill_holes_carry")         # K3's carry entry
payload_tile_counter = _lib.LaunchCounter("base_scatter_payload_tile")  # K2's, on tile origins

# int32 words; bit k of word j = pixel 32 j + k of the line, bit k of a
# summary word j = mask word 32 j + k is not empty; bits past a line are 0.
#   rows (B, H, ceil(W/32)), row_sums (B, H, ceil(W/1024)),
#   cols (B, W, ceil(H/32)), col_sums (B, W, ceil(H/1024))
Masks = namedtuple("Masks", "rows row_sums cols col_sums")


def _words(n):
    return (n + 31) // 32


def mask_shapes(B, H, W):
    return Masks((B, H, _words(W)), (B, H, _words(_words(W))),
                 (B, W, _words(H)), (B, W, _words(_words(H))))


def pack_bits(bits):
    """(..., L) bool -> (..., ceil(L / 32)) int32 words, bit k of word j =
    bits[..., 32 j + k]."""
    L = bits.shape[-1]
    pad = _words(L) * 32 - L
    b = torch.nn.functional.pad(bits.long(), (0, pad)).reshape(*bits.shape[:-1], -1, 32)
    w = (b << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_bits(words, L):
    """Inverse of ``pack_bits``: (..., n) int32 -> (..., L) bool."""
    b = (words.long()[..., None] >> torch.arange(32, device=words.device)) & 1
    return b.reshape(*words.shape[:-1], -1)[..., :L].bool()


def pack_masks(has):
    """``Masks`` of ``has`` (B, H, W) bool, as K2 writes them."""
    rows = pack_bits(has)
    cols = pack_bits(has.transpose(1, 2))
    return Masks(rows, pack_bits(rows != 0), cols, pack_bits(cols != 0))


# -- plain versions ------------------------------------------------------------


def landing_cells(flow):
    """Validity and integer base cell (iyT, ixL) of every source pixel, from
    float32 coordinates.  flow: (B, 2, H, W) float32."""
    B, two, H, W = flow.shape
    if two != 2:
        raise ValueError(f"flow must have 2 channels, got {two}")
    xs = torch.arange(W, dtype=torch.float32, device=flow.device).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=flow.device).view(1, H, 1)
    x2 = xs + flow[:, 0]
    y2 = ys + flow[:, 1]
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    return valid, ixL, iyT


def scatter_reference(payload, lin, size=None):
    """K2's TPU function, plain: ``out[b, k, c]`` = sum of ``payload[b, k, p]``
    over the source pixels p with ``lin[b, p] == c`` (``index_add_`` over the
    flattened batch); pixels with ``lin < 0`` add nothing.  The target is
    ``size`` (H, W), the payload's own by default."""
    B, P, H, W = payload.shape
    Ht, Wt = size or (H, W)
    valid = lin >= 0
    cell = torch.where(valid, lin, torch.zeros_like(lin)).long()
    cell = cell + (torch.arange(B, device=lin.device) * (Ht * Wt)).view(B, 1, 1)
    src = torch.where(valid[:, None], payload.float(), 0.0)
    src = src.permute(0, 2, 3, 1).reshape(B * H * W, P)
    out = torch.zeros(B * Ht * Wt, P, dtype=torch.float32, device=payload.device)
    out = out.index_add(0, cell.reshape(-1), src)
    return out.view(B, Ht, Wt, P).permute(0, 3, 1, 2).contiguous()


def base_sums(flow):
    """Plain S (B, 3, H, W) float32: (-fx, -fy, 1) scattered to the base
    cells of the valid landings."""
    f = flow.float()
    valid, ixL, iyT = landing_cells(f)
    W = f.shape[3]
    payload = torch.cat([-f, torch.ones_like(f[:, :1])], dim=1)
    payload = torch.where(valid[:, None], payload, 0.0)
    lin = torch.where(valid, iyT * W + ixL, torch.full_like(iyT, -1))
    return scatter_reference(payload, lin)


def _fold_axis(a, axis):
    """a + what "scatter to min(i + 1, L - 1)" along ``axis`` adds at each i:
    0 at i = 0, a[i - 1] inside, a[L - 2] + a[L - 1] at the last index
    (my_lib_kernel.cu:1668-1669 clamps); L = 1 doubles a.  Gathered per
    target index, in the order project_fold_kernel adds."""
    L = a.shape[axis]
    if L == 1:
        return a + a
    i = torch.arange(L, device=a.device)
    prev = a.index_select(axis, (i - 1).clamp(min=0))
    shape = [1] * a.dim()
    shape[axis] = L
    i = i.view(shape)
    term = torch.where(i == 0, 0.0, torch.where(i < L - 1, prev, prev + a))
    return a + term


def fold(S):
    """The four landing neighbours from the base sums: the x fold (ixR),
    then the y fold (iyB) of the result."""
    return _fold_axis(_fold_axis(S, 3), 2)


def sums_and_average(flow):
    """Plain (S, average (B, 2, H, W), count (B, H, W)), all float32."""
    S = base_sums(flow)
    out = fold(S)
    cnt = out[:, 2]
    return S, out[:, :2] / torch.where(cnt > 0.0, cnt, 1.0)[:, None], cnt


def _last_valid_index(has, axis, reverse=False):
    """Index of the nearest True at-or-before each position along ``axis``
    (at-or-after when ``reverse``); -1 where there is none."""
    L = has.shape[axis]
    shape = [1] * has.dim()
    shape[axis] = L
    pos = torch.arange(L, device=has.device).view(shape).expand_as(has)
    if reverse:
        pos = (L - 1 - pos)
        idx = torch.where(has, pos, torch.full_like(pos, -1)).flip(axis)
        idx = torch.cummax(idx, dim=axis).values.flip(axis)
        return torch.where(idx >= 0, L - 1 - idx, idx)
    idx = torch.where(has, pos, torch.full_like(pos, -1))
    return torch.cummax(idx, dim=axis).values


def payload_average(flow, payload):
    """Plain (S (B, P, H, W), planes 0 .. P-2 of the folded sums divided by
    plane P-1 where it is > 0 (B, P-1, H, W), plane P-1 (B, H, W)), all
    float32: K2's payload entry.  flow: (B, 2, H, W); payload: (B, P, H, W),
    zero where a gate fails."""
    f = flow.float()
    valid, ixL, iyT = landing_cells(f)
    W = f.shape[3]
    lin = torch.where(valid, iyT * W + ixL, torch.full_like(iyT, -1))
    S = scatter_reference(payload.float(), lin)
    out = fold(S)
    den = out[:, -1]
    return S, out[:, :-1] / torch.where(den > 0.0, den, 1.0)[:, None], den


def fill_reference(avg, cnt, fix_down_scan_bug=False):
    """K3's TPU function, plain: nearest-projected-value scans (cummax over
    indices) and the mean over the directions found.  With
    ``fix_down_scan_bug`` the down direction joins (the JAX opt-in)."""
    has = cnt > 0.0  # (B, H, W)
    a32 = avg.float()
    dirs = [(3, False), (3, True), (2, False)]  # left, right, up
    if fix_down_scan_bug:
        dirs.append((2, True))
    num = torch.zeros_like(a32)
    den = torch.zeros_like(a32[:, 0])
    for axis, rev in dirs:
        idx = _last_valid_index(has, axis - 1, rev)
        found = idx >= 0
        got = torch.gather(a32, axis, idx.clamp(min=0)[:, None].expand_as(a32))
        num = num + torch.where(found[:, None], got, 0.0)
        den = den + found.float()
    hole = (~has) & (den > 0.0)
    filled = num / torch.where(den > 0.0, den, 1.0)[:, None]
    return torch.where(hole[:, None], filled.to(avg.dtype), avg)


def average_and_count(flow, fillhole=False, fix_down_scan_bug=False):
    """The plain composition in float32: (projected flow (B, 2, H, W),
    count (B, H, W))."""
    _, avg, cnt = sums_and_average(flow)
    if fillhole:
        avg = fill_reference(avg, cnt, fix_down_scan_bug=fix_down_scan_bug)
    return avg, cnt


def reference(flow, fillhole=False, fix_down_scan_bug=False):
    """The plain composition of ``flow_project``, on any device."""
    avg, _ = average_and_count(flow, fillhole, fix_down_scan_bug)
    return avg.to(flow.dtype)


def sums_stage_reference(flow, fillhole):
    """Plain version of ``launch_sums``, same outputs."""
    S, avg, cnt = sums_and_average(flow)
    if fillhole:
        return S, avg, pack_masks(cnt > 0.0)
    return S, avg.to(flow.dtype), None


def fill_stage_reference(avg, masks, dtype, down=False):
    """Plain version of ``launch_fill``: the fill of the float32 average
    ``avg`` whose has-value pixels are set in ``masks.rows``, in ``dtype``."""
    has = unpack_bits(masks.rows, avg.shape[3])
    return fill_reference(avg, has.float(), fix_down_scan_bug=down).to(dtype)


def payload_stage_reference(flow, payload, fillhole):
    """Plain version of ``launch_payload``, same outputs."""
    S, avg, den = payload_average(flow, payload)
    extra = avg[:, 2:].to(flow.dtype) if payload.shape[1] > 3 else None
    if fillhole:
        return S, avg[:, :2].contiguous(), extra, pack_masks(den > 0.0)
    return S, avg[:, :2].to(flow.dtype), extra, None


# -- the card ------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _layout(B, H, W, P=3):
    """Word offsets of K2's int32 scratch with the fill: S (P float32
    planes), then the row and column summaries (zeroed with S by one memset,
    as memc_project_sums and memc_project_payload require), then the row and
    column masks.  Returns ({name: (offset, shape)}, total words)."""
    shapes = mask_shapes(B, H, W)._asdict()
    layout, off = {"sums": (0, (B, P, H, W))}, P * B * H * W
    for k in ("row_sums", "col_sums", "rows", "cols"):
        layout[k] = (off, shapes[k])
        off += math.prod(shapes[k])
    return layout, off


def _buffers(flow, fillhole, P):
    """K2's scratch (S of P planes, and with the fill the masks behind it),
    its result and the mask pointers (None without the fill)."""
    B, _, H, W = flow.shape
    if fillhole:
        layout, words = _layout(B, H, W, P)
        scratch = torch.empty(words, dtype=torch.int32, device=flow.device)
        ptrs = [scratch.data_ptr() + 4 * layout[k][0] for k in Masks._fields]
        return scratch, torch.empty((B, 2, H, W), dtype=torch.float32, device=flow.device), ptrs
    scratch = torch.empty((B, P, H, W), dtype=torch.float32, device=flow.device)
    return scratch, torch.empty_like(flow), [None] * 4


def _sums(flow, fillhole):
    """K2.  Returns (scratch, result, mask pointers): the result is the
    float32 average with the fill and the projected flow in its type
    without; the pointers (``Masks`` order, None without the fill) point into
    the scratch, which must live until the fill is enqueued.  The hot path
    hands raw pointers on: building tensor views of the scratch costs more
    host time than the kernels take."""
    what = "project_sums"
    code = _lib.dtype_code(flow.dtype)
    B, two, H, W = flow.shape
    if two != 2:
        raise ValueError(f"{what}: flow must be (B, 2, H, W), got {tuple(flow.shape)}")
    _lib.check_cuda_args(what, flow)
    scratch, out, ptrs = _buffers(flow, fillhole, 3)
    err = _lib.lib().memc_project_sums(flow.data_ptr(), scratch.data_ptr(), out.data_ptr(), *ptrs,
                                       B, H, W, code, int(fillhole), _lib.stream_ptr(flow))
    _lib.check(err, what)
    scatter_counter.count += 1
    return scratch, out, ptrs


def _payload_sums(flow, payload, fillhole):
    """K2's payload entry.  Returns (scratch, result, extra, mask pointers)
    as ``_sums``, with ``extra`` the planes 2 .. P-2 of the result (None for
    P = 3)."""
    what = "project_payload"
    code = _lib.dtype_code(flow.dtype)
    B, two, H, W = flow.shape
    P = payload.shape[1]
    if two != 2 or P not in (3, 4) or tuple(payload.shape) != (B, P, H, W) \
            or payload.dtype != torch.float32:
        raise ValueError(f"{what}: takes a flow (B, 2, H, W) and a float32 payload (B, 3 or 4, "
                         f"H, W), got {tuple(flow.shape)} and {payload.dtype} "
                         f"{tuple(payload.shape)}")
    _lib.check_cuda_args(what, flow, payload)
    scratch, out, ptrs = _buffers(flow, fillhole, P)
    extra = torch.empty((B, P - 3, H, W), dtype=flow.dtype, device=flow.device) if P > 3 \
        else None
    err = _lib.lib().memc_project_payload(
        flow.data_ptr(), payload.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        None if extra is None else extra.data_ptr(), *ptrs, B, P, H, W, code, int(fillhole),
        _lib.stream_ptr(flow))
    _lib.check(err, what)
    scatter_counter.count += 1
    return scratch, out, extra, ptrs


def _fill(avg, mask_ptrs, dtype, down=False):
    """K3 on masks given as device pointers in ``Masks`` order; ``down``
    adds the search below (fix_down_scan_bug)."""
    what = "project_fill"
    code = _lib.dtype_code(dtype)
    B, _, H, W = avg.shape
    out = torch.empty((B, 2, H, W), dtype=dtype, device=avg.device)
    err = _lib.lib().memc_project_fill(avg.data_ptr(), *mask_ptrs, out.data_ptr(), B, H, W,
                                       code, int(down), _lib.stream_ptr(avg))
    _lib.check(err, what)
    fill_counter.count += 1
    return out


def _views(scratch, B, H, W, P):
    """(S, ``Masks``) views of the scratch of a call with the fill."""
    layout, _ = _layout(B, H, W, P)
    views = {k: scratch[o:o + math.prod(shape)].view(shape) for k, (o, shape) in layout.items()}
    return views.pop("sums").view(torch.float32), Masks(**views)


def launch_sums(flow, fillhole):
    """K2 alone, for checks: the memset, the scatter and the fold-and-divide.
    flow: (B, 2, H, W) float32 or bf16, contiguous.  Returns (S, result,
    masks): S the base sums (scratch); the result in the flow's type without
    the fill and the float32 average with it; ``Masks`` with the fill, else
    None."""
    scratch, out, _ = _sums(flow, fillhole)
    if not fillhole:
        return scratch, out, None
    B, _, H, W = flow.shape
    S, masks = _views(scratch, B, H, W, 3)
    return S, out, masks


def launch_payload(flow, payload, fillhole):
    """K2's payload entry alone, for checks: the memset, the payload scatter
    and the fold-and-divide.  Returns (S, result, extra, masks) as
    ``payload_stage_reference`` does."""
    scratch, out, extra, _ = _payload_sums(flow, payload, fillhole)
    if not fillhole:
        return scratch, out, extra, None
    B, P, H, W = payload.shape
    S, masks = _views(scratch, B, H, W, P)
    return S, out, extra, masks


def launch_fill(avg, masks, dtype, down=False):
    """K3 alone, for checks.  avg: (B, 2, H, W) float32, contiguous; masks:
    ``Masks`` as K2 writes them; returns (B, 2, H, W) in ``dtype``; ``down``
    adds the search below."""
    what = "project_fill"
    B, K, H, W = avg.shape
    if K != 2 or avg.dtype != torch.float32:
        raise ValueError(f"{what}: takes a float32 average (B, 2, H, W), "
                         f"got {avg.dtype} {tuple(avg.shape)}")
    for got, want in zip(masks, mask_shapes(B, H, W)):
        if tuple(got.shape) != want or got.dtype != torch.int32:
            raise ValueError(f"{what}: mask {got.dtype} {tuple(got.shape)}, want int32 {want}")
    _lib.check_cuda_args(what, avg, *masks)
    return _fill(avg, [m.data_ptr() for m in masks], dtype, down)


class _ProjectFunction(torch.autograd.Function):
    """K2 then, with the fill, K3; backward is autograd of the plain
    composition."""

    @staticmethod
    def forward(ctx, flow, fillhole, down):
        ctx.save_for_backward(flow)
        ctx.fillhole, ctx.down = fillhole, down
        # the fill reads the masks in K2's scratch: keep it until then
        scratch, out, mask_ptrs = _sums(flow, fillhole)
        if fillhole:
            out = _fill(out, mask_ptrs, flow.dtype, down)
        return out

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        (gf,) = _lib.reference_grads(lambda f: reference(f, ctx.fillhole, ctx.down), [flow],
                                     [True], [g])
        return gf, None, None


def flow_project(flow, fillhole=False, fix_down_scan_bug=False):
    """The projection: the kernels on CUDA tensors, the plain composition on
    CPU tensors.  The fill scans left, right and up, as the reference does;
    ``fix_down_scan_bug`` (the JAX opt-in) adds the scan down."""
    if not _lib.on_cuda(flow):
        return reference(flow, fillhole, fix_down_scan_bug)
    return _ProjectFunction.apply(flow.contiguous(), fillhole, fix_down_scan_bug)


def payload_project(flow, payload, fillhole=False):
    """K2's payload entry and, with the fill, K3 (no down search), on CUDA
    tensors: (planes 0 and 1 of the result in the flow's type, planes
    2 .. P-2 in the flow's type or None).  No gradient: the ops of
    ``ops/projection.py`` wrap it in their own ``autograd.Function``s."""
    # the fill reads the masks in K2's scratch: keep it until then
    scratch, out, extra, mask_ptrs = _payload_sums(flow.contiguous(), payload.contiguous(),
                                                   fillhole)
    if fillhole:
        out = _fill(out, mask_ptrs, flow.dtype)
    return out, extra


# -- the tile entries ----------------------------------------------------------


def tile_sums_reference(flow, origins, halo, halo_h, W, H):
    """Plain version of K2's tile entry (the scatter of
    memcnet_tpu/parallel/tiling.py::tiled_flow_project's body): flow (n, 2,
    Hl, Wl) tiles at ``origins`` (n, 2) int32 (x, y) in the H x W frame,
    clamped to +-(halo - 1) (and +-(halo_h - 1) with halo_h > 0), gated in
    frame coordinates; (-fx, -fy, 1) scattered at the frame's landing cell
    moved into the extended (Hl + 2 halo_h, Wl + 2 halo) buffer, then both
    +1 folds at that buffer's edges.  Returns (n, 3, He, We) float32."""
    n, _, Hl, Wl = flow.shape
    He, We = Hl + 2 * halo_h, Wl + 2 * halo
    f = flow.float()
    fx = f[:, 0].clamp(-(halo - 1), halo - 1)
    fy = f[:, 1]
    if halo_h:
        fy = fy.clamp(-(halo_h - 1), halo_h - 1)
    xo = origins[:, 0].long().view(n, 1, 1)
    yo = origins[:, 1].long().view(n, 1, 1)
    x2 = (xo + torch.arange(Wl, device=f.device).view(1, 1, Wl)).float() + fx
    y2 = (yo + torch.arange(Hl, device=f.device).view(1, Hl, 1)).float() + fy
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    ix = (x2.to(torch.int32).clamp(0, W - 1).long() - xo + halo).clamp(0, We - 1)
    iy = (y2.to(torch.int32).clamp(0, H - 1).long() - yo + halo_h).clamp(0, He - 1)
    payload = torch.stack([-fx, -fy, torch.ones_like(fx)], dim=1)
    lin = torch.where(valid, iy * We + ix, torch.full_like(ix, -1))
    return fold(scatter_reference(payload, lin, (He, We)))


def launch_tile_sums(flow, origins, halo, halo_h, W, H):
    """K2's tile entry on CUDA tensors: the memset, the scatter and the
    folds.  Returns (n, 3, He, We) float32."""
    what = "project_tile_sums"
    code = _lib.dtype_code(flow.dtype)
    n, two, Hl, Wl = flow.shape
    org = origins.to(torch.int32).contiguous()
    if two != 2 or tuple(org.shape) != (n, 2):
        raise ValueError(f"{what}: takes flow (n, 2, H, W) and origins (n, 2), got "
                         f"{tuple(flow.shape)} and {tuple(origins.shape)}")
    flow = flow.contiguous()
    _lib.check_cuda_args(what, flow, org)
    shape = (n, 3, Hl + 2 * halo_h, Wl + 2 * halo)
    sums = torch.empty(shape, dtype=torch.float32, device=flow.device)
    out = torch.empty_like(sums)
    err = _lib.lib().memc_project_tile_sums(
        flow.data_ptr(), org.data_ptr(), sums.data_ptr(), out.data_ptr(), n, Hl, Wl, halo, halo_h,
        H, W, code, _lib.stream_ptr(flow))
    _lib.check(err, what)
    tile_scatter_counter.count += 1
    return out


class _TileSumsFunction(torch.autograd.Function):
    """K2's tile entry; backward is autograd of ``tile_sums_reference``."""

    @staticmethod
    def forward(ctx, flow, origins, geom):
        ctx.geom = geom
        ctx.save_for_backward(flow, origins)
        return launch_tile_sums(flow, origins, *geom)

    @staticmethod
    def backward(ctx, g):
        flow, origins = ctx.saved_tensors
        (gf,) = _lib.reference_grads(lambda f: tile_sums_reference(f, origins, *ctx.geom),
                                     [flow], [True], [g])
        return gf, None, None


def tile_sums(flow, origins, halo, halo_h, W, H):
    """K2's tile entry on CUDA tensors, its plain version on CPU tensors."""
    if _lib.on_cuda(flow, origins):
        return _TileSumsFunction.apply(flow, origins, (halo, halo_h, W, H))
    return tile_sums_reference(flow, origins, halo, halo_h, W, H)


def carry_fill_reference(avg, cnt, left, right, up, dtype):
    """Plain version of K3's carry entry (memcnet_tpu/parallel/tiling.py::
    _tiled_fill on one tile): each count-0 pixel of avg (n, 2, Hl, Wl)
    float32 takes the mean of the nearest projected value to its left, to
    its right and above, each from the tile itself or, where the tile has
    none, from its carry: left and right (n, 3, Hl) per row, up (n, 3, Wl)
    per column or None (plane 0 > 0: there is a value; planes 1-2: it).  The
    result in ``dtype``."""
    has = cnt > 0.0
    a32 = avg.float()
    num = torch.zeros_like(a32)
    den = torch.zeros_like(a32[:, 0])
    for axis, rev, carry in ((3, False, left), (3, True, right), (2, False, up)):
        idx = _last_valid_index(has, axis - 1, rev)
        found = idx >= 0
        got = torch.gather(a32, axis, idx.clamp(min=0)[:, None].expand_as(a32))
        if carry is not None:
            c = carry.unsqueeze(axis)  # (n, 3, L, 1) per row, (n, 3, 1, L) per column
            got = torch.where(found[:, None], got, c[:, 1:])
            found = found | (c[:, 0] > 0.0)
        num = num + torch.where(found[:, None], got, 0.0)
        den = den + found.float()
    hole = (~has) & (den > 0.0)
    filled = num / torch.where(den > 0.0, den, 1.0)[:, None]
    return torch.where(hole[:, None], filled, a32).to(dtype)


def launch_carry_fill(avg, cnt, left, right, up, dtype):
    """K3's carry entry on CUDA tensors: the memset, the masks and the fill
    with carries.  Returns (n, 2, Hl, Wl) in ``dtype``."""
    what = "project_fill_carry"
    code = _lib.dtype_code(dtype)
    n, K, Hl, Wl = avg.shape
    ins = [t.float().contiguous() for t in (avg, cnt, left, right)]
    ups = [] if up is None else [up.float().contiguous()]
    want = [(n, 2, Hl, Wl), (n, Hl, Wl), (n, 3, Hl), (n, 3, Hl)] + [(n, 3, Wl)] * len(ups)
    got = [tuple(t.shape) for t in ins + ups]
    if got != want:
        raise ValueError(f"{what}: shapes {got}, want {want}")
    _lib.check_cuda_args(what, *ins, *ups)
    shapes = mask_shapes(n, Hl, Wl)
    masks = torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.int32, device=avg.device)
    out = torch.empty((n, 2, Hl, Wl), dtype=dtype, device=avg.device)
    err = _lib.lib().memc_project_fill_carry(
        ins[0].data_ptr(), ins[1].data_ptr(), masks.data_ptr(), ins[2].data_ptr(),
        ins[3].data_ptr(), ups[0].data_ptr() if ups else None, out.data_ptr(), n, Hl, Wl, code,
        _lib.stream_ptr(avg))
    _lib.check(err, what)
    carry_counter.count += 1
    return out


class _CarryFillFunction(torch.autograd.Function):
    """K3's carry entry; backward is autograd of ``carry_fill_reference``."""

    @staticmethod
    def forward(ctx, avg, cnt, left, right, up, dtype):
        ctx.dtype, ctx.has_up = dtype, up is not None
        ctx.save_for_backward(avg, cnt, left, right, *([up] if up is not None else []))
        return launch_carry_fill(avg, cnt, left, right, up, dtype)

    @staticmethod
    def backward(ctx, g):
        avg, cnt, left, right, *up = ctx.saved_tensors
        needs = [ctx.needs_input_grad[0], False, ctx.needs_input_grad[2],
                 ctx.needs_input_grad[3]] + ([ctx.needs_input_grad[4]] if up else [])
        grads = _lib.reference_grads(
            lambda a, c, lf, rt, *u: carry_fill_reference(a, c, lf, rt, u[0] if u else None,
                                                          ctx.dtype),
            [avg, cnt, left, right, *up], needs, [g])
        return grads[0], None, grads[2], grads[3], grads[4] if up else None, None


def carry_fill(avg, cnt, left, right, up, dtype):
    """K3's carry entry on CUDA tensors, its plain version on CPU tensors."""
    ts = [avg, cnt, left, right] + ([up] if up is not None else [])
    if _lib.on_cuda(*ts):
        return _CarryFillFunction.apply(avg, cnt, left, right, up, dtype)
    return carry_fill_reference(avg, cnt, left, right, up, dtype)


def payload_tile_sums_reference(flow, payload, origins, samples, H, W):
    """Plain version of K2's payload entry on tile origins: flow (n, 2, h, w)
    and float32 payload (n, P, h, w) tiles; origins (n, 4) int32, each
    tile's global (y0, x0) and owned (h, w) in the H x W frame.  Each owned
    pixel whose landing (y0 + y, x0 + x) + f, in float32, is in the frame
    adds its P planes at the frame's base cell of the whole-frame buffer of
    its sample (tile j is of sample j % ``samples``); then both +1 folds at
    the frame's border.  Returns (samples, P, H, W) float32."""
    n, P, h, w = payload.shape
    f = flow.float()
    o = origins.long()
    y0, x0, own_h, own_w = (o[:, k].view(n, 1, 1) for k in range(4))
    ly = torch.arange(h, device=f.device).view(1, h, 1)
    lx = torch.arange(w, device=f.device).view(1, 1, w)
    x2 = (x0 + lx).float() + f[:, 0]
    y2 = (y0 + ly).float() + f[:, 1]
    valid = ((x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
             & (ly < own_h) & (lx < own_w))
    ix = x2.to(torch.int32).clamp(0, W - 1)
    iy = y2.to(torch.int32).clamp(0, H - 1)
    lin = torch.where(valid, iy * W + ix, torch.full_like(ix, -1))
    T = n // samples

    def by_sample(t):  # (n, ..., h, w) -> (samples, ..., T h, w): a sample's tiles stacked
        t = t.reshape(T, samples, *t.shape[1:]).movedim(0, -3)
        return t.reshape(*t.shape[:-3], T * h, w)

    return fold(scatter_reference(by_sample(payload.float()), by_sample(lin), (H, W)))


def launch_payload_tile(flow, payload, origins, samples, H, W):
    """K2's payload entry on tile origins on CUDA tensors: the memset, the
    scatter and the folds.  Returns (samples, P, H, W) float32."""
    what = "project_payload_tile"
    code = _lib.dtype_code(flow.dtype)
    n, two, h, w = flow.shape
    P = payload.shape[1]
    org = origins.to(torch.int32).contiguous()
    if two != 2 or P not in (3, 4) or tuple(payload.shape) != (n, P, h, w) \
            or payload.dtype != torch.float32 or tuple(org.shape) != (n, 4) \
            or samples < 1 or n % samples:
        raise ValueError(f"{what}: takes flow (n, 2, h, w), a float32 payload (n, 3 or 4, h, w), "
                         f"origins (n, 4) and n a multiple of the samples, got "
                         f"{tuple(flow.shape)}, {payload.dtype} {tuple(payload.shape)}, "
                         f"{tuple(origins.shape)} and {samples}")
    flow, payload = flow.contiguous(), payload.contiguous()
    _lib.check_cuda_args(what, flow, payload, org)
    sums = torch.empty((samples, P, H, W), dtype=torch.float32, device=flow.device)
    out = torch.empty_like(sums)
    err = _lib.lib().memc_project_payload_tile(
        flow.data_ptr(), payload.data_ptr(), org.data_ptr(), sums.data_ptr(), out.data_ptr(), n,
        P, h, w, samples, H, W, code, _lib.stream_ptr(flow))
    _lib.check(err, what)
    payload_tile_counter.count += 1
    return out


class _PayloadTileFunction(torch.autograd.Function):
    """K2's payload entry on tile origins; backward is autograd of
    ``payload_tile_sums_reference``."""

    @staticmethod
    def forward(ctx, flow, payload, origins, geom):
        ctx.geom = geom
        ctx.save_for_backward(flow, payload, origins)
        return launch_payload_tile(flow, payload, origins, *geom)

    @staticmethod
    def backward(ctx, g):
        flow, payload, origins = ctx.saved_tensors
        grads = _lib.reference_grads(
            lambda f, p: payload_tile_sums_reference(f, p, origins, *ctx.geom), [flow, payload],
            ctx.needs_input_grad[:2], [g])
        return (*grads, None, None)


def payload_tile_sums(flow, payload, origins, samples, H, W):
    """K2's payload entry on tile origins on CUDA tensors, its plain version
    on CPU tensors."""
    if _lib.on_cuda(flow, payload, origins):
        return _PayloadTileFunction.apply(flow, payload, origins, (samples, H, W))
    return payload_tile_sums_reference(flow, payload, origins, samples, H, W)
