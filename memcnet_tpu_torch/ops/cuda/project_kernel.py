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
weighted (N7) and brightness-gated (N8) projections (``ops/projection.py``):
the same three operations on a payload of P = 3 or 4 planes that the
scatter builds itself from the op's inputs, also counted as one launch of
``base_scatter``.

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
planes of each source pixel's payload (``op_payload``: N7's (-f d, d) from
the depth, N8's (-f, err, 1) where its gate holds, from frame1 at the pixel
and frame2 at p + 2 f) are scattered there, folded, and planes 0 .. P-2
divided by plane P-1 where it is > 0; with the fill, "has a value" is plane
P-1 > 0 (a sum of depths or a count of gated pixels).

What bounds it on the H100: memory (read the flow, write the result).  Its
design: float ``atomicAdd`` into S, which stays in L2; one gather pass per
target pixel for both folds and the divide, which with the fill also packs
"count > 0" into bit masks by rows and by columns, each with one summary bit
per non-empty word (``Masks``); the fill takes four pixels a thread (vector
loads of the average, vector stores, a row's mask word read once per 32
pixels) and finds each nearest value with bit scans of its word and, past
it, of the summary word, so a search reads O(1 + L / 1024) words of a line
of L pixels however long the run of holes.
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
with no divide: the spill exchange comes first.  K3's (``tile_fill``;
``memc_project_fill_tiles``: ``project_mask_kernel`` and
``project_fill_tiles_kernel``, two device operations, counted by
``carry_counter``) is the whole tiled fill of the cropped tiles: wherever a
tile's own search finds nothing, the thread walks the tiles stacked in the
same batch (``stacked_neighbour``), nearest first and not past the frame's
edge, and takes the last (first) projected pixel of its row (column) there;
an axis across ranks gives its carries instead (``parallel/tiling.py``).

K2's payload entry on tile origins (``payload_tile``;
``memc_project_payload_tile``: a memset, ``project_op_scatter_kernel`` on
tile origins and ``project_raw_fold_kernel`` of P planes, counted by
``payload_tile_counter``) serves the depth-weighted and gated projections on
partitioned frames (``ops/projection.py``), which the JAX package runs on
``frame_sharding``-placed arrays: each owned pixel of a tile builds its
payload (the gate reads frame2's whole level) and scatters its P planes at
the frame's landing cell -- tile origin + local position, in float32 --
into its sample's whole-frame buffer, with no flow clamp and no halo; then
both +1 folds at the frame's border.  The divide follows
``parallel/partition.py``'s reduce, which gives each tile its part.
"""

import functools
import math
from collections import namedtuple

import torch

from memcnet_tpu_torch.ops.cuda import _lib
from memcnet_tpu_torch.ops.frame import coords, take
from memcnet_tpu_torch.utils import tracing

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


def depth_payload(flow, depth):
    """(-f d, d) in float32 (B, 3, H, W): what each source pixel of the
    depth-weighted projection (N7) scatters."""
    f, d = flow.float(), depth.float()
    return torch.cat([-f * d, d], dim=1)


def brightness_error(flow, frame1, whole2, origins=None):
    """err (n, h, w) float32 of the gated projection (N8): mean over the 3
    channels of |frame1(p) - frame2(nn)| + 1e-8, nn the pixel of p + 2f
    clamped to the frame and truncated (my_lib.c:1959-1971), summed as d0/3 +
    d1/3 + d2/3 + 1e-8 in that order; the coordinates in float32 whatever
    the flow's type.  flow, frame1: n rows (``ops.frame.coords``); whole2:
    frame2's whole level (samples, 3, H, W), row j of sample j % samples."""
    f = flow.float()
    n, _, h, w = f.shape
    H, W = whole2.shape[-2:]
    ys, xs = coords(n, h, w, origins, f.device)
    x3 = (xs + 2.0 * f[:, 0]).clamp(0.0, W - 1.0).to(torch.int32)
    y3 = (ys + 2.0 * f[:, 1]).clamp(0.0, H - 1.0).to(torch.int32)
    diff = (frame1.float() - take(whole2.float(), y3, x3, W)).abs()
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not x / 3 in the last bit, and the gate
    # would flip at the threshold
    three = torch.full((), 3.0, device=diff.device)
    return diff[:, 0] / three + diff[:, 1] / three + diff[:, 2] / three + 1e-8


def gated_payload(flow, frame1, whole2, threshold, origins=None):
    """(-fx, -fy, err, 1) in float32 (n, 4, h, w), zero where the gate
    ``valid landing & err <= threshold`` (threshold compared in float32)
    fails: what each source pixel of the gated projection (N8) scatters;
    rows and whole2 as ``brightness_error``'s."""
    f = flow.float()
    n, _, h, w = f.shape
    H, W = whole2.shape[-2:]
    err = brightness_error(f, frame1, whole2, origins)
    ys, xs = coords(n, h, w, origins, f.device)
    x2, y2 = xs + f[:, 0], ys + f[:, 1]
    gate = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0) & (err <= threshold)
    payload = torch.cat([-f, err[:, None], torch.ones_like(err[:, None])], dim=1)
    return torch.where(gate[:, None], payload, 0.0)


# what the payload entries build: N7 from (depth,), N8 from (frame1, frame2)
PAYLOAD_OPS = {"depth": 0, "gated": 1}
PAYLOAD_INPUTS = {"depth": (1,), "gated": (3, 3)}  # channels of each input


def op_payload(op, flow, ins, threshold=0.0, origins=None):
    """The payload (n, P, h, w) float32 that K2's payload entries build for
    ``op``: ``depth_payload`` or ``gated_payload`` of the rows ``flow`` and
    ``ins``."""
    if op == "depth":
        return depth_payload(flow, ins[0])
    return gated_payload(flow, ins[0], ins[1], threshold, origins)


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
    """What K2's payload entry gives from a finished payload, plain: (S,
    result, extra, masks) as ``launch_payload`` returns them."""
    S, avg, den = payload_average(flow, payload)
    extra = avg[:, 2:].to(flow.dtype) if payload.shape[1] > 3 else None
    if fillhole:
        return S, avg[:, :2].contiguous(), extra, pack_masks(den > 0.0)
    return S, avg[:, :2].to(flow.dtype), extra, None


def op_stage_reference(op, flow, ins, threshold, fillhole):
    """Plain version of ``launch_payload``, same outputs."""
    return payload_stage_reference(flow, op_payload(op, flow, ins, threshold), fillhole)


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


def _sums(flow, fillhole, flow_px=None):
    """K2.  Returns (scratch, result, mask pointers): the result is the
    float32 average with the fill and the projected flow in its type
    without; the pointers (``Masks`` order, None without the fill) point into
    the scratch, which must live until the fill is enqueued.  The hot path
    hands raw pointers on: building tensor views of the scratch costs more
    host time than the kernels take.  ``flow_px``, a float64 tensor on the
    device or None, gains the sum of the flow's per-pixel |f|."""
    what = "project_sums"
    code = _lib.dtype_code(flow.dtype)
    B, two, H, W = flow.shape
    if two != 2:
        raise ValueError(f"{what}: flow must be (B, 2, H, W), got {tuple(flow.shape)}")
    _lib.check_cuda_args(what, flow)
    scratch, out, ptrs = _buffers(flow, fillhole, 3)
    err = _lib.lib().memc_project_sums(flow.data_ptr(), scratch.data_ptr(), out.data_ptr(), *ptrs,
                                       B, H, W, code, int(fillhole),
                                       None if flow_px is None else flow_px.data_ptr(),
                                       _lib.stream_ptr(flow))
    _lib.check(err, what)
    scatter_counter.count += 1
    return scratch, out, ptrs


_KERNEL_TYPES = (torch.float32, torch.bfloat16)


def _op_inputs(what, op, flow, ins):
    """The op's inputs checked, in one type the kernel reads: float32 or
    bf16 as they come, else float32 (the plain versions read them in
    float32 too)."""
    chans = PAYLOAD_INPUTS.get(op)
    if chans is None or len(ins) != len(chans) or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"{what}: takes a flow (n, 2, h, w) and the inputs of an op of "
                         f"{sorted(PAYLOAD_INPUTS)}, got {tuple(flow.shape)}, {op!r} and "
                         f"{len(ins)} inputs")
    if ins[0].dtype not in _KERNEL_TYPES or any(t.dtype != ins[0].dtype for t in ins[1:]):
        ins = [t.float() for t in ins]
    out = []
    for t, c in zip(ins, chans):
        if t.dim() != 4 or t.shape[1] != c:
            raise ValueError(f"{what}: {op} takes inputs of {chans} channels, got "
                             f"{[tuple(t.shape) for t in ins]}")
        out.append(t if t.is_contiguous() else t.contiguous())
    return out


def _payload_sums(op, flow, ins, threshold, fillhole):
    """K2's payload entry, its payload built from ``ins`` by ``op``.
    Returns (scratch, result, extra, mask pointers) as ``_sums``, with
    ``extra`` the planes 2 .. P-2 of the result (None for P = 3)."""
    what = "project_payload"
    code = _lib.dtype_code(flow.dtype)
    ins = _op_inputs(what, op, flow, ins)
    B, _, H, W = flow.shape
    if any(t.shape[0] != B or t.shape[2:] != flow.shape[2:] for t in ins):
        raise ValueError(f"{what}: inputs {[tuple(t.shape) for t in ins]} for a flow "
                         f"{tuple(flow.shape)}")
    _lib.check_cuda_args(what, flow, *ins)
    P = 4 if op == "gated" else 3
    scratch, out, ptrs = _buffers(flow, fillhole, P)
    extra = torch.empty((B, P - 3, H, W), dtype=flow.dtype, device=flow.device) if P > 3 \
        else None
    err = _lib.lib().memc_project_payload(
        PAYLOAD_OPS[op], flow.data_ptr(), ins[0].data_ptr(), ins[-1].data_ptr(), threshold,
        scratch.data_ptr(), out.data_ptr(), None if extra is None else extra.data_ptr(), *ptrs,
        B, H, W, code, _lib.dtype_code(ins[0].dtype), int(fillhole), _lib.stream_ptr(flow))
    _lib.check(err, what)
    scatter_counter.count += 1
    return scratch, out, extra, ptrs


def _fill(avg, mask_ptrs, dtype, down=False, holes=None):
    """K3 on masks given as device pointers in ``Masks`` order; ``down``
    adds the search below (fix_down_scan_bug); ``holes``, an int64 tensor on
    the device or None, gains the count of pixels with no projected value."""
    what = "project_fill"
    code = _lib.dtype_code(dtype)
    B, _, H, W = avg.shape
    out = torch.empty((B, 2, H, W), dtype=dtype, device=avg.device)
    err = _lib.lib().memc_project_fill(avg.data_ptr(), *mask_ptrs, out.data_ptr(), B, H, W,
                                       code, int(down),
                                       None if holes is None else holes.data_ptr(),
                                       _lib.stream_ptr(avg))
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


def launch_payload(op, flow, ins, threshold, fillhole):
    """K2's payload entry alone, for checks: the memset, the scatter that
    builds ``op``'s payload from ``ins`` and the fold-and-divide.  Returns
    (S, result, extra, masks) as ``op_stage_reference`` does."""
    scratch, out, extra, _ = _payload_sums(op, flow, ins, threshold, fillhole)
    if not fillhole:
        return scratch, out, extra, None
    B, _, H, W = flow.shape
    S, masks = _views(scratch, B, H, W, 4 if op == "gated" else 3)
    return S, out, extra, masks


def launch_fill(avg, masks, dtype, down=False, holes=None):
    """K3 alone, for checks.  avg: (B, 2, H, W) float32, contiguous; masks:
    ``Masks`` as K2 writes them; returns (B, 2, H, W) in ``dtype``; ``down``
    adds the search below; ``holes``: a 0-dim int64 tensor on the card that
    gains the count of pixels no mask bit sets, or None."""
    what = "project_fill"
    B, K, H, W = avg.shape
    if K != 2 or avg.dtype != torch.float32:
        raise ValueError(f"{what}: takes a float32 average (B, 2, H, W), "
                         f"got {avg.dtype} {tuple(avg.shape)}")
    for got, want in zip(masks, mask_shapes(B, H, W)):
        if tuple(got.shape) != want or got.dtype != torch.int32:
            raise ValueError(f"{what}: mask {got.dtype} {tuple(got.shape)}, want int32 {want}")
    if holes is not None and (holes.dtype != torch.int64 or holes.numel() != 1):
        raise ValueError(f"{what}: holes must be one int64, got {holes.dtype} "
                         f"{tuple(holes.shape)}")
    _lib.check_cuda_args(what, avg, *masks, *(() if holes is None else (holes,)))
    return _fill(avg, [m.data_ptr() for m in masks], dtype, down, holes)


class _ProjectFunction(torch.autograd.Function):
    """K2 then, with the fill, K3, each adding to its counter where that is
    not None (``flow_px``, ``holes``); backward is autograd of the plain
    composition."""

    @staticmethod
    def forward(ctx, flow, fillhole, down, flow_px, holes):
        ctx.save_for_backward(flow)
        ctx.fillhole, ctx.down = fillhole, down
        # the fill reads the masks in K2's scratch: keep it until then
        scratch, out, mask_ptrs = _sums(flow, fillhole, flow_px)
        if fillhole:
            out = _fill(out, mask_ptrs, flow.dtype, down, holes)
        return out

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        (gf,) = _lib.reference_grads(lambda f: reference(f, ctx.fillhole, ctx.down), [flow],
                                     [True], [g])
        return gf, None, None, None, None


def flow_project(flow, fillhole=False, fix_down_scan_bug=False):
    """The projection: the kernels on CUDA tensors, the plain composition on
    CPU tensors.  The fill scans left, right and up, as the reference does;
    ``fix_down_scan_bug`` (the JAX opt-in) adds the scan down.  Inside a
    span of ``utils/tracing.py`` while a profile records, the flow's
    per-pixel |f| join the ``flow_px`` counter and, with the fill, the pixels
    it fills the ``holes`` counter: K2 and K3 add them on the card."""
    pixels = flow.numel() // 2
    flow_px = tracing.counter("flow_px", flow, pixels)
    holes = tracing.counter("holes", flow, pixels, torch.int64) if fillhole else None
    if not _lib.on_cuda(flow):
        avg, cnt = average_and_count(flow, fillhole, fix_down_scan_bug)
        if flow_px is not None:
            flow_px += torch.linalg.vector_norm(flow.detach().float(), dim=1).sum()
        if holes is not None:
            holes += (cnt == 0.0).sum()
        return avg.to(flow.dtype)
    return _ProjectFunction.apply(flow.contiguous(), fillhole, fix_down_scan_bug, flow_px, holes)


def payload_project(op, flow, ins, threshold=0.0, fillhole=False):
    """K2's payload entry, ``op``'s payload built from ``ins`` (N7: the
    depth; N8: frame1 and frame2, the gate err <= threshold) and, with the
    fill, K3 (no down search), on CUDA tensors: (planes 0 and 1 of the result
    in the flow's type, planes 2 .. P-2 in the flow's type or None).  No
    gradient: the ops of ``ops/projection.py`` wrap it in their own
    ``autograd.Function``s."""
    # the fill reads the masks in K2's scratch: keep it until then
    scratch, out, extra, mask_ptrs = _payload_sums(op, flow.contiguous(), ins, threshold,
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


def stacked_neighbour(n, t, inner, k):
    """(n,) int64: the tile k places before each of n tiles stacked into the
    batch along one axis as (outer, t, inner) (k < 0: -k places after), or
    -1 past the frame's edge: b - k inner where tile index b // inner % t,
    less k, is a tile.  The map K3's tile entry walks; ``TileRing.shift(x,
    axis, k)`` gives each tile x at this index where it is not -1, and wraps
    around where it is."""
    b = torch.arange(n)
    i = b // inner % t - k
    return torch.where((i >= 0) & (i < t), b - k * inner, -1)


def fill_tiles_masks(masks, n, H, W):
    """``Masks`` views of K3's tile entry's scratch, laid out rows, then cols;
    it has no summaries (None)."""
    shapes = mask_shapes(n, H, W)
    nr = math.prod(shapes.rows)
    return Masks(masks[:nr].view(shapes.rows), None, masks[nr:].view(shapes.cols), None)


@functools.lru_cache(maxsize=32)
def _fill_tiles_words(n, H, W):
    shapes = mask_shapes(n, H, W)
    return math.prod(shapes.rows) + math.prod(shapes.cols)


def launch_fill_tiles(avg, cnt, stacks, left, right, up, dtype, with_masks=False):
    """K3's tile entry on CUDA tensors: the has-value masks of every tile,
    then the fill, in two device operations.  avg (n, 2, Hl, Wl) and cnt (n, Hl, Wl) float32 with unit x
    strides, views as they come.  ``stacks`` (W axis, H axis): (t, inner) of
    an axis stacked in the batch, along which the searches that find
    nothing in their tile go on, or None; ``left``, ``right`` (n, 3, Hl) and
    ``up`` (n, 3, Wl): the carries of an axis across ranks, None elsewhere.
    Returns (n, 2, Hl, Wl) in ``dtype`` and, ``with_masks``, for checks,
    the ``Masks`` it built."""
    what = "project_fill_tiles"
    code = _lib.dtype_code(dtype)
    n, K, Hl, Wl = avg.shape
    if K != 2 or avg.dtype != torch.float32 or cnt.dtype != torch.float32 \
            or cnt.shape != (n, Hl, Wl) or cnt.device != avg.device:
        raise ValueError(f"{what}: takes a float32 average (n, 2, h, w) and counts (n, h, w) on "
                         f"one device, got {avg.dtype} {tuple(avg.shape)} and {cnt.dtype} "
                         f"{tuple(cnt.shape)}")
    if avg.stride(3) != 1 or max(avg.stride()[1:]) >= 2 ** 31:
        avg = avg.contiguous()
    if cnt.stride(2) != 1 or cnt.stride(1) >= 2 ** 31:
        cnt = cnt.contiguous()
    ptrs = []
    for c, length in ((left, Hl), (right, Hl), (up, Wl)):
        if c is not None:
            c = c.float().contiguous()
            if c.shape != (n, 3, length) or c.device != avg.device:
                raise ValueError(f"{what}: a carry {tuple(c.shape)} on {c.device}, want "
                                 f"{(n, 3, length)} on {avg.device}")
            ptrs.append(c)  # kept alive until the launch
    if (left is None) != (right is None):
        raise ValueError(f"{what}: left and right carries both or neither")
    (tw, iw), (th, ih) = (s or (1, 1) for s in stacks)
    masks = torch.empty(_fill_tiles_words(n, Hl, Wl), dtype=torch.int32, device=avg.device)
    out = torch.empty((n, 2, Hl, Wl), dtype=dtype, device=avg.device)
    it = iter(ptrs)
    carries = [None if c is None else next(it).data_ptr() for c in (left, right, up)]
    err = _lib.lib().memc_project_fill_tiles(
        avg.data_ptr(), avg.stride(0), avg.stride(1), avg.stride(2), cnt.data_ptr(),
        cnt.stride(0), cnt.stride(1), masks.data_ptr(), out.data_ptr(), n, Hl, Wl, tw, iw, th, ih,
        *carries, code, _lib.stream_ptr(avg))
    _lib.check(err, what)
    carry_counter.count += 1
    return (out, fill_tiles_masks(masks, n, Hl, Wl)) if with_masks else out


class _TileFillFunction(torch.autograd.Function):
    """K3's tile entry; backward is autograd of ``plain``, the tiled fill's
    plain composition (``parallel/tiling.py``), so the gradient reaches the
    averages of the tiles a carry came from."""

    @staticmethod
    def forward(ctx, avg, cnt, left, right, up, stacks, dtype, plain):
        ctx.plain = plain
        ctx.given = [c is not None for c in (left, right, up)]
        ctx.save_for_backward(avg, cnt, *[c for c in (left, right, up) if c is not None])
        return launch_fill_tiles(avg, cnt, stacks, left, right, up, dtype)

    @staticmethod
    def backward(ctx, g):
        avg, cnt, *given = ctx.saved_tensors
        needs = [ctx.needs_input_grad[0], False] + [
            ctx.needs_input_grad[2 + k] for k, has in enumerate(ctx.given) if has]

        def plain(a, c, *cs):
            it = iter(cs)
            return ctx.plain(a, c, *[next(it) if has else None for has in ctx.given])

        grads = iter(_lib.reference_grads(plain, [avg, cnt, *given], needs, [g]))
        ga, _ = next(grads), next(grads)
        carries = [next(grads) if has else None for has in ctx.given]
        return (ga, None, *carries, None, None, None)


def tile_fill(avg, cnt, stacks, left, right, up, dtype, plain):
    """K3's tile entry on CUDA tensors (``launch_fill_tiles``), on CPU
    tensors ``plain(avg, cnt, left, right, up)``: the tiled fill's plain
    composition, which makes the carries that are None."""
    ts = [avg, cnt] + [c for c in (left, right, up) if c is not None]
    if _lib.on_cuda(*ts):
        return _TileFillFunction.apply(avg, cnt, left, right, up, stacks, dtype, plain)
    return plain(avg, cnt, left, right, up)


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


def payload_tile_reference(op, flow, ins, threshold, origins, samples, H, W):
    """Plain version of ``launch_payload_tile``: ``payload_tile_sums_reference``
    of ``op_payload``."""
    payload = op_payload(op, flow, ins, threshold, origins)
    return payload_tile_sums_reference(flow, payload, origins, samples, H, W)


def launch_payload_tile(op, flow, ins, threshold, origins, samples, H, W):
    """K2's payload entry on tile origins on CUDA tensors: the memset, the
    scatter that builds ``op``'s payload (N7: ins (depth tiles,); N8: ins
    (frame1 tiles, frame2's whole level (samples, 3, H, W)), the gate err <=
    threshold) and the folds.  Returns (samples, P, H, W) float32."""
    what = "project_payload_tile"
    code = _lib.dtype_code(flow.dtype)
    n, _, h, w = flow.shape
    ins = _op_inputs(what, op, flow, ins)
    org = origins if origins.dtype == torch.int32 and origins.is_contiguous() else \
        origins.to(torch.int32).contiguous()
    whole = op == "gated"  # N8's second input: frame2's whole level
    if ins[0].shape[0] != n or ins[0].shape[2:] != flow.shape[2:] \
            or (whole and (ins[1].shape[0] != samples or ins[1].shape[2:] != (H, W))) \
            or org.shape != (n, 4) or samples < 1 or n % samples:
        raise ValueError(f"{what}: takes flow (n, 2, h, w), the op's inputs on its rows (and "
                         f"N8's frame2 whole, (samples, 3, H, W)), origins (n, 4) and n a "
                         f"multiple of the samples, got {tuple(flow.shape)}, "
                         f"{[tuple(t.shape) for t in ins]}, {tuple(origins.shape)} and {samples}")
    flow = flow if flow.is_contiguous() else flow.contiguous()
    _lib.check_cuda_args(what, flow, org, *ins)
    P = 4 if op == "gated" else 3
    sums = torch.empty((samples, P, H, W), dtype=torch.float32, device=flow.device)
    out = torch.empty_like(sums)
    err = _lib.lib().memc_project_payload_tile(
        PAYLOAD_OPS[op], flow.data_ptr(), ins[0].data_ptr(), ins[-1].data_ptr(), threshold,
        org.data_ptr(), sums.data_ptr(), out.data_ptr(), n, h, w, samples, H, W, code,
        _lib.dtype_code(ins[0].dtype), _lib.stream_ptr(flow))
    _lib.check(err, what)
    payload_tile_counter.count += 1
    return out


class _PayloadTileFunction(torch.autograd.Function):
    """K2's payload entry on tile origins; backward is autograd of
    ``payload_tile_reference`` (for N8 the gradient of frame2's whole level
    flows on through ``Partition.gather``)."""

    @staticmethod
    def forward(ctx, flow, origins, geom, *ins):
        ctx.geom = geom
        ctx.save_for_backward(flow, origins, *ins)
        return launch_payload_tile(geom[0], flow, ins, geom[1], origins, *geom[2:])

    @staticmethod
    def backward(ctx, g):
        flow, origins, *ins = ctx.saved_tensors
        op, threshold, *rest = ctx.geom
        needs = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[3:])
        grads = _lib.reference_grads(
            lambda f, *i: payload_tile_reference(op, f, i, threshold, origins, *rest),
            [flow, *ins], needs, [g])
        return (grads[0], None, None, *grads[1:])


def payload_tile(op, flow, ins, threshold, origins, samples, H, W):
    """K2's payload entry on tile origins on CUDA tensors, its plain version
    on CPU tensors: the whole-frame sums (samples, P, H, W) of ``op``'s
    payload (N7: ins (depth tiles,); N8: ins (frame1 tiles, frame2's whole
    level), threshold the gate's)."""
    if _lib.on_cuda(flow, origins, *ins):
        return _PayloadTileFunction.apply(flow, origins, (op, threshold, samples, H, W), *ins)
    return payload_tile_reference(op, flow, ins, threshold, origins, samples, H, W)
