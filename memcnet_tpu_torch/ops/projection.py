"""Flow projection to the intermediate time step (port of
memcnet_tpu/ops/projection.py: ``flow_project``, ``depth_flow_project`` and
``weighted_flow_project``).

Reference semantics (my_lib_kernel.cu:1630-1836, as the JAX package pins
them): each source pixel p with flow f lands at x2 = p + f; if
0 <= x2 <= W-1 and 0 <= y2 <= H-1 it adds -f and a count of 1 to its four
integer neighbours, the right/bottom ones clamped to the border (a clamped
cell receives the contribution twice).  The sums are divided by the count
where it is > 0.  With ``fillhole`` (eval only), count-0 pixels take the mean
of the nearest projected value to the left, right and above; the down-scan is
dead in the reference and only ``fix_down_scan_bug=True`` enables it.

The four neighbours are the base cell plus constant offsets, so only the
base scatter is a scatter: the other three are border folds of its result.
On CUDA tensors the whole op is one autograd.Function over kernels K2
(scatter, folds, divide) and K3 (fill), at most four device operations
(ops/cuda/project_kernel.py, csrc/project.cu); on CPU tensors it is the plain
composition ``reference``.  Coordinates, sums and the fill are float32
whatever the flow's type; the result is cast back to it once.

The depth-weighted (N7, DepthFlowProjectionLayer, my_lib.c:1637-1877) and
brightness-gated (N8, WeightedFlowProjectionLayer, my_lib.c:1879-2160)
projections scatter other payloads through the same machinery: K2's payload
entry and, with the fill, K3 without the down search, on CUDA tensors; their
plain compositions on CPU tensors.  The kernel builds each source pixel's
payload where it scatters it, from the op's inputs (the flow and the depth;
the flow, frame1 and frame2 for the gate), in the float32 arithmetic of
``project_kernel.depth_payload`` and ``gated_payload``, which the JAX
package runs in XLA in front of its scatter.

Under an active ``parallel.spatial_tiling`` context ``flow_project``
dispatches to the tiled projection (``parallel/tiling.py``), whose tile-local
steps are K2's tile entry and K3's carry entry on CUDA tensors (on frames
sharded under the context, ``parallel.partition``, those steps alone); with
``fix_down_scan_bug`` it raises there, as the JAX package does.  The depth
and gated projections take no halo budget: on whole frames under the context
they run whole, and on sharded frames they run as the JAX ops do on
``frame_sharding``-placed arrays, where GSPMD reduces their scatters over
the whole frame.  Each tile scatters its payload at the frame's landing
cells into a whole-frame buffer per sample (K2's payload entry on tile
origins, ``project_kernel.payload_tile``), ``Partition.reduce`` gives each
tile its part, the tile divides, and the fill is the tiled projection's
(K3's tile entry); the gate's frame2 and the depth projection's hand
backward read their planes whole (``Partition.gather``).
"""

import torch

from memcnet_tpu_torch.ops.cuda import _lib, project_kernel
from memcnet_tpu_torch.ops.cuda.project_kernel import depth_payload
from memcnet_tpu_torch.ops.frame import WholeFrame, frame_of


def project(flow, *, fillhole=False, fix_down_scan_bug=False):
    """Plain float32 (projected flow (B, 2, H, W), count (B, H, W))."""
    return project_kernel.average_and_count(flow, fillhole, fix_down_scan_bug)


def reference(flow, *, fillhole=False, fix_down_scan_bug=False):
    """The plain composition of ``flow_project``, on any device."""
    return project_kernel.reference(flow, fillhole, fix_down_scan_bug)


def flow_project(flow, *, fillhole=False, fix_down_scan_bug=False):
    """Project forward flow F_{t->t+1} (B, 2, H, W) to time t (negated
    average scatter).  Returns (B, 2, H, W) in the flow's type."""
    from memcnet_tpu_torch.parallel.context import active_partition, active_tiling

    t = active_tiling()
    if t is not None:
        if fix_down_scan_bug:
            raise NotImplementedError(
                "fix_down_scan_bug is not supported on the tiled projection path")
        from memcnet_tpu_torch.parallel.tiling import project_tiles, tiled_flow_project

        part = active_partition()
        if part is not None:
            return project_tiles(part.ring(flow.shape[0]), flow, frame=part.frame, halo=t.halo,
                                 fillhole=fillhole, axis=t.axis, axis_h=t.axis_h,
                                 halo_h=t.halo_h)
        return tiled_flow_project(t.mesh, flow, halo=t.halo, fillhole=fillhole, axis=t.axis,
                                  batch_axis=t.batch_axis, axis_h=t.axis_h, halo_h=t.halo_h)
    return project_kernel.flow_project(flow, fillhole, fix_down_scan_bug)


# -- N7: the depth-weighted projection -------------------------------------------


def _landing(flow32, fr):
    """Validity and integer base cell (iyT, ixL) of every source pixel on
    the frame's global coordinates (``project_kernel.landing_cells`` on a
    whole frame)."""
    n, _, h, w = flow32.shape
    H, W = fr.size
    ys, xs = fr.coords(n, h, w, flow32.device)
    x2 = xs + flow32[:, 0]
    y2 = ys + flow32[:, 1]
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    return valid, x2.to(torch.int32).clamp(0, W - 1), y2.to(torch.int32).clamp(0, H - 1)


def _neighbour_cells(flow32, fr):
    """Validity and the four landing neighbours (iy, ix) of each source
    pixel, right and bottom clamped to the frame's border."""
    H, W = fr.size
    valid, ixL, iyT = _landing(flow32, fr)
    ixR, iyB = (ixL + 1).clamp(max=W - 1), (iyT + 1).clamp(max=H - 1)
    return valid, ((iyT, ixL), (iyT, ixR), (iyB, ixL), (iyB, ixR))


def depth_project_backward(flow, depth, avg, cnt, g, fr=None):
    """The reference's hand backward of the depth projection (my_lib.c:
    1751-1877; memcnet_tpu/ops/projection.py::_depth_project_bwd), which is
    not the true gradient: the depth term uses f(p) - avg[n] where autograd
    would give f(p) + avg[n].  A count of 0 divides by 1, as in the JAX
    package.  avg, cnt: the unfilled float32 average and depth sum; g: the
    average's cotangent; on the rows of ``fr`` (whole frames by default),
    whose g / cnt and avg are read whole at the landing cells.  Returns
    (flow grad, depth grad) in their types."""
    fr = fr or WholeFrame(flow)
    f, d = flow.float(), depth.float()
    valid, cells = _neighbour_cells(f, fr)
    gdivc = g.float() / torch.where(cnt > 0.0, cnt, 1.0)[:, None]
    planes = fr.whole(torch.cat([gdivc, avg.float()], dim=1))
    gflow = torch.zeros_like(f)
    gdepth = torch.zeros_like(d[:, 0])
    for iy, ix in cells:
        got = fr.take(planes, iy, ix)
        gc, av = got[:, :2], got[:, 2:]
        gflow = gflow - gc * d
        gdepth = gdepth - torch.sum(gc * (f - av), dim=1)
    m = valid[:, None]
    return (torch.where(m, gflow, 0.0).to(flow.dtype),
            torch.where(m, gdepth[:, None], 0.0).to(depth.dtype))


class _DepthCore(torch.autograd.Function):
    """The plain (average, depth sum) with the reference's hand backward
    (``_depth_project`` of the JAX package)."""

    @staticmethod
    def forward(ctx, flow, depth):
        _, avg, cnt = project_kernel.payload_average(flow, depth_payload(flow, depth))
        ctx.save_for_backward(flow, depth, avg, cnt)
        ctx.mark_non_differentiable(cnt)
        return avg, cnt

    @staticmethod
    def backward(ctx, g, _g_cnt):  # no gradient flows through the depth sum
        return depth_project_backward(*ctx.saved_tensors, g)


def depth_reference(flow, depth, *, fillhole=False):
    """The plain composition of ``depth_flow_project``, on any device."""
    avg, cnt = _DepthCore.apply(flow, depth)
    if fillhole:
        avg = project_kernel.fill_reference(avg, cnt)
    return avg.to(flow.dtype)


class _DepthTilesCore(torch.autograd.Function):
    """The tiles' float32 (average, depth sum): K2's payload entry on tile
    origins (its plain version on CPU tensors), ``Partition.reduce`` and the
    divide; backward the reference's hand rule on the tiles."""

    @staticmethod
    def forward(ctx, flow, depth, fr):
        n = flow.shape[0]
        sums = project_kernel.payload_tile("depth", flow, (depth,), 0.0,
                                           fr.origins(n, flow.device), fr.samples_of(n), *fr.size)
        t = fr.rows(sums)
        cnt = t[:, 2]
        avg = t[:, :2] / torch.where(cnt > 0.0, cnt, 1.0)[:, None]
        ctx.save_for_backward(flow, depth, avg, cnt)
        ctx.fr = fr
        ctx.mark_non_differentiable(cnt)
        return avg, cnt

    @staticmethod
    def backward(ctx, g, _g_cnt):
        return (*depth_project_backward(*ctx.saved_tensors, g, ctx.fr), None)


def _fill_tiles(avg, cnt, dtype, fr):
    """The tiled projection's hole fill (parallel/tiling.py: K3's carry
    entry, each search continued into the other tiles; down dead)."""
    from memcnet_tpu_torch.parallel.context import active_tiling
    from memcnet_tpu_torch.parallel.tiling import _tiled_fill

    t = active_tiling()
    return _tiled_fill(avg, cnt, fr.part.ring(avg.shape[0]), t.axis, t.axis_h, dtype)


class _DepthProjectFunction(torch.autograd.Function):
    """K2's payload entry (3 planes) then, with the fill, K3; backward is
    autograd of ``depth_reference``, whose core has the hand backward."""

    @staticmethod
    def forward(ctx, flow, depth, fillhole):
        ctx.save_for_backward(flow, depth)
        ctx.fillhole = fillhole
        out, _ = project_kernel.payload_project("depth", flow, (depth,), fillhole=fillhole)
        return out

    @staticmethod
    def backward(ctx, g):
        flow, depth = ctx.saved_tensors
        gf, gd = _lib.reference_grads(
            lambda f, d: depth_reference(f, d, fillhole=ctx.fillhole), [flow, depth],
            ctx.needs_input_grad[:2], [g])
        return gf, gd, None


def depth_flow_project(flow, depth, *, fillhole=False):
    """Depth-weighted flow projection (DAIN-style; N7): each source pixel
    scatters d(p) * -f(p) and d(p) into its four landing neighbours, and the
    average is the depth-weighted mean of -f.  The fill (no down-scan, as in
    the reference, my_lib_kernel.cu:2227) takes "has a value" from a depth
    sum > 0.

    Args:
      flow: (B, 2, H, W);  depth: (B, 1, H, W) positive weights.
    Returns:
      projected flow (B, 2, H, W) in the flow's type.
    """
    fr = frame_of(flow)
    if not isinstance(fr, WholeFrame):
        avg, cnt = _DepthTilesCore.apply(flow, depth, fr)
        return (_fill_tiles(avg, cnt, flow.dtype, fr) if fillhole else avg).to(flow.dtype)
    if not _lib.on_cuda(flow, depth):
        return depth_reference(flow, depth, fillhole=fillhole)
    return _DepthProjectFunction.apply(flow.contiguous(), depth.contiguous(), fillhole)


# -- N8: the brightness-gated projection -------------------------------------------


def brightness_error(flow, frame1, frame2, fr=None):
    """err (B, H, W) float32 (``project_kernel.brightness_error``) on the
    rows of ``fr`` (whole frames by default): frame2 whole, frame1 and err
    on the rows."""
    fr = fr or WholeFrame(flow)
    return project_kernel.brightness_error(flow, frame1, fr.whole(frame2),
                                           fr.origins(flow.shape[0], flow.device))


def weighted_payload(flow, frame1, frame2, threshold, fr=None):
    """(-fx, -fy, err, 1) in float32 (B, 4, H, W), zero where the gate
    ``valid landing & err <= threshold`` (threshold compared in float32)
    fails (``project_kernel.gated_payload``); on the rows of ``fr``, whole
    frames by default."""
    fr = fr or WholeFrame(flow)
    return project_kernel.gated_payload(flow, frame1, fr.whole(frame2), threshold,
                                        fr.origins(flow.shape[0], flow.device))


def weighted_reference(flow, frame1, frame2, *, threshold=20.0 / 255.0, fillhole=False):
    """The plain composition of ``weighted_flow_project``, on any device."""
    payload = weighted_payload(flow, frame1, frame2, threshold)
    _, avg, cnt = project_kernel.payload_average(flow, payload)
    out = avg[:, :2]
    if fillhole:
        out = project_kernel.fill_reference(out, cnt)
    return out.to(flow.dtype), avg[:, 2:].to(flow.dtype)


def weighted_tiles(flow, frame1, frame2, threshold, fillhole, fr):
    """The gated projection on the tiles of ``fr``: K2's payload entry on
    tile origins (its plain version on CPU tensors), the gate against
    frame2's whole level inside it, ``Partition.reduce``, the divide and the
    tiled fill; autograd of each step backward."""
    n = flow.shape[0]
    sums = project_kernel.payload_tile("gated", flow, (frame1, fr.whole(frame2)), threshold,
                                       fr.origins(n, flow.device), fr.samples_of(n), *fr.size)
    t = fr.rows(sums)
    den = t[:, 3]
    avg = t[:, :3] / torch.where(den > 0.0, den, 1.0)[:, None]
    out = _fill_tiles(avg[:, :2], den, flow.dtype, fr) if fillhole else avg[:, :2]
    return out.to(flow.dtype), avg[:, 2:].to(flow.dtype)


class _WeightedProjectFunction(torch.autograd.Function):
    """K2's payload entry (4 planes, the gate inside it) then, with the
    fill, K3 on the flow; backward is autograd of ``weighted_reference``
    (the JAX op's autodiff)."""

    @staticmethod
    def forward(ctx, flow, frame1, frame2, threshold, fillhole):
        ctx.save_for_backward(flow, frame1, frame2)
        ctx.threshold, ctx.fillhole = threshold, fillhole
        return project_kernel.payload_project("gated", flow, (frame1, frame2), threshold,
                                              fillhole)

    @staticmethod
    def backward(ctx, g, gw):
        grads = _lib.reference_grads(
            lambda f, a, b: weighted_reference(f, a, b, threshold=ctx.threshold,
                                               fillhole=ctx.fillhole),
            list(ctx.saved_tensors), ctx.needs_input_grad[:3], [g, gw])
        return (*grads, None, None)


def weighted_flow_project(flow, frame1, frame2, *, threshold=20.0 / 255.0, fillhole=False):
    """Brightness-constancy-gated flow projection (N8): pixels whose landing
    is in the frame and whose ``brightness_error`` is <= threshold scatter
    -f with a count of 1, and err into a weight plane; both are divided by
    the count.  The fill (no down-scan) fills the flow only.

    Args:
      flow: (B, 2, H, W); frame1, frame2: (B, 3, H, W).
    Returns:
      (projected flow (B, 2, H, W), weight plane (B, 1, H, W)), both in the
      flow's type.
    """
    fr = frame_of(flow)
    if not isinstance(fr, WholeFrame):
        return weighted_tiles(flow, frame1, frame2, float(threshold), fillhole, fr)
    if not _lib.on_cuda(flow, frame1, frame2):
        return weighted_reference(flow, frame1, frame2, threshold=threshold, fillhole=fillhole)
    return _WeightedProjectFunction.apply(flow.contiguous(), frame1.contiguous(),
                                          frame2.contiguous(), float(threshold), fillhole)
