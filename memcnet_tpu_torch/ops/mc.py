"""Motion-compensation weighting and splatting ops (port of
memcnet_tpu/ops/mc.py): WeightLayer (N9), PixelValueLayer + PixelWeightLayer
(N10) and ReliableWeightLayer (N11).  Exported capability in the reference,
with no model call site; the hyperparameters are the caller's keyword
arguments.  The JAX package runs them on XLA, the port on stock PyTorch, on
any device; landing coordinates are float32 whatever the flow's type.

Semantics (my_lib_kernel.cu, as the JAX package pins them):
  * occlusion_weight (:3026-3126): per pixel p with flow f, the mean L1
    error between frame1's 3x3 patch around p and frame2's bilinear 3x3
    patch around p + f, its four corner taps clamped to the border each on
    its own (:3095-3105), mapped through (1 - err / lambda_e)^2; 1e-4 where
    p + f lands outside the frame.
  * pixel_splat / pixel_value / pixel_weight (:3398-3473, :3689-3755) and
    reliable_weight (:3967-4045): each source pixel splats its planes times
    g_d = (1 - ((beta - m)^2 + (alpha - n)^2) / (2 sigma_d^2))^2 into the 4x4
    window m, n in [-1, 2] around the cell of p + f/2, the taps clamped to
    the border (a border cell may take several contributions of one pixel);
    a centre outside the frame splats nothing.  Scatters are ``index_add``.

On sharded frames (``parallel/partition.py``) each op runs as the JAX op
does on ``frame_sharding``-placed arrays, on the frame's global coordinates
(``ops/frame.py``): ``occlusion_weight`` reads frame2's level whole
(``Partition.gather``) and frame1's window through an edge-replicating 1-px
halo (``Partition.clamped_take``); each splat scatters its tiles' owned
pixels into a whole-frame buffer per sample and ``Partition.reduce`` gives
each tile its part, so a flow may land anywhere in the frame.

Backward: the reference's hand-derived rules, which are not the true
gradients, transcribed (``autograd.Function``s):
  * WeightLayer's d w / d err is -2 sqrt(w) / lambda_e (the sign of
    1 - err / lambda_e is lost), the sign of |p1 - tgt| is where(p1 > tgt,
    1, -1) (-1 at equality, where autograd of abs gives 0), and both fy terms
    carry (1 - alpha);
  * the splats' flow gradient is -2x autograd's (the 1/2 of the half flow
    is omitted and the sign of d g_d / d alpha flipped); the planes'
    gradients are autograd's.
"""

import functools

import torch

from memcnet_tpu_torch.ops.cuda import _lib
from memcnet_tpu_torch.ops.frame import WholeFrame, frame_of


def _flow_landing(flow, scale, fr=None):
    """Landing coordinates p + scale f on the frame's global coordinates,
    (x2, y2) each (n, h, w) float32."""
    n, two, h, w = flow.shape
    if two != 2:
        raise ValueError(f"flow must have 2 channels, got {tuple(flow.shape)}")
    f = flow.float()
    ys, xs = (fr or WholeFrame(flow)).coords(n, h, w, f.device)
    return xs + f[:, 0] * scale, ys + f[:, 1] * scale


def _in_frame(x2, y2, H, W):
    return (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)


def _bilinear_cells(flow, fr):
    """(ixL, ixR, iyT, iyB, alpha (n, 1, h, w), beta) of p + f."""
    H, W = fr.size
    x2, y2 = _flow_landing(flow, 1.0, fr)
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    ixR = (ixL + 1).clamp(max=W - 1)  # my_lib_kernel.cu:3076-3077
    iyB = (iyT + 1).clamp(max=H - 1)
    return ixL, ixR, iyT, iyB, (x2 - ixL.float())[:, None], (y2 - iyT.float())[:, None]


def _patch_taps(f1ext, f2, flow, window, fr):
    """For each (m, n) of the window: frame1's tap p1 (a slice of its
    extended rows ``f1ext``), frame2's four corner taps TL, TR, BL, BR from
    its frames ``f2`` and their cells; with the bilinear (ixL, ixR, iyT,
    iyB, alpha, beta)."""
    h, w = flow.shape[2:]
    H, W = fr.size
    r = window // 2
    cells = _bilinear_cells(flow, fr)
    ixL, ixR, iyT, iyB, _, _ = cells
    taps = []
    for m in range(-r, r + 1):
        for n in range(-r, r + 1):
            p1 = f1ext[:, :, r + m:r + m + h, r + n:r + n + w]
            corners = [((iy + m).clamp(0, H - 1), (ix + n).clamp(0, W - 1)) for iy, ix in
                       ((iyT, ixL), (iyT, ixR), (iyB, ixL), (iyB, ixR))]
            taps.append((p1, [fr.take(f2, *c) for c in corners], (m, n), corners))
    return taps, cells


def _blend(corners, a, b):
    TL, TR, BL, BR = corners
    return (1 - a) * (1 - b) * TL + a * (1 - b) * TR + (1 - a) * b * BL + a * b * BR


def _occlusion_forward(f1ext, f2, flow, fr, lambda_e, window):
    """WeightLayer's forward (n, 1, h, w) from frame1's extended rows and
    frame2's frames: the corner-wise clamped 3x3 patch L1 error over
    channels x window^2, through (1 - err / lambda_e)^2."""
    C = f1ext.shape[1]
    taps, (_, _, _, _, a, b) = _patch_taps(f1ext, f2, flow, window, fr)
    err = torch.zeros(flow.shape[:1] + flow.shape[2:], dtype=f1ext.dtype, device=f1ext.device)
    for p1, corners, _, _ in taps:
        err = err + torch.sum(torch.abs(p1 - _blend(corners, a, b)), dim=1)
    err = err / (C * window * window)
    w = (1.0 - err / lambda_e) ** 2
    return torch.where(_in_frame(*_flow_landing(flow, 1.0, fr), *fr.size), w, 1e-4)[:, None]


def occlusion_weight_reference(frame1, frame2, flow, lambda_e=0.02, window=3):
    """WeightLayer's forward (B, 1, H, W) on whole frames."""
    fr = WholeFrame(flow)
    return _occlusion_forward(fr.window(frame1, window // 2), frame2, flow, fr, lambda_e,
                              window)


def occlusion_weight_backward(f1ext, f2, flow, w, g, lambda_e, window, fr):
    """The reference's hand backward of WeightLayer (my_lib.c
    WeightLayer_cpu_backward; my_lib_kernel.cu:3189-3396), as
    memcnet_tpu/ops/mc.py::_ow_op's bwd has it.  Returns the gradients of
    (frame1's extended rows, frame2's frames, flow)."""
    n, C, h, w_ = flow.shape[0], f1ext.shape[1], flow.shape[2], flow.shape[3]
    H, W = fr.size
    derr = g[:, 0] * (-2.0 * torch.sqrt(torch.clamp(w[:, 0], min=0.0))
                      / (lambda_e * C * window * window))
    derr = torch.where(_in_frame(*_flow_landing(flow, 1.0, fr), H, W), derr, 0.0)
    derr = derr.to(f1ext.dtype)
    taps, (_, _, _, _, a, b) = _patch_taps(f1ext, f2, flow, window, fr)
    r = window // 2
    g1 = torch.zeros_like(f1ext)
    g2 = torch.zeros(f2.numel(), dtype=f2.dtype, device=f2.device)
    gfx = torch.zeros((n, h, w_), dtype=f1ext.dtype, device=f1ext.device)
    gfy = torch.zeros_like(gfx)
    for p1, corners, (m, k), ccells in taps:
        TL, TR, BL, BR = corners
        s = torch.where(p1 > _blend(corners, a, b), 1.0, -1.0) * derr[:, None]
        g1[:, :, r + m:r + m + h, r + k:r + k + w_] += s
        for (iy, ix), wgt in zip(ccells, ((1 - a) * (1 - b), a * (1 - b), (1 - a) * b, a * b)):
            g2.index_add_(0, fr.flat(iy.long() * W + ix, C).reshape(-1), (-s * wgt).reshape(-1))
        gfx = gfx + torch.sum(((1 - b) * (TR - TL) + b * (BR - BL)) * (-s), dim=1)
        # the reference's (1 - alpha) on both terms
        gfy = gfy + torch.sum(((1 - a) * (BL - TL) + (1 - a) * (BR - TR)) * (-s), dim=1)
    return g1, g2.view(f2.shape), torch.stack([gfx, gfy], dim=1).to(flow.dtype)


class _OcclusionWeight(torch.autograd.Function):
    """WeightLayer on frame1's extended rows and frame2's frames; its
    gradients reach frame1 and frame2 through the pad or halo and the
    gather."""

    @staticmethod
    def forward(ctx, f1ext, f2, flow, fr, lambda_e, window):
        w = _occlusion_forward(f1ext, f2, flow, fr, lambda_e, window)
        ctx.save_for_backward(f1ext, f2, flow, w)
        ctx.fr, ctx.lambda_e, ctx.window = fr, lambda_e, window
        return w

    @staticmethod
    def backward(ctx, g):
        f1ext, f2, flow, w = ctx.saved_tensors
        grads = occlusion_weight_backward(f1ext, f2, flow, w, g, ctx.lambda_e, ctx.window,
                                          ctx.fr)
        return (*grads, None, None, None)


def occlusion_weight(frame1, frame2, flow, *, lambda_e=0.02, window=3):
    """Occlusion / reliability weight from the patch photometric error
    (WeightLayer).

    Args:
      frame1: (B, C, H, W) reference frame; frame2: (B, C, H, W) the frame
        the flow points into; flow: (B, 2, H, W) from frame1 to frame2.
      lambda_e: the error scale of (1 - err / lambda_e)^2.
      window: the odd patch size (the reference hardcodes 3).
    Returns:
      (B, 1, H, W); 1e-4 where p + f lands outside the frame.  Its backward
      is the reference's hand rule (module docstring).
    """
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    fr = frame_of(flow)
    return _OcclusionWeight.apply(fr.window(frame1, window // 2), fr.whole(frame2), flow, fr,
                                  float(lambda_e), window)


def halfflow_splat(flow, planes, sigma_d, fr=None):
    """The 4x4 half-flow splat of planes (n, K, h, w) into whole-frame sums
    (samples, K, H, W): on whole frames (n, K, H, W) itself."""
    fr = fr or WholeFrame(flow)
    n, K, h, w = planes.shape
    H, W = fr.size
    x2, y2 = _flow_landing(flow, 0.5, fr)
    valid = _in_frame(x2, y2, H, W)
    owned = fr.owned(planes)
    if owned is not None:  # a stacked tile's padding splats nothing
        valid = valid & owned
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    alpha = x2 - ixL.float()
    beta = y2 - iyT.float()
    out = torch.zeros(fr.samples_of(n) * K * H * W, dtype=planes.dtype, device=planes.device)
    inv2s2 = 1.0 / (2.0 * sigma_d * sigma_d)
    for m in range(-1, 3):
        for k in range(-1, 3):
            g = 1.0 - ((beta - m) ** 2 + (alpha - k) ** 2) * inv2s2
            g = g * g  # cu:3460-3462
            lin = (iyT + m).clamp(0, H - 1) * W + (ixL + k).clamp(0, W - 1)
            contrib = torch.where(valid[:, None], planes * g[:, None], 0.0)
            out = out.index_add(0, fr.flat(lin, K).reshape(-1), contrib.reshape(-1))
    return out.view(-1, K, H, W)


# which argument is the flow, per mode (the JAX _splat_op's flow_idx)
_FLOW_ARG = {"value": 1, "weight": 0, "reliable": 0, "splat": 1}


def _splat_planes(mode, *args):
    """(flow, planes) of a splat mode's arguments."""
    if mode == "value":
        values, flow, fw = args
        return flow, values * fw
    if mode == "weight":
        flow, fw = args
        return flow, fw
    if mode == "reliable":
        (flow,) = args
        return flow, torch.ones((flow.shape[0], 1) + flow.shape[2:], dtype=flow.dtype,
                                device=flow.device)
    values, flow, fw = args  # "splat": the value and weight pair in one scatter
    return flow, torch.cat([values * fw, fw], dim=1)


def splat_sums(mode, sigma_d, fr, *args):
    """A splat mode's whole-frame sums, plain, with autograd's gradients."""
    return halfflow_splat(*_splat_planes(mode, *args), sigma_d, fr)


def splat_reference(mode, sigma_d, *args):
    """A splat mode's forward on whole frames, plain, with autograd's
    gradients."""
    return splat_sums(mode, sigma_d, None, *args)


class _Splat(torch.autograd.Function):
    """A splat mode (an argument, as ``_splat_op``'s in the JAX package)
    whose flow gradient is -2x autograd's: the whole-frame sums, then the
    rows' part of them; the backward gathers the cotangent whole and pulls
    it back through the sums."""

    @staticmethod
    def forward(ctx, mode, sigma_d, fr, *args):
        ctx.mode, ctx.sigma_d, ctx.fr = mode, sigma_d, fr
        ctx.save_for_backward(*args)
        return fr.rows(splat_sums(mode, sigma_d, fr, *args))

    @staticmethod
    def backward(ctx, g):
        grads = _lib.reference_grads(
            functools.partial(splat_sums, ctx.mode, ctx.sigma_d, ctx.fr),
            list(ctx.saved_tensors), ctx.needs_input_grad[3:], [ctx.fr.whole(g)])
        i = _FLOW_ARG[ctx.mode]
        if grads[i] is not None:
            grads[i] = -2.0 * grads[i]
        return (None, None, None, *grads)


def _splat(mode, sigma_d, *args):
    return _Splat.apply(mode, float(sigma_d), frame_of(args[_FLOW_ARG[mode]]), *args)


def pixel_splat(values, flow, flow_weights, *, sigma_d=1.0):
    """PixelValueLayer and PixelWeightLayer in one scatter.

    Args:
      values: (B, C, H, W); flow: (B, 2, H, W) full flow (the splat lands at
      p + f/2); flow_weights: (B, 1, H, W) confidence f_w.
    Returns:
      (splat values (B, C, H, W), splat weights (B, 1, H, W)).
    """
    out = _splat("splat", sigma_d, values, flow, flow_weights)
    return out[:, :-1], out[:, -1:]


def pixel_value(values, flow, flow_weights, *, sigma_d=1.0):
    """PixelValueLayer alone (my_lib_kernel.cu:3398-3473)."""
    return _splat("value", sigma_d, values, flow, flow_weights)


def pixel_weight(flow, flow_weights, *, sigma_d=1.0):
    """PixelWeightLayer alone (my_lib_kernel.cu:3689-3755)."""
    return _splat("weight", sigma_d, flow, flow_weights)


def reliable_weight(flow, *, sigma_d=1.0):
    """Coverage map: g_d alone, splatted (my_lib_kernel.cu:3967-4045);
    (B, 1, H, W)."""
    return _splat("reliable", sigma_d, flow)
