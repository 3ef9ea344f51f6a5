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
from memcnet_tpu_torch.ops.warp import gather_hw


def _flow_landing(flow, scale):
    """Landing coordinates p + scale f, (x2, y2) each (B, H, W) float32."""
    B, two, H, W = flow.shape
    if two != 2:
        raise ValueError(f"flow must have 2 channels, got {tuple(flow.shape)}")
    f = flow.float()
    xs = torch.arange(W, dtype=torch.float32, device=f.device).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=f.device).view(1, H, 1)
    return xs + f[:, 0] * scale, ys + f[:, 1] * scale


def _in_frame(x2, y2, H, W):
    return (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)


def _bilinear_cells(flow, H, W):
    """(ixL, ixR, iyT, iyB, alpha (B, 1, H, W), beta) of p + f."""
    x2, y2 = _flow_landing(flow, 1.0)
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    ixR = (ixL + 1).clamp(max=W - 1)  # my_lib_kernel.cu:3076-3077
    iyB = (iyT + 1).clamp(max=H - 1)
    return ixL, ixR, iyT, iyB, (x2 - ixL.float())[:, None], (y2 - iyT.float())[:, None]


def _patch_taps(frame1, frame2, flow, window):
    """For each (m, n) of the window: frame1's tap p1, frame2's four corner
    taps TL, TR, BL, BR and the frame1 cell (iy, ix) of p1; with the
    bilinear (ixL, ixR, iyT, iyB, alpha, beta)."""
    B, C, H, W = frame1.shape
    r = window // 2
    cells = _bilinear_cells(flow, H, W)
    ixL, ixR, iyT, iyB, _, _ = cells
    dev = frame1.device
    ybase = torch.arange(H, device=dev).view(1, H, 1).expand(B, H, W)
    xbase = torch.arange(W, device=dev).view(1, 1, W).expand(B, H, W)

    def ch(v):
        return v.clamp(0, H - 1)

    def cw(v):
        return v.clamp(0, W - 1)

    taps = []
    for m in range(-r, r + 1):
        for n in range(-r, r + 1):
            iy1, ix1 = ch(ybase + m), cw(xbase + n)
            corners = [(ch(iy + m), cw(ix + n)) for iy, ix in
                       ((iyT, ixL), (iyT, ixR), (iyB, ixL), (iyB, ixR))]
            taps.append((gather_hw(frame1, iy1, ix1), [gather_hw(frame2, *c) for c in corners],
                         (iy1, ix1), corners))
    return taps, cells


def _blend(corners, a, b):
    TL, TR, BL, BR = corners
    return (1 - a) * (1 - b) * TL + a * (1 - b) * TR + (1 - a) * b * BL + a * b * BR


def patch_error(frame1, frame2, flow, window=3):
    """WeightLayer's err (B, H, W): the corner-wise clamped 3x3 patch L1
    error over channels x window^2."""
    C = frame1.shape[1]
    taps, (_, _, _, _, a, b) = _patch_taps(frame1, frame2, flow, window)
    err = torch.zeros(frame1.shape[:1] + frame1.shape[2:], dtype=frame1.dtype,
                      device=frame1.device)
    for p1, corners, _, _ in taps:
        err = err + torch.sum(torch.abs(p1 - _blend(corners, a, b)), dim=1)
    return err / (C * window * window)


def occlusion_weight_reference(frame1, frame2, flow, lambda_e=0.02, window=3):
    """WeightLayer's forward (B, 1, H, W)."""
    H, W = flow.shape[2:]
    err = patch_error(frame1, frame2, flow, window)
    w = (1.0 - err / lambda_e) ** 2
    return torch.where(_in_frame(*_flow_landing(flow, 1.0), H, W), w, 1e-4)[:, None]


def occlusion_weight_backward(frame1, frame2, flow, w, g, lambda_e, window):
    """The reference's hand backward of WeightLayer (my_lib.c
    WeightLayer_cpu_backward; my_lib_kernel.cu:3189-3396), as
    memcnet_tpu/ops/mc.py::_ow_op's bwd has it.  Returns the gradients of
    (frame1, frame2, flow)."""
    B, C, H, W = frame1.shape
    HW = H * W
    derr = g[:, 0] * (-2.0 * torch.sqrt(torch.clamp(w[:, 0], min=0.0))
                      / (lambda_e * C * window * window))
    derr = torch.where(_in_frame(*_flow_landing(flow, 1.0), H, W), derr, 0.0).to(frame1.dtype)
    taps, (_, _, _, _, a, b) = _patch_taps(frame1, frame2, flow, window)
    gf1 = torch.zeros((B, C, HW), dtype=frame1.dtype, device=frame1.device)
    gf2 = torch.zeros_like(gf1)
    gfx = torch.zeros((B, H, W), dtype=frame1.dtype, device=frame1.device)
    gfy = torch.zeros_like(gfx)

    def lin(iy, ix):
        return (iy * W + ix).reshape(B, 1, HW).long().expand(B, C, HW)

    for p1, corners, cell1, ccells in taps:
        TL, TR, BL, BR = corners
        s = torch.where(p1 > _blend(corners, a, b), 1.0, -1.0) * derr[:, None]
        gf1.scatter_add_(2, lin(*cell1), s.reshape(B, C, HW))
        for (iy, ix), wgt in zip(ccells, ((1 - a) * (1 - b), a * (1 - b), (1 - a) * b, a * b)):
            gf2.scatter_add_(2, lin(iy, ix), (-s * wgt).reshape(B, C, HW))
        gfx = gfx + torch.sum(((1 - b) * (TR - TL) + b * (BR - BL)) * (-s), dim=1)
        # the reference's (1 - alpha) on both terms
        gfy = gfy + torch.sum(((1 - a) * (BL - TL) + (1 - a) * (BR - TR)) * (-s), dim=1)
    return (gf1.view(B, C, H, W), gf2.view(B, C, H, W),
            torch.stack([gfx, gfy], dim=1).to(flow.dtype))


class _OcclusionWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frame1, frame2, flow, lambda_e, window):
        w = occlusion_weight_reference(frame1, frame2, flow, lambda_e, window)
        ctx.save_for_backward(frame1, frame2, flow, w)
        ctx.lambda_e, ctx.window = lambda_e, window
        return w

    @staticmethod
    def backward(ctx, g):
        frame1, frame2, flow, w = ctx.saved_tensors
        grads = occlusion_weight_backward(frame1, frame2, flow, w, g, ctx.lambda_e, ctx.window)
        return (*grads, None, None)


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
    from memcnet_tpu_torch.parallel.context import refuse_partition

    refuse_partition("occlusion_weight")
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    return _OcclusionWeight.apply(frame1, frame2, flow, float(lambda_e), window)


def halfflow_splat(flow, planes, sigma_d):
    """The 4x4 half-flow splat of planes (B, K, H, W) -> (B, K, H, W)."""
    B, K, H, W = planes.shape
    x2, y2 = _flow_landing(flow, 0.5)
    valid = _in_frame(x2, y2, H, W)
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    alpha = x2 - ixL.float()
    beta = y2 - iyT.float()
    base = (torch.arange(B * K, device=planes.device) * (H * W)).view(B, K, 1)
    out = torch.zeros(B * K * H * W, dtype=planes.dtype, device=planes.device)
    inv2s2 = 1.0 / (2.0 * sigma_d * sigma_d)
    for m in range(-1, 3):
        for n in range(-1, 3):
            g = 1.0 - ((beta - m) ** 2 + (alpha - n) ** 2) * inv2s2
            g = g * g  # cu:3460-3462
            lin = ((iyT + m).clamp(0, H - 1) * W + (ixL + n).clamp(0, W - 1)).reshape(B, 1, H * W)
            contrib = torch.where(valid[:, None], planes * g[:, None], 0.0)
            out = out.index_add(0, (base + lin).reshape(-1), contrib.reshape(-1))
    return out.view(B, K, H, W)


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


def splat_reference(mode, sigma_d, *args):
    """A splat mode's forward, plain, with autograd's gradients."""
    return halfflow_splat(*_splat_planes(mode, *args), sigma_d)


class _Splat(torch.autograd.Function):
    """A splat mode (an argument, as ``_splat_op``'s in the JAX package)
    whose flow gradient is -2x autograd's."""

    @staticmethod
    def forward(ctx, mode, sigma_d, *args):
        from memcnet_tpu_torch.parallel.context import refuse_partition

        refuse_partition(f"the {mode} splat")
        ctx.mode, ctx.sigma_d = mode, sigma_d
        ctx.save_for_backward(*args)
        return splat_reference(mode, sigma_d, *args)

    @staticmethod
    def backward(ctx, g):
        grads = _lib.reference_grads(
            functools.partial(splat_reference, ctx.mode, ctx.sigma_d), list(ctx.saved_tensors),
            ctx.needs_input_grad[2:], [g])
        i = _FLOW_ARG[ctx.mode]
        if grads[i] is not None:
            grads[i] = -2.0 * grads[i]
        return (None, None, *grads)


def pixel_splat(values, flow, flow_weights, *, sigma_d=1.0):
    """PixelValueLayer and PixelWeightLayer in one scatter.

    Args:
      values: (B, C, H, W); flow: (B, 2, H, W) full flow (the splat lands at
      p + f/2); flow_weights: (B, 1, H, W) confidence f_w.
    Returns:
      (splat values (B, C, H, W), splat weights (B, 1, H, W)).
    """
    out = _Splat.apply("splat", float(sigma_d), values, flow, flow_weights)
    return out[:, :-1], out[:, -1:]


def pixel_value(values, flow, flow_weights, *, sigma_d=1.0):
    """PixelValueLayer alone (my_lib_kernel.cu:3398-3473)."""
    return _Splat.apply("value", float(sigma_d), values, flow, flow_weights)


def pixel_weight(flow, flow_weights, *, sigma_d=1.0):
    """PixelWeightLayer alone (my_lib_kernel.cu:3689-3755)."""
    return _Splat.apply("weight", float(sigma_d), flow, flow_weights)


def reliable_weight(flow, *, sigma_d=1.0):
    """Coverage map: g_d alone, splatted (my_lib_kernel.cu:3967-4045);
    (B, 1, H, W)."""
    return _Splat.apply("reliable", float(sigma_d), flow)
