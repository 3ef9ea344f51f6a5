"""Plain float32 layers of MEMC-Net, written from the published semantics.

Nothing here imports the program under test.  Every function takes float32
tensors and the weights by their state-dict names (the names of the
reference implementation, baowenbo/MEMC-Net, which the program keeps), and
computes in float32 with TF32 off.

``Operands`` rounds the two operands of every convolution before it runs:
"float32" leaves them, "tf32" rounds them to TF32 (10 mantissa bits, to
nearest), "fp8" to float8 e4m3 with one scale per tensor (its largest
magnitude at 448).  Products of rounded operands are exact in float32 and
the sums stay float32, as the tensor cores sum them, so "tf32" and "fp8"
are the arithmetic of a TF32 or an fp8 implementation.  They are the
controls of ``benchmark/check.py``: the precision one step below the
configuration's.
"""

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x):
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Operands:
    """How a convolution's input and weight are rounded: float32, tf32, fp8."""

    ROUND = {"float32": None, "tf32": round_tf32, "fp8": round_fp8}

    def __init__(self, kind="float32"):
        if kind not in self.ROUND:
            raise ValueError(f"unknown operand precision {kind!r}")
        self._round = self.ROUND[kind]

    def __call__(self, t):
        return t if self._round is None else self._round(t)


class Params:
    """The weights by name, and the operand rounding of every conv."""

    def __init__(self, tensors, operands=None):
        self.t = tensors
        self.q = operands or Operands()

    def __getitem__(self, name):
        return self.t[name]

    def conv(self, x, prefix, *, stride=1, padding=1, bias=True):
        w = self.t[prefix + ".weight"]
        b = self.t.get(prefix + ".bias") if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding)

    def deconv(self, x, prefix, *, bias=True):
        w = self.t[prefix + ".weight"]
        b = self.t.get(prefix + ".bias") if bias else None
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride=2, padding=1)


def upsample(x, scale=2):
    """torch-0.2 bilinear upsampling: align_corners=True."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)


def batch_norm(p, x, prefix, eps=1e-5):
    """BatchNorm2d in eval mode, on its running statistics."""
    scale = p[prefix + ".weight"] * torch.rsqrt(p[prefix + ".running_var"] + eps)
    shift = p[prefix + ".bias"] - p[prefix + ".running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


# -- MonoNet5 trunks, their branches and the RectifyNet ------------------------
# Blocks as in MEMC_Net.py:181-250 and MEMC_Net_s.py:192-239: 'c' conv-relu,
# 'cp' conv-relu[-bn]-maxpool, 'cu' conv-relu[-bn]-upsample, 'uc'
# upsample-conv-relu[-bn].  The walk keeps the input of each max-pool and
# adds it back after each upsample.  Module indices follow the flat
# nn.ModuleList of the reference, so the names are its state-dict names.

MONONET_FULL = [
    ("c", 6, 32), ("c", 32, 32), ("cp", 32, 32),
    ("c", 32, 64), ("cp", 64, 64),
    ("c", 64, 128), ("cp", 128, 128),
    ("c", 128, 256), ("cp", 256, 256),
    ("c", 256, 512), ("cp", 512, 512),
    ("c", 512, 512), ("c", 512, 512),
    ("cu", 512, 512), ("c", 512, 256),
    ("cu", 256, 256), ("c", 256, 128),
    ("cu", 128, 128), ("c", 128, 64),
    ("cu", 64, 64), ("c", 64, 32),
    ("cu", 32, 32), ("c", 32, 16),
]
MONONET_THIN = [
    ("c", 6, 16), ("cp", 16, 32),
    ("cp", 32, 64),
    ("cp", 64, 128),
    ("cp", 128, 256),
    ("cp", 256, 512),
    ("c", 512, 512),
    ("uc", 512, 256),
    ("uc", 256, 128),
    ("uc", 128, 64),
    ("uc", 64, 32),
    ("uc", 32, 16),
]


def unet_steps(blocks, with_bn):
    """The flat module list of ``blocks``: (kind, index, channels in, out)."""
    steps, i = [], 0
    for kind, cin, cout in blocks:
        if kind == "uc":
            steps.append(("up", i, cin, cin)); i += 1
        steps.append(("conv", i, cin, cout)); i += 1
        steps.append(("relu", i, cout, cout)); i += 1
        if kind in ("cp", "cu", "uc"):
            if with_bn:
                steps.append(("bn", i, cout, cout)); i += 1
            if kind == "cp":
                steps.append(("pool", i, cout, cout)); i += 1
            elif kind == "cu":
                steps.append(("up", i, cout, cout)); i += 1
    return steps


def unet(p, prefix, blocks, with_bn, x):
    skips, cur = [], x
    for kind, i, _cin, _cout in unet_steps(blocks, with_bn):
        name = f"{prefix}.{i}"
        if kind == "conv":
            cur = p.conv(cur, name)
        elif kind == "relu":
            cur = F.relu(cur)
        elif kind == "bn":
            cur = batch_norm(p, cur, name)
        elif kind == "pool":
            skips.append(cur)
            cur = F.max_pool2d(cur, 2)
        else:
            cur = upsample(cur) + skips.pop()
    return cur


def branch(p, prefix, x):
    """conv(16, 16) - relu - conv(16, out)."""
    return p.conv(F.relu(p.conv(x, f"{prefix}.0")), f"{prefix}.2")


def rectify_net(p, x):
    """get_RectifyNet2 (MEMC_Net.py:240-250): 7 conv-relu to 64, conv to 3."""
    h = x
    for i in range(7):
        h = F.relu(p.conv(h, f"rectifyNet.{2 * i}"))
    return p.conv(h, "rectifyNet.14")


# -- FlowNetS (FlowNetS.py:33-117, batchNorm=False) -----------------------------

FLOWNETS_ENC = [("conv1", 6, 64, 7, 2), ("conv2", 64, 128, 5, 2), ("conv3", 128, 256, 5, 2),
                ("conv3_1", 256, 256, 3, 1), ("conv4", 256, 512, 3, 2),
                ("conv4_1", 512, 512, 3, 1), ("conv5", 512, 512, 3, 2),
                ("conv5_1", 512, 512, 3, 1), ("conv6", 512, 1024, 3, 2),
                ("conv6_1", 1024, 1024, 3, 1)]
# decoder level: (deconv, its in, out; predict_flow at the level, its in; upsampled flow)
FLOWNETS_DEC = [("deconv5", 1024, 512, "predict_flow6", 1024, "upsampled_flow6_to_5"),
                ("deconv4", 1026, 256, "predict_flow5", 1026, "upsampled_flow5_to_4"),
                ("deconv3", 770, 128, "predict_flow4", 770, "upsampled_flow4_to_3"),
                ("deconv2", 386, 64, "predict_flow3", 386, "upsampled_flow3_to_2")]
FLOWNETS_LAST = ("predict_flow2", 194)


def flownets(p, x):
    """(B, 6, H, W) -> the quarter-resolution flow (B, 2, H/4, W/4)."""
    acts, h = {}, x
    for name, _ci, _co, k, s in FLOWNETS_ENC:
        h = F.leaky_relu(p.conv(h, f"flownets.{name}.0", stride=s, padding=(k - 1) // 2), 0.1)
        acts[name] = h
    skip = {"deconv5": "conv5_1", "deconv4": "conv4_1", "deconv3": "conv3_1", "deconv2": "conv2"}
    concat = acts["conv6_1"]
    for dname, _ci, _co, pname, _pi, uname in FLOWNETS_DEC:
        flow = p.conv(concat, f"flownets.{pname}", bias=False)
        up = p.deconv(flow, f"flownets.{uname}", bias=False)
        de = F.leaky_relu(p.deconv(concat, f"flownets.{dname}.0"), 0.1)
        concat = torch.cat((acts[skip[dname]], de, up), 1)
    return p.conv(concat, f"flownets.{FLOWNETS_LAST[0]}", bias=False)


# -- SPyNet (networks/SPyNet/Network.py) ----------------------------------------

SPYNET_BASIC = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]
SPYNET_LEVELS = 6


def spynet_levels(h, w):
    """The pyramid's sizes, coarsest first: halve while a side exceeds 32."""
    sizes = [(h, w)]
    for _ in range(SPYNET_LEVELS - 1):
        if max(sizes[0]) > 32:
            sizes.insert(0, (sizes[0][0] // 2, sizes[0][1] // 2))
    return sizes


def _spynet_preprocess(x):
    # the reference reads its input as BGR and emits normalised RGB
    b = (x[:, 0:1] - 0.406) / 0.225
    g = (x[:, 1:2] - 0.456) / 0.224
    r = (x[:, 2:3] - 0.485) / 0.229
    return torch.cat([r, g, b], 1)


def backward_warp(x, flow):
    """grid_sample of x along a flow in pixels (bilinear, zeros outside,
    align_corners=True), the grid in float32."""
    _, _, h, w = flow.shape
    gx = torch.linspace(-1.0, 1.0, w, device=flow.device).view(1, 1, w)
    gy = torch.linspace(-1.0, 1.0, h, device=flow.device).view(1, h, 1)
    grid = torch.stack([gx + flow[:, 0] / ((w - 1) / 2.0), gy + flow[:, 1] / ((h - 1) / 2.0)],
                       dim=-1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def spynet(p, first, second):
    """(B, 3, H, W) pairs -> the flow (B, 2, H, W) in pixels."""
    firsts, seconds = [_spynet_preprocess(first)], [_spynet_preprocess(second)]
    for _ in range(SPYNET_LEVELS - 1):
        if max(firsts[0].shape[2:]) > 32:
            firsts.insert(0, F.avg_pool2d(firsts[0], 2))
            seconds.insert(0, F.avg_pool2d(seconds[0], 2))
    h0, w0 = firsts[0].shape[2] // 2, firsts[0].shape[3] // 2
    flow = torch.zeros((first.shape[0], 2, h0, w0), device=first.device)
    for lvl, (fst, snd) in enumerate(zip(firsts, seconds)):
        up = upsample(flow) * 2.0
        pad_b, pad_r = fst.shape[2] - up.shape[2], fst.shape[3] - up.shape[3]
        if pad_b or pad_r:
            up = F.pad(up, (0, pad_r, 0, pad_b), mode="replicate")
        h = torch.cat([fst, backward_warp(snd, up), up], 1)
        for j in range(len(SPYNET_BASIC)):
            h = p.conv(h, f"flownets.moduleBasic.{lvl}.moduleBasic.{2 * j}", padding=3)
            if j < len(SPYNET_BASIC) - 1:
                h = F.relu(h)
        flow = h + up
    return flow


# -- the context extractor (ResNet conv1 at stride 1) and EDSR ------------------

CTX_MEAN = (0.485, 0.485, 0.485)  # the reference's quirk (Resnet_conv1.py:263-265)
CTX_STD = (0.229, 0.224, 0.224)


def context(p, x):
    mean = torch.tensor(CTX_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CTX_STD, device=x.device).view(1, 3, 1, 1)
    return p.conv((x - mean) / std, "ctxNet.conv1", padding=3, bias=False)


def edsr(p, x, n_resblocks=10):
    """EDSR.py with no global residual: head, resblocks, body conv, tail."""
    h = p.conv(x, "rectifyNet.head.0")
    res = h
    for i in range(n_resblocks):
        res = res + p.conv(F.relu(p.conv(res, f"rectifyNet.body.{i}.body.0")),
                           f"rectifyNet.body.{i}.body.2")
    res = p.conv(res, f"rectifyNet.body.{n_resblocks}")
    return p.conv(res, "rectifyNet.tail.0")


# -- flow projection (my_lib_kernel.cu:1630-1836) -------------------------------


def _grid(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    return ys, xs


def project(flow, fillhole=True):
    """The flow projected to the middle time: every source pixel p with flow
    f that lands at x = p + f inside [0, W-1] x [0, H-1] adds -f and a count
    of one to its four integer neighbours (the right and bottom ones clamped
    to the border), the sums divided by the count.  With ``fillhole``, a
    pixel with no count takes the mean of the nearest projected values to
    its left, its right and above it (the reference's down scan is dead)."""
    B, _, H, W = flow.shape
    ys, xs = _grid(H, W, flow.device)
    x2, y2 = xs + flow[:, 0], ys + flow[:, 1]
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    ixl = x2.to(torch.int64).clamp(0, W - 1)
    iyt = y2.to(torch.int64).clamp(0, H - 1)
    ixr, iyb = (ixl + 1).clamp(max=W - 1), (iyt + 1).clamp(max=H - 1)
    payload = torch.cat([-flow, torch.ones_like(flow[:, :1])], 1)
    payload = torch.where(valid[:, None], payload, 0.0).permute(0, 2, 3, 1).reshape(-1, 3)
    base = (torch.arange(B, device=flow.device) * (H * W)).view(B, 1, 1)
    sums = torch.zeros(B * H * W, 3, device=flow.device)
    for iy, ix in ((iyt, ixl), (iyt, ixr), (iyb, ixl), (iyb, ixr)):
        sums.index_add_(0, (base + iy * W + ix).reshape(-1), payload)
    sums = sums.view(B, H, W, 3).permute(0, 3, 1, 2)
    cnt = sums[:, 2]
    avg = sums[:, :2] / torch.where(cnt > 0.0, cnt, 1.0)[:, None]
    return fill_holes(avg, cnt > 0.0) if fillhole else avg


def _nearest(has, dim, reverse):
    """Index of the nearest True at or before (after, with ``reverse``) each
    position along ``dim`` of ``has``; -1 where there is none."""
    L = has.shape[dim]
    shape = [1] * has.dim()
    shape[dim] = L
    pos = torch.arange(L, device=has.device).view(shape).expand_as(has)
    if reverse:
        idx = torch.where(has, L - 1 - pos, -1).flip(dim)
        idx = torch.cummax(idx, dim=dim).values.flip(dim)
        return torch.where(idx >= 0, L - 1 - idx, -1)
    return torch.cummax(torch.where(has, pos, -1), dim=dim).values


def fill_holes(avg, has):
    num = torch.zeros_like(avg)
    den = torch.zeros_like(avg[:, 0])
    for dim, reverse in ((2, False), (2, True), (1, False)):  # left, right, up
        idx = _nearest(has, dim, reverse)
        found = idx >= 0
        got = torch.gather(avg, dim + 1, idx.clamp(min=0)[:, None].expand_as(avg))
        num = num + torch.where(found[:, None], got, 0.0)
        den = den + found.float()
    hole = (~has) & (den > 0.0)
    return torch.where(hole[:, None], num / den.clamp(min=1.0)[:, None], avg)


# -- the adaptive filter warp (my_lib_kernel.cu:1087-1218) ----------------------


def filter_warp(images, flow, filt, fs=4):
    """Each output pixel p follows its flow to x = p + f and sums the fs x fs
    patch whose top-left tap is (int(y) + 1 - fs/2, int(x) + 1 - fs/2),
    clamped to the frame, each tap weighted by the pixel's filter and the
    bilinear factor of its quadrant.  A pixel whose x leaves [0, W-1] or
    [0, H-1], or whose |f| reaches half the frame, copies its source."""
    half = fs // 2
    B, _, H, W = images[0].shape
    ys, xs = _grid(H, W, flow.device)
    fx, fy = flow[:, 0], flow[:, 1]
    x2, y2 = xs + fx, ys + fy
    valid = ((x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
             & (fx.abs() < W / 2.0) & (fy.abs() < H / 2.0))
    ix = x2.to(torch.int64).clamp(0, W - 1)
    iy = y2.to(torch.int64).clamp(0, H - 1)
    alpha, beta = x2 - ix.float(), y2 - iy.float()
    outs = []
    for img in images:
        C = img.shape[1]
        flat = img.reshape(B, C, H * W)
        acc = torch.zeros_like(img)
        for j in range(fs):
            wy = beta if j >= half else 1.0 - beta
            row = (iy + 1 - half + j).clamp(0, H - 1) * W
            for i in range(fs):
                wx = alpha if i >= half else 1.0 - alpha
                lin = (row + (ix + 1 - half + i).clamp(0, W - 1)).view(B, 1, H * W)
                tap = torch.gather(flat, 2, lin.expand(B, C, H * W)).view(B, C, H, W)
                acc += (filt[:, j * fs + i] * wy * wx)[:, None] * tap
        outs.append(torch.where(valid[:, None], acc, img))
    return outs
