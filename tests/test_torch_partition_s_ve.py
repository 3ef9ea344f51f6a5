"""MEMC_Net_s and MEMC_Net_VE on partitioned frames on the CPU
(memcnet_tpu_torch.parallel.partition): SPyNet's average pool on tiles, the
whole-level gather and the coarse-flow window of its level input, K5's tile
entry's plain version against the untiled level input, both models
partitioned against their untiled forwards and the JAX forward of the same
weights, ``PaddedVE(sharded=True)``, and the batch layout VE must keep.

The tiles of a mesh are stacked into the batch in one process, as in
tests/test_torch_partition.py, whose grids, helpers and tolerances this file
takes: LAYER_TOL (1e-6) of a layer's output scale, FORWARD_TOL (1e-4) of
each model output's scale against the untiled forward, MODEL_TOL (1e-3,
tests/test_torch_models.py) against the JAX forward.  MEMC_Net_s runs at
64x320 on both grids; VE at 64x256 on (data 1, tile 4) and at 128x128 on
(1, tile_h 2, tile 2), since its FlowNetS reaches 1/64 and a 64-row frame's
single row at 1/64 does not split over two H tiles.  The untiled-equality
forwards scale the flow nets' last convs so the flows reach about FLOW_PX
(3 px), inside the halo budget of 16; the JAX comparisons take the
sub-pixel flows of tests/test_torch_memc_s.py and tests/test_torch_ve.py,
clear of the warp's cell boundaries.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import jax.random as jr

from memcnet_tpu import models as JM

from memcnet_tpu_torch.cli.runner import PaddedVE, build_model
from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.models.memc_net import DIV_FLOW
from memcnet_tpu_torch.models.memc_net_ve import MEMCNetVE
from memcnet_tpu_torch.nn import layers as L
from memcnet_tpu_torch.ops.cuda import gather_kernel
from memcnet_tpu_torch.parallel import gather_frames, make_mesh, shard_frames, spatial_tiling
from memcnet_tpu_torch.parallel import partition as P
from memcnet_tpu_torch.models import get_model

from test_torch_memc_s import model_params
from test_torch_models import MODEL_TOL, numpy_params, to_jax
from test_torch_partition import (CPU4, FLOW_PX, FORWARD_TOL, HALO, LAYER_TOL, Sharded,
                                  assert_close, at_level, frames, outputs, partitioned,
                                  two_threads)  # noqa: F401 (two_threads: autouse fixture)

S_FRAME = (64, 320)
VE_FRAMES = {"tile4": (64, 256), "tile2x2": (128, 128)}
GRIDS = ("tile4", "tile2x2")


# -- SPyNet's layers on tiles -------------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("lvl", [0, 3, 4, 5])
def test_avg_pool2d_partitioned(grid, lvl):
    """At 1/16 and 1/32 of 64x320 over 4 W tiles the pooled tiles are uneven
    (10 columns: 3, 2, 3, 2; 5: 2, 1, 1, 1), so pooled outputs straddle two
    input tiles."""
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        got = p.merge(L.avg_pool2d(p.split(x), 2))
    assert_close(got, F.avg_pool2d(x, 2), LAYER_TOL)


LEVEL_CASES = [("tile4", (50, 320), 1), ("tile4", (50, 320), 3), ("tile2x2", (192, 320), 2),
               ("tile2x2", (192, 320), 4)]


def level_case(size, lvl, amp=20.0, seed=0):
    """fst, snd (2, 3, GH, GW) and a coarse flow whose x2 upsample reaches
    +-amp px."""
    g = torch.Generator().manual_seed(seed + lvl)
    GH, GW = size[0] >> lvl, size[1] >> lvl
    fst, snd = torch.rand((2, 3, GH, GW), generator=g), torch.rand((2, 3, GH, GW), generator=g)
    flow = (torch.rand((2, 2, GH // 2, GW // 2), generator=g) * 2 - 1) * (amp / 2)
    return fst, snd, flow


@pytest.mark.parametrize("grid, size, lvl", LEVEL_CASES)
def test_level_input_tile_plain_equals_untiled(grid, size, lvl):
    """The tile entry's plain version on the tiles, the second frame's whole
    level and the coarse flow's window, against the untiled
    ``level_input_reference``: +-20 px flows sample tiles two and more away
    (at 1/8 of 320 a tile is 10 columns wide), and 50 rows give an odd
    level of 25 rows whose upsampled flow is replicate-padded at the frame's
    bottom edge.  fst passes through exactly and up is within LAYER_TOL; the
    warp is held against the untiled grid sample of the tiles' own up, as
    tests/test_torch_cuda.py holds the untiled kernel's: up here lerps in
    another float32 order than F.interpolate on the CPU, and one ulp of up
    moves a normalised grid point by an ulp, which is up to (W - 1) / 2 ulps
    of a pixel."""
    fst, snd, flow = level_case(size, lvl)
    want = gather_kernel.level_input_reference(fst, snd, flow)
    with Sharded(grid, size) as p:
        ft, flt = p.split(fst), p.split(flow)
        P.gathers.reset()
        whole = p.gather(p.split(snd))
        assert P.gathers.count == 1 and torch.equal(whole, snd)
        window, origins, level = p.level_input_window(flt, ft)
        assert level == tuple(fst.shape[2:]) and origins.dtype == torch.int32
        assert window.shape[-1] <= flt.shape[-1] + 2  # a 0-1 column halo
        got = p.merge(gather_kernel.level_input_tile(ft, whole, window, origins, *level))
    assert float(flow.abs().max()) * 2 > 0.9 * 20.0
    if size[0] >> lvl == 25:
        assert torch.equal(want[:, 6:, -1], want[:, 6:, -2])  # the replicate pad
    assert torch.equal(got[:, :3], fst)
    assert_close(got[:, 6:], want[:, 6:], LAYER_TOL)
    warped = gather_kernel.reference(snd, gather_kernel.warp_grid(got[:, 6:]))
    assert_close(got[:, 3:6], warped, LAYER_TOL)


def test_level_input_tile_zeroes_what_a_tile_does_not_own():
    """At 1/32 of 64x320 the stacked tiles are 3 columns wide and tiles 1 and
    3 own 2: their third column keeps fst and is zero in the warp and up
    channels, where tiles 0 and 2 hold an upsampled flow."""
    fst, snd, flow = level_case(S_FRAME, 5)
    with Sharded("tile4", S_FRAME) as p:
        ft = p.split(fst)
        window, origins, level = p.level_input_window(p.split(flow), ft)
        out = gather_kernel.level_input_tile(ft, p.gather(p.split(snd)), window, origins, *level)
    own = origins[:, 5]
    assert own.tolist() == [3, 3, 2, 2, 3, 3, 2, 2]  # tile index outermost, 2 samples each
    short = own == 2
    assert torch.equal(out[short, :3, :, 2], ft[short, :, :, 2])
    assert not out[short, 3:, :, 2].any() and out[~short, 6:, :, 2].any()


@pytest.mark.parametrize("grid, frame, x_shape",
                         [("tile4", (4, 24), (1, 2, 4, 6)), ("tile2x2", (6, 10), (1, 2, 3, 5))])
def test_whole_level_gather_gradcheck(grid, frame, x_shape):
    """gradcheck in float64 of the whole-level gather on uneven levels
    (6 columns over 4 tiles: 2, 1, 2, 1; 3 rows and 5 columns over 2 and 2:
    2, 1 and 3, 2): its backward scatters each whole position's cotangent
    back to the one tile that owns it, and nothing to the padding."""
    g = torch.Generator().manual_seed(7)
    with Sharded(grid, frame) as p:
        x = torch.randn(x_shape, generator=g, dtype=torch.float64)
        xt = p.split(x).requires_grad_(True)
        assert torch.autograd.gradcheck(p.gather, (xt,))
        (p.gather(xt) * torch.arange(x.numel(), dtype=torch.float64).view(x_shape)).sum().backward()
        mask = p.mask(xt)
        if mask is not None:
            assert not (xt.grad * (1 - mask.double())).any()


# -- the models ---------------------------------------------------------------------------


def memc_s_scaled(H, W):
    """Seeded MEMC_Net_s whose SPyNet top-level (coarsest) last conv is
    scaled so the flows reach about FLOW_PX on the test frames: its residual
    doubles at every finer level."""
    model = build_model("MEMC_Net_s", seed=0, device="cpu")
    x0, x2 = frames(H, W)
    top = model.flownets.moduleBasic[0].moduleBasic[8]
    with torch.no_grad():
        for _ in range(3):  # the flow is not linear in the scale: the warps move
            raw = float(model._flow(x0, x2).abs().max())
            top.weight.mul_(FLOW_PX / raw)
            top.bias.mul_(FLOW_PX / raw)
    return model


def window(rng, H, W, B=1):
    """7 frames (B, 3, H, W) of one scene, moved a pixel or two per frame."""
    base = rng.rand(B, 3, H, W).astype(np.float32)
    return [np.roll(base, (t - 3, 2 * (t - 3)), axis=(2, 3)) * (1.0 - 0.02 * abs(t - 3))
            for t in range(7)]


def run_partitioned(model, grid, frame, x):
    """Every output of the partitioned eval forward, gathered whole, and the
    whole-level gathers it ran."""
    mesh, ctx, _ = partitioned(grid, frame)
    P.gathers.reset()
    with torch.no_grad(), ctx:
        tiles = shard_frames(mesh, *x)
        out = (outputs(model(*tiles)) if len(x) == 2 else model(list(tiles), debug=True))
        return [gather_frames(mesh, o) for o in out], P.gathers.count


@functools.lru_cache(maxsize=None)
def memc_s_untiled():
    """(model, frames, every output of the untiled eval forward)."""
    model = memc_s_scaled(*S_FRAME)
    x = frames(*S_FRAME)
    with torch.no_grad():
        return model, x, outputs(model(*x))


@pytest.mark.parametrize("grid", GRIDS)
def test_memc_s_partitioned_forward_equals_untiled(grid):
    """Every output of MEMC_Net_s's partitioned forward: SPyNet's 5 levels
    at 64x320 (down to 4x20, 5 columns over 4 tiles) with one whole-level
    gather and one tile-entry level input each, the thin MonoNet, the tiled
    projection and warp."""
    model, x, want = memc_s_untiled()
    got, n_gathers = run_partitioned(model, grid, S_FRAME, x)
    assert n_gathers == 5
    assert 0.5 * FLOW_PX < float(want[2].abs().max()) <= HALO - 4
    for g, w in zip(got, want):
        assert_close(g, w, FORWARD_TOL)


@functools.lru_cache(maxsize=None)
def jax_memc_s():
    """MEMC_Net_s on numpy weights (tests/test_torch_memc_s.py: sub-pixel
    SPyNet residuals plus a constant bias), the port's model through the
    bridge, the frames and the JAX forward."""
    jmodel, flat = model_params("MEMC_Net_s", 31)
    model = get_model("MEMC_Net_s")
    load_jax_params(model, flat)
    model.eval()
    x = frames(*S_FRAME)
    want = jax.jit(jmodel.forward)(to_jax(flat), *(jnp.asarray(t.numpy()) for t in x))
    return model, x, [np.asarray(w) for w in outputs(want)]


VE_FLOW = (3.5, 2.5)  # px: VE's flows, about this plus a sub-pixel field
VE_LIFT = 100.0       # deconv2's first channel, lifted to about this


@functools.lru_cache(maxsize=None)
def ve_params():
    """MEMC_Net_VE on numpy weights (tests/test_torch_ve.py's: sub-pixel
    flows), the flows moved to about VE_FLOW: far enough for the tiled warp
    to read its halos, and off the warp's cell boundaries, where the warp is
    discontinuous and float32 noise could flip a cell between the packages.
    FlowNetS's predict_flow2 has no bias, so deconv2's first channel (read by
    predict_flow2 alone) gets the bias VE_LIFT, and predict_flow2 reads it
    through its centre tap only, weighted to VE_FLOW / DIV_FLOW.
    (the JAX model, the flat params, the port's model through the bridge)."""
    jmodel = JM.get_model("MEMC_Net_VE")
    shapes = {k: v.shape for k, v in jax.eval_shape(jmodel.init_params, jr.PRNGKey(0)).items()}
    flat = numpy_params(shapes, 41, flow_scale=0.02)
    rng = np.random.RandomState(42)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    flat["flownets.deconv2.0.bias"][0] = VE_LIFT
    lift = flat["flownets.predict_flow2.weight"][:, 128]  # concat2: conv2's 128, then deconv2
    lift[:] = 0.0
    lift[:, 1, 1] = np.array(VE_FLOW, np.float32) / (DIV_FLOW * VE_LIFT)
    model = MEMCNetVE()
    load_jax_params(model, flat)
    return jmodel, flat, model.eval()


@functools.lru_cache(maxsize=None)
def ve_runs(grid):
    """VE's window at the grid's frame: the port's untiled and partitioned
    outputs (rectified, flow, filter), the gathers, and the JAX forward's."""
    jmodel, flat, model = ve_params()
    x = [torch.from_numpy(f) for f in window(np.random.RandomState(12), *VE_FRAMES[grid])]
    with torch.no_grad():
        want = list(model(x, debug=True))
    got, n_gathers = run_partitioned(model, grid, VE_FRAMES[grid], x)
    fwd = jax.jit(lambda p, f: jmodel.forward(p, list(f), debug=True))
    jax_out = fwd(to_jax(flat), tuple(jnp.asarray(f.numpy()) for f in x))
    return dict(untiled=want, partitioned=got, gathers=n_gathers,
                jax=[torch.from_numpy(np.array(w)) for w in jax_out])


@pytest.mark.parametrize("grid", GRIDS)
def test_ve_partitioned_forward_equals_untiled(grid):
    """The rectified frame, the 6 flows and filters of MEMC_Net_VE's
    partitioned forward (FlowNetS, the BN MonoNet, the 7-frame ctx conv on
    halo-extended tiles, the split warp's tile step, EDSR): no whole-level
    gather."""
    r = ve_runs(grid)
    assert r["gathers"] == 0
    flow = r["untiled"][1]
    assert 0.5 * FLOW_PX < float(flow.abs().max()) <= HALO - 4
    frac = flow - torch.floor(flow)
    assert float(torch.minimum(frac, 1 - frac).min()) > 1e-3  # off the cell boundaries
    for g, w in zip(r["partitioned"], r["untiled"]):
        assert_close(g, w, FORWARD_TOL)


@pytest.mark.parametrize("name", ["MEMC_Net_s", "MEMC_Net_VE"])
@pytest.mark.parametrize("grid", GRIDS)
def test_partitioned_forward_matches_jax(name, grid):
    """The port's partitioned forward against the JAX forward of the same
    weights on the same frames, whole, every output."""
    if name == "MEMC_Net_s":
        model, x, want = jax_memc_s()
        got, _ = run_partitioned(model, grid, S_FRAME, x)
        want = [torch.from_numpy(w.copy()) for w in want]
        flows = want[2]
    else:
        r = ve_runs(grid)
        got, want = r["partitioned"], r["jax"]
        flows = want[1]
    assert float(flows.abs().max()) > 0.01  # the flows are not trivial
    for g, w in zip(got, want):
        assert_close(g, w, MODEL_TOL)


def test_padded_ve_sharded_equals_untiled():
    """PaddedVE(sharded=True) under spatial_tiling on (1, 4): a 50x200
    window pads to 64x256, then shard_frames, the forward on the tiles,
    gather_frames and unpad, against PaddedVE."""
    model = ve_params()[2]
    fr = [f[0] for f in window(np.random.RandomState(5), 50, 200)]
    want = PaddedVE(model, device="cpu")(fr)
    mesh, ctx, _ = partitioned("tile4", VE_FRAMES["tile4"])
    with ctx:
        got = PaddedVE(model, device="cpu", sharded=True)(fr)
    assert got.shape == (3, 50, 200) and np.isfinite(got).all()
    assert_close(torch.from_numpy(got), torch.from_numpy(want), FORWARD_TOL)
    with pytest.raises(RuntimeError, match="spatial_tiling"):
        PaddedVE(model, device="cpu", sharded=True)(fr)


def test_ve_ctx_batch_keeps_the_tile_index_outermost():
    """VE's one ctx call stacks its seven frames sample-major ((B, 7, ...),
    the tile index outermost), so each tile's halo comes from its own
    neighbours.  Batching the neighbours and the centers direction-major
    (cat on dim 0, as the untiled forward once did) puts the tiles inside:
    the conv then reads the batch's first quarter as tile 0, takes its
    halos from the wrong tiles, and the contexts are wrong at the tiles'
    edges."""
    H, W = VE_FRAMES["tile4"]
    model = ve_params()[2]
    fr = [torch.from_numpy(f) for f in window(np.random.RandomState(6), H, W)]
    order = [0, 1, 2, 4, 5, 6, 3]  # the six neighbours, then the center
    with torch.no_grad():
        want = model.ctxNet(torch.stack([fr[i] for i in order], 1).reshape(7, 3, H, W))
        mesh, ctx, _ = partitioned("tile4", (H, W))
        with ctx:
            t = shard_frames(mesh, *fr)
            got = gather_frames(mesh, model.ctxNet(
                torch.stack([t[i] for i in order], 1).reshape(28, 3, H, W // 4)))
            neigh = torch.stack([t[i] for i in order[:6]], 1).reshape(24, 3, H, W // 4)
            trap = model.ctxNet(torch.cat([neigh, t[3]], 0))
            trap = torch.cat([trap[:24].reshape(4, 6, 64, H, W // 4),
                              trap[24:].reshape(4, 1, 64, H, W // 4)], 1)
            trap = gather_frames(mesh, trap.reshape(28, 64, H, W // 4))
    assert_close(got, want, FORWARD_TOL)
    assert float((trap - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_spynet_pyramid_reads_the_global_level_sizes(monkeypatch):
    """At 720p's width over 4 tiles SPyNet pools 5 times, down to 42 columns
    (stacked tiles of 11), and starts from a zero flow of 21 columns whose
    stacked tiles are 6 wide: the pyramid reads the partition's global level
    sizes (a tile's own 11 columns would stop it a level early).  The levels'
    convs are stubbed out: only the geometry runs."""
    from memcnet_tpu_torch.models import spynet

    monkeypatch.setattr(spynet._Basic, "forward", lambda self, inp: inp[:, 6:8] * 0)
    seen = []
    real = P.Partition.level_input_window

    def spy(self, flow, fst):
        seen.append((self.level(fst), tuple(fst.shape[2:]), tuple(flow.shape[2:])))
        return real(self, flow, fst)

    monkeypatch.setattr(P.Partition, "level_input_window", spy)
    mesh = make_mesh(4, devices=CPU4)
    with torch.no_grad(), spatial_tiling(mesh, halo=HALO):
        x = shard_frames(mesh, torch.rand(1, 3, 64, 1344))
        out = spynet.SPyNet()(x, x)
    assert [lv for lv, _, _ in seen] == [(64 >> k, 1344 >> k) for k in range(5, -1, -1)]
    assert seen[0][1:] == ((2, 11), (1, 6))
    assert out.shape == (4, 2, 64, 336)
