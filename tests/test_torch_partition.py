"""Partitioned frames on the CPU (memcnet_tpu_torch.parallel.partition): every
spatial layer on its tile with halos, against the stock layer on the whole
tensor; MEMC_Net_star and MEMC_Net partitioned against their untiled
forwards and the JAX forward; the sharded train step against ``TrainStep``;
and what raises (tests/test_torch_partition_s_ve.py holds MEMC_Net_s and
MEMC_Net_VE).

The tiles of a mesh are stacked into the batch in one process
(``make_mesh(4, devices=[cpu] * 4)``); tests/test_torch_multiprocess.py runs
the same code across 4 gloo ranks.  Two grids, each with levels that do not
divide: (data 1, tile 4) at 64x320 (at 1/32 the 10 columns split 3, 2, 3, 2,
at 1/64 the 5 split 2, 1, 1, 1) and (1, tile_h 2, tile 2) at 192x320 (at 1/64
3 rows split 2, 1 and 5 columns 3, 2); the models also on the even (1, 2, 2)
grid at 128x128.  Inputs are made with numpy or torch from a seed, float32.

Tolerances: a layer within LAYER_TOL (1e-6) of its output's scale (the same
float32 arithmetic on a window of the input; the upsample rounds its two
lerps separately); gradients within 1e-5 of their scale; a model's every
output within 1e-4 of its scale; against the JAX forward the models' 1e-3
(tests/test_torch_models.py); a train step's gradients per subnet within
GRAD_TOL (1e-2) of the subnet's largest, 0.1 in MEMC_Net's BatchNorm trunks,
as tests/test_torch_train_models.py holds the port against JAX.
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

from memcnet_tpu_torch import parallel
from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model
from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.models.memc_net import MEMCNetStar
from memcnet_tpu_torch.nn import layers as L
from memcnet_tpu_torch.parallel import (active_partition, gather_frames, make_mesh,
                                        make_mesh_2d, replicated, shard_frames,
                                        spatial_tiling)
from memcnet_tpu_torch.parallel.partition import owned
from memcnet_tpu_torch.parallel.step import sharded_frames, sharded_mesh, sharded_train_step
from memcnet_tpu_torch.train.trainer import Adamax, TrainStep, interp_loss_fn

from test_torch_models import MODEL_TOL, numpy_params, to_jax
from test_torch_train_models import BN_TOL, GRAD_TOL, TRUNK_GRAD_TOL, TRUNKS

CPU4 = [torch.device("cpu")] * 4
HALO = 16
LAYER_TOL = 1e-6
GRAD_LAYER_TOL = 1e-5
FORWARD_TOL = 1e-4
FLOW_PX = 3.0  # the models' flows scaled to about this, inside the halo budget
# (grid name, mesh factory, H tile axis, frame)
GRIDS = {"tile4": (lambda: make_mesh(4, devices=CPU4), None, (64, 320)),
         "tile2x2": (lambda: make_mesh_2d(4, devices=CPU4), "tile_h", (192, 320))}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two threads: the suite's workers share the host's cores, and torch's
    default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def partitioned(grid, frame=None):
    """(mesh, context manager, whole frame size) of a grid; the context has
    a zero frame sharded, so its partition is recorded."""
    factory, axis_h, size = GRIDS[grid]
    size = frame or size
    mesh = factory()
    ctx = spatial_tiling(mesh, halo=HALO, axis_h=axis_h)
    return mesh, ctx, size


class Sharded:
    """``with Sharded(grid) as p``: the grid's context with its frame's
    partition recorded."""

    def __init__(self, grid, frame=None):
        self.mesh, self.ctx, self.size = partitioned(grid, frame)

    def __enter__(self):
        self.ctx.__enter__()
        shard_frames(self.mesh, torch.zeros((1, 1) + self.size))
        return active_partition()

    def __exit__(self, *exc):
        return self.ctx.__exit__(*exc)


def at_level(size, lvl, C=6, B=2, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, C, size[0] >> lvl, size[1] >> lvl), generator=g, dtype=dtype)


def assert_close(got, want, tol):
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def levels(p):
    """The levels every axis of the partition holds (1/2^l)."""
    return [lvl for lvl in range(8)
            if all((ax.size >> lvl) in ax.levels.values() and ax.size % (1 << lvl) == 0
                   for ax in p.axes)]


def conv_cases():
    cases = []
    for grid in GRIDS:
        with Sharded(grid) as p:
            lv = levels(p)
        for lvl in (0, lv[-2], lv[-1]):
            for k in (3, 5, 7):
                for s in (1, 2):
                    if s == 1 or lvl + 1 in lv:
                        cases.append((grid, lvl, k, s))
    return cases


# -- geometry ---------------------------------------------------------------------------


def test_ownership_rule_at_720p():
    assert [b - a for a, b in owned(1344, 4)] == [336] * 4
    assert [b - a for a, b in owned(42, 4)] == [11, 10, 11, 10]
    assert [b - a for a, b in owned(21, 4)] == [6, 5, 5, 5]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_levels_map_one_to_one_and_round_trip(grid):
    with Sharded(grid) as p:
        lv = levels(p)
        assert len(lv) == 7  # full resolution to 1/64
        for lvl in lv:
            x = at_level(p.frame, lvl)
            t = p.split(x)
            assert p.level(t) == (x.shape[2], x.shape[3])
            assert torch.equal(p.merge(t), x)
            uneven = any(len({b - a for a, b in ax.bounds(ax.size >> lvl)}) > 1 for ax in p.axes)
            assert (p.mask(t) is not None) == uneven  # only uneven levels hold padding
            assert uneven == (lvl == 6 or (lvl == 5 and grid == "tile4"))


def test_ambiguous_levels_raise():
    mesh = make_mesh(4, devices=CPU4)
    with spatial_tiling(mesh, halo=HALO):
        with pytest.raises(ValueError, match="does not split"):
            shard_frames(mesh, torch.zeros(1, 3, 64, 322))


@pytest.mark.parametrize("grid, spec", [("tile4", "frame_sharding"),
                                        ("tile2x2", "frame_sharding_2d")])
def test_frame_shardings_name_the_context_axes(grid, spec):
    """The counterparts of the JAX PartitionSpecs: shard_frames takes the
    context's (``frame_sharding`` for W tiles, ``frame_sharding_2d`` with H
    tiles) and refuses another; ``replicated`` leaves frames whole and
    records no partition (whole frames, the tiled warp and projection alone)."""
    x = torch.rand(1, 3, 64, 320) if grid == "tile4" else torch.rand(1, 3, 192, 320)
    mesh, ctx, _ = partitioned(grid)
    other = "frame_sharding_2d" if spec == "frame_sharding" else "frame_sharding"
    with ctx:
        assert shard_frames(mesh, x, sharding=replicated(mesh)) is x
        assert active_partition() is None
        with pytest.raises(ValueError, match="shards frames as"):
            shard_frames(mesh, x, sharding=getattr(parallel, other)(mesh))
        t = shard_frames(mesh, x, sharding=getattr(parallel, spec)(mesh))
        assert t.shape[0] == 4 and torch.equal(gather_frames(mesh, t), x)


def test_sharding_needs_the_context():
    mesh = make_mesh(4, devices=CPU4)
    with pytest.raises(RuntimeError, match="spatial_tiling"):
        shard_frames(mesh, torch.zeros(1, 3, 64, 256))
    with spatial_tiling(make_mesh(4, devices=CPU4), halo=HALO):
        with pytest.raises(RuntimeError, match="this mesh"):
            shard_frames(mesh, torch.zeros(1, 3, 64, 256))


# -- each layer against the stock layer on the whole tensor ------------------------------


@pytest.mark.parametrize("grid, lvl, k, s", conv_cases())
def test_conv2d_partitioned(grid, lvl, k, s):
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        g = torch.Generator().manual_seed(k * 10 + s)
        w, b = torch.randn((8, 6, k, k), generator=g), torch.randn(8, generator=g)
        got = p.merge(L.conv2d(p.split(x), w, b, stride=s, padding=(k - 1) // 2))
    assert_close(got, F.conv2d(x, w, b, stride=s, padding=(k - 1) // 2), LAYER_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lvl", [0, 5, 6])
def test_conv2d_groups2_partitioned(grid, lvl):
    """MonoNet5's dual path: two nets' 3x3 convs as one groups=2 conv."""
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        w = torch.randn((8, 3, 3, 3), generator=torch.Generator().manual_seed(2))
        got = p.merge(L.conv2d(p.split(x), w, None, padding=1, groups=2))
    assert_close(got, F.conv2d(x, w, None, padding=1, groups=2), LAYER_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lvl", [1, 5, 6])
def test_conv_transpose2d_partitioned(grid, lvl):
    """FlowNetS's k4 s2 p1 deconvs and upflows, level lvl -> lvl - 1."""
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        g = torch.Generator().manual_seed(4)
        w, b = torch.randn((6, 4, 4, 4), generator=g), torch.randn(4, generator=g)
        got = p.merge(L.conv_transpose2d(p.split(x), w, b, stride=2, padding=1))
    assert_close(got, F.conv_transpose2d(x, w, b, stride=2, padding=1), LAYER_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lvl, scale", [(6, 2), (5, 2), (1, 2), (2, 4), (6, 4)])
def test_upsample_bilinear_partitioned_on_global_coordinates(grid, lvl, scale):
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        got = p.merge(L.upsample_bilinear(p.split(x), scale))
    want = F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)
    assert_close(got, want, LAYER_TOL)


def test_upsample_on_a_tile_alone_is_not_global():
    """F.interpolate on a tile takes the tile's own scale: the reason the
    partitioned upsample lerps on global coordinates."""
    x = at_level((64, 320), 5)
    want = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    tile = F.interpolate(x[..., :3], scale_factor=2, mode="bilinear", align_corners=True)
    assert float((tile - want[..., :6]).abs().max()) > 1e-2


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lvl", [0, 4, 5])
def test_max_pool2d_partitioned(grid, lvl):
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        got = p.merge(L.max_pool2d(p.split(x), 2))
    assert torch.equal(got, F.max_pool2d(x, 2))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lvl", [0, 5, 6])
def test_batch_norm_train_masks_the_padding(grid, lvl):
    """Statistics over the owned pixels of every tile: the stacked tiles'
    padding (filled with 1e3 here) enters neither the mean nor the
    variance."""
    g = torch.Generator().manual_seed(5)
    gamma, beta = torch.randn(6, generator=g), torch.randn(6, generator=g)
    rm, rv = torch.randn(6, generator=g), torch.rand(6, generator=g) + 0.5
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
        t = p.split(x)
        mask = p.mask(t)
        if mask is not None:
            t = torch.where(mask > 0, t, 1e3)
        y, m, v = L.batch_norm_train(t, gamma, beta, rm, rv)
        y = p.merge(y)
    rm2, rv2 = rm.clone(), rv.clone()
    want = F.batch_norm(x, rm2, rv2, gamma, beta, True, 0.1, 1e-5)
    assert_close(y, want, LAYER_TOL)
    assert_close(m, rm2, LAYER_TOL)
    assert_close(v, rv2, LAYER_TOL)


def _layer_grads(fn, x, params, cot):
    x = x.clone().requires_grad_(True)
    ps = [q.clone().requires_grad_(True) for q in params]
    out = fn(x, *ps)
    return torch.autograd.grad(out, [x, *ps], cot)


LAYERS = {
    "conv k3 s2": (lambda x, w, b: L.conv2d(x, w, b, stride=2, padding=1), 5, (8, 6, 3, 3)),
    "conv k7 s1": (lambda x, w, b: L.conv2d(x, w, b, padding=3), 1, (8, 6, 7, 7)),
    "deconv": (lambda x, w, b: L.conv_transpose2d(x, w, b, stride=2, padding=1), 6, (6, 8, 4, 4)),
    "upsample x4": (lambda x: L.upsample_bilinear(x, 4), 6, None),
    "max-pool": (lambda x: L.max_pool2d(x, 2), 4, None),
    "batch norm": (lambda x, w, b: L.batch_norm_train(x, w, b, torch.zeros(6),
                                                      torch.ones(6))[0], 5, (6,)),
}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_gradients_through_the_halo_gather(grid, layer):
    """Input and parameter gradients of a partitioned layer: the halo
    gather's backward carries each tile's cotangents back to their owners."""
    fn, lvl, wshape = LAYERS[layer]
    g = torch.Generator().manual_seed(6)
    params = [] if wshape is None else [torch.randn(wshape, generator=g),
                                        torch.randn(wshape[1] if layer == "deconv" else wshape[0],
                                                    generator=g)]
    with Sharded(grid) as p:
        x = at_level(p.frame, lvl)
    cot = torch.randn(fn(x, *params).shape, generator=g)
    want = _layer_grads(fn, x, params, cot)
    with Sharded(grid) as p:
        got = _layer_grads(lambda xt, *ps: p.merge(fn(p.split(xt), *ps)), x, params, cot)
    for a, b in zip(got, want):
        assert_close(a, b, GRAD_LAYER_TOL)


def test_halo_gather_gradcheck():
    """torch.autograd.gradcheck in float64 of a 3x3 conv and the global
    upsample on a (1, 4) grid of 4x24 frames at 1/4 (6 columns: 2, 1, 2, 1
    over 4 tiles)."""
    mesh = make_mesh(4, devices=CPU4)
    g = torch.Generator().manual_seed(7)
    w = torch.randn((2, 2, 3, 3), generator=g, dtype=torch.float64)
    with spatial_tiling(mesh, halo=2):
        shard_frames(mesh, torch.zeros(1, 1, 4, 24))
        p = active_partition()
        x = torch.randn((1, 2, 4, 6), generator=g, dtype=torch.float64)
        xt = p.split(x).requires_grad_(True)
        assert torch.autograd.gradcheck(lambda t: L.conv2d(t, w, None, padding=1), (xt,))
        assert torch.autograd.gradcheck(lambda t: L.upsample_bilinear(t, 2), (xt,))


# -- what raises -------------------------------------------------------------------------


def test_a_tensor_of_no_level_raises():
    """A whole tensor passed to a layer on a partitioned frame: its width is
    no level of the frame (tests/test_torch_partition_ops.py runs the op
    library and the grid sample and replication pad layers on tiles)."""
    x = torch.rand(1, 3, 64, 256)
    with Sharded("tile4", (64, 256)):
        with pytest.raises(ValueError, match="no level"):
            L.conv2d(x, torch.zeros(1, 3, 3, 3), None, padding=1)


# -- the models --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def eval_model(name, H, W):
    """``scaled_model``, built once per size for the eval-mode tests."""
    return scaled_model(name, H, W)


def scaled_model(name, H, W, seed=0):
    """A seeded model whose FlowNetS last conv is scaled to give flows of
    about FLOW_PX on the test frames (random weights give 1e-8 px)."""
    model = build_model(name, seed=seed, device="cpu")
    x0, x2 = frames(H, W)
    with torch.no_grad():
        raw = float(model._flow(x0, x2).abs().max())
        model.flownets.predict_flow2.weight.mul_(FLOW_PX / raw)
    return model


def frames(H, W, B=1, seed=12):
    rng = np.random.RandomState(seed)
    a = rng.rand(B, 3, H, W).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(2, 3)) * 0.9 + 0.05
    return torch.from_numpy(a), torch.from_numpy(b)


def outputs(out):
    (interp, rectified), offs, filts, occs = out
    return [interp, rectified, *offs, *filts, *occs]


MODEL_GRIDS = [("tile4", (64, 320)), ("tile2x2", (128, 128))]


@pytest.mark.parametrize("name", ["MEMC_Net_star", "MEMC_Net"])
@pytest.mark.parametrize("grid, frame", MODEL_GRIDS, ids=[g for g, _ in MODEL_GRIDS])
def test_partitioned_forward_equals_untiled(name, grid, frame):
    """Every output of the partitioned eval forward (each layer on its
    tile, star's ctx conv on the halo-extended tile, the warp and the
    projection on their tile-local steps) against the untiled forward."""
    model = eval_model(name, *frame)
    x0, x2 = frames(*frame)
    with torch.no_grad():
        want = outputs(model(x0, x2))
        mesh, ctx, _ = partitioned(grid, frame)
        with ctx:
            t0, t2 = shard_frames(mesh, x0, x2)
            assert t0.shape[0] == 4  # 4 tiles of 1 sample, stacked
            got = [gather_frames(mesh, o) for o in outputs(model(t0, t2))]
    assert 0.5 * FLOW_PX < float(want[2].abs().max()) <= HALO - 4
    for g, w in zip(got, want):
        assert_close(g, w, FORWARD_TOL)


def test_padded_interp_sharded_equals_untiled():
    """PaddedInterp(sharded=True) under spatial_tiling: pad, shard_frames,
    forward, gather, unpad."""
    model = eval_model("MEMC_Net", 128, 128)  # a 100x100 frame pads to 128x128
    rng = np.random.RandomState(3)
    a = rng.rand(3, 100, 100).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    want, want_aux = PaddedInterp(model, device="cpu")(a, b)
    mesh, ctx, _ = partitioned("tile2x2", (128, 128))
    with ctx:
        got, aux = PaddedInterp(model, device="cpu", sharded=True)(a, b)
    assert got.shape == (3, 100, 100)
    assert_close(torch.from_numpy(got), torch.from_numpy(want), FORWARD_TOL)
    assert_close(torch.from_numpy(aux["offsets"][1]), torch.from_numpy(want_aux["offsets"][1]),
                 FORWARD_TOL)
    with pytest.raises(RuntimeError, match="spatial_tiling"):
        PaddedInterp(model, device="cpu", sharded=True)(a, b)


def test_star_partitioned_matches_jax():
    """The JAX forward of the same weights (through params_from_jax) on the
    same seeded frames, whole, against the port's partitioned forward on
    the uneven (1, 4) grid."""
    jmodel = JM.get_model("MEMC_Net_star")
    shapes = {k: v.shape for k, v in jax.eval_shape(jmodel.init_params, jr.PRNGKey(0)).items()}
    flat = numpy_params(shapes, 11, flow_scale=0.02)
    model = MEMCNetStar()
    load_jax_params(model, flat)
    model.eval()
    x0, x2 = frames(64, 320, B=1)
    want = outputs(jax.jit(jmodel.forward)(to_jax(flat), jnp.asarray(x0.numpy()),
                                           jnp.asarray(x2.numpy())))
    mesh, ctx, _ = partitioned("tile4", (64, 320))
    with torch.no_grad(), ctx:
        got = [gather_frames(mesh, o) for o in outputs(model(*shard_frames(mesh, x0, x2)))]
    assert float(np.abs(np.asarray(want[2])).max()) > 0.05  # the flows are not trivial
    for g, w in zip(got, want):
        assert_close(g, torch.from_numpy(np.array(w)), MODEL_TOL)


def test_flow_batching_keeps_the_tile_index_outermost():
    """``_flow`` stacks both directions sample-major (stack on dim 1), so
    the tile index stays outermost in the 2B batch and each tile's halos
    come from its own neighbours.  Batching direction-major (cat on dim 0)
    puts the directions outside the tiles: the layers then read the batch's
    first quarter as tile 0, the halos come from the wrong tiles, and the
    flows are plausible but wrong."""
    model = eval_model("MEMC_Net", 64, 320)
    x0, x2 = frames(64, 320)
    pairs = torch.stack((torch.cat((x0, x2), 1), torch.cat((x2, x0), 1)), 1).reshape(2, 6, 64, 320)
    with torch.no_grad():
        want, want_net = model._flow(x0, x2), model.flownets(pairs)
        mesh, ctx, _ = partitioned("tile4", (64, 320))
        with ctx:
            t0, t2 = shard_frames(mesh, x0, x2)
            got = gather_frames(mesh, model._flow(t0, t2))
            # direction-major: (direction, tile, sample) where the layers read (tile, .)
            trap = model.flownets(torch.cat((torch.cat((t0, t2), 1), torch.cat((t2, t0), 1)), 0))
            trap = trap.reshape((2, 4) + trap.shape[1:]).transpose(0, 1)
            trap = gather_frames(mesh, trap.reshape((8,) + trap.shape[2:]))
    assert_close(got, want, FORWARD_TOL)
    assert float((trap - want_net).abs().max()) > 1e-2 * float(want_net.abs().max())


def _grads_by_subnet(model):
    out = {}
    for k, p in model.named_parameters():
        if p.grad is not None:
            out.setdefault(k.split(".")[0], {})[k] = p.grad.detach().clone()
    return out


def _assert_subnet_grads(got, want, trunk_tol):
    assert set(got) == set(want)
    for sub, grads in want.items():
        top = max(float(g.abs().max()) for g in grads.values())
        tol = trunk_tol if sub in TRUNKS else GRAD_TOL
        for k, g in grads.items():
            err = float((got[sub][k] - g).abs().max())
            assert err <= tol * top, f"{k}: {err} > {tol} x {top}"


def test_sharded_train_step_equals_whole_frame_step():
    """``sharded_train_step`` in one process on (1, 2), 64x128, its frames
    sharded: the loss within 1e-5 relative of ``TrainStep`` on the whole
    frames, the gradients per subnet at tests/test_torch_train_models.py's
    rule (tests/test_torch_multiprocess.py takes the (1, 2, 2) step across
    4 ranks)."""
    mesh, axis_h = sharded_mesh(devices=CPU4[:2])
    fr = sharded_frames(mesh)
    loss, model, _ = sharded_train_step(mesh, axis_h, fr, lr=2e-3, device="cpu")
    ref = build_model("MEMC_Net_star", seed=0, device="cpu")
    ref_loss = TrainStep(ref, Adamax(ref, lr=2e-3), interp_loss_fn(ref), "cpu")(*fr)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    _assert_subnet_grads(_grads_by_subnet(model), _grads_by_subnet(ref), GRAD_TOL)


def test_memc_net_train_mode_partitioned_masks_batch_norm():
    """MEMC_Net's train-mode residuals, loss, gradients and BatchNorm
    running statistics on the uneven (1, 4) grid: its trunks' BatchNorms at
    1/32 take statistics over 3, 2, 3, 2 owned columns of 3 stacked tiles
    padded to 3."""
    H, W = 64, 320
    x0, x2 = frames(H, W)
    x1 = (x0 + x2) / 2

    def run(sharded):
        model = scaled_model("MEMC_Net", H, W).train()
        if not sharded:
            res = model.train_residuals(x0, x1, x2)[0]
            loss = interp_loss_fn(model)(x0, x1, x2)
            loss.backward()
            return res, loss, model
        mesh, ctx, _ = partitioned("tile4", (H, W))
        with ctx:
            t = shard_frames(mesh, x0, x1, x2)
            res = [gather_frames(mesh, r) for r in model.train_residuals(*t)[0]]
            loss = interp_loss_fn(model)(*t)
            loss.backward()
        return res, loss, model

    want_res, want_loss, ref = run(False)
    got_res, got_loss, model = run(True)
    for g, w in zip(got_res, want_res):
        assert_close(g.detach(), w.detach(), FORWARD_TOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss.detach()), rtol=1e-5)
    _assert_subnet_grads(_grads_by_subnet(model), _grads_by_subnet(ref), TRUNK_GRAD_TOL)
    sd, rsd = model.state_dict(), ref.state_dict()
    stats = [k for k in sd if "running_" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), rsd[k].numpy(), rtol=0, atol=BN_TOL, err_msg=k)
