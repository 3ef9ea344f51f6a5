"""The op library on partitioned frames on the CPU: every op of
``memcnet_tpu_torch.ops`` and the layers ``grid_sample_bilinear`` and
``replication_pad2d`` on frames sharded under ``spatial_tiling``, against
the untiled port op and the JAX op, as GSPMD runs the JAX ops on
``frame_sharding``-placed arrays (tests/test_torch_partition.py holds the
layers of the models).

The tiles of a mesh are stacked into the batch in one process, on the grids
(data 1, tile 4) at 64x256 and (1, tile_h 2, tile 2) at 128x128, B = 2;
flows of up to 20 px land across tiles, and of up to 100 px beyond any halo
(HALO = 16: these ops take no halo budget and clamp no flow).  Inputs are
made with numpy from a seed, float32.  Each op's whole-level gathers and
reductions per call (``parallel.partition.gathers`` and ``reductions``) are
counted, forward and backward.  Uneven levels (tiles of 3, 2, 3, 2 columns,
and of 2 and 1 rows) are held for a gathering op, two reducing ops and the
fill; derived extents (separable_conv's valid output, a padded extent, a
grid of another size) are tiled by the ownership rule.

Tolerances: against the untiled port op, LAYER_TOL (1e-6) of the output's
scale (the scatters sum in another order), where its zeros and its 1e-4
out-of-frame weights fall exactly, and the VJP of a seeded cotangent within
GRAD_LAYER_TOL (1e-5) of its largest (the hand backwards of N7, N9 and the
splats, autograd elsewhere); against the JAX op OP_TOL (1e-5, the op
tolerance of tests/test_torch_opslib.py); counts exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import memcnet_tpu.ops as J
from memcnet_tpu.nn import layers as JL
from memcnet_tpu.parallel import mesh as JMesh

from memcnet_tpu_torch import ops as T
from memcnet_tpu_torch.nn import layers as L
from memcnet_tpu_torch.ops.cuda import project_kernel as P
from memcnet_tpu_torch.ops.sepconv import FLOW_SENTINEL
from memcnet_tpu_torch.parallel import (active_partition, gather_frames, make_mesh,
                                        make_mesh_2d, shard_frames, spatial_tiling)
from memcnet_tpu_torch.parallel import partition as PT

from test_torch_partition import CPU4, GRAD_LAYER_TOL, HALO, LAYER_TOL

OP_TOL = 1e-5
# (mesh factory, H tile axis, frame)
GRIDS = {"tile4": (lambda: make_mesh(4, devices=CPU4), None, (64, 256)),
         "tile2x2": (lambda: make_mesh_2d(4, devices=CPU4), "tile_h", (128, 128))}
AMPS = (20.0, 100.0)  # the flows' largest px: across tiles, and beyond the halo
SEPCONV_FS = 5
PAD = (2, 3, 1, 2)    # replication_pad2d's (left, right, top, bottom)
GRID_CUT = (6, 10)    # the sample grid is (H - 6, W - 10): a derived extent


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two threads: the suite's workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def inputs(H, W, amp, seed=0):
    """Seeded float32 numpy inputs of every op at B = 2."""
    rng = np.random.RandomState(seed)
    f1 = rng.rand(2, 3, H, W)
    gh, gw = max(H - GRID_CUT[0], 1), max(W - GRID_CUT[1], 1)
    vh, vw = max(H - SEPCONV_FS + 1, 1), max(W - SEPCONV_FS + 1, 1)
    x = dict(frame1=f1, frame2=np.clip(f1 + rng.randn(2, 3, H, W) * 0.1, 0, 1),
             ctx=rng.rand(2, 5, H, W) * 2 - 1, flow=(rng.rand(2, 2, H, W) - 0.5) * 2 * amp,
             depth=np.round(rng.rand(2, 1, H, W) * 4) / 4 + 0.25, fw=rng.rand(2, 1, H, W),
             vert=rng.randn(2, SEPCONV_FS, vh, vw), horiz=rng.randn(2, SEPCONV_FS, vh, vw),
             grid=rng.rand(2, gh, gw, 2) * 2.2 - 1.1)
    return {k: v.astype(np.float32) for k, v in x.items()}


# name: (port op, JAX op, arguments, (gathers, reductions) forward, backward)
OPS = {
    "bilinear_warp": (T.bilinear_warp, J.bilinear_warp, ("frame1", "flow"), (1, 0), (0, 0)),
    "bilinear_warp_ch": (T.bilinear_warp_ch, J.bilinear_warp_ch, ("ctx", "flow"), (1, 0),
                         (0, 0)),
    "depth_flow_project": (lambda f, d: T.depth_flow_project(f, d, fillhole=True),
                           lambda f, d: J.depth_flow_project(f, d, fillhole=True),
                           ("flow", "depth"), (0, 1), (1, 0)),
    "depth_flow_project_nofill": (T.depth_flow_project, J.depth_flow_project,
                                  ("flow", "depth"), (0, 1), (1, 0)),
    "weighted_flow_project": (
        lambda f, a, b: T.weighted_flow_project(f, a, b, threshold=0.2, fillhole=True),
        lambda f, a, b: J.weighted_flow_project(f, a, b, threshold=0.2, fillhole=True),
        ("flow", "frame1", "frame2"), (1, 1), (1, 0)),
    "separable_conv": (T.separable_conv, J.separable_conv, ("frame1", "vert", "horiz"), (0, 0),
                       (0, 0)),
    "separable_conv_flow": (T.separable_conv_flow, J.separable_conv_flow, ("vert", "horiz"),
                            (0, 0), (0, 0)),
    "occlusion_weight": (T.occlusion_weight, J.occlusion_weight, ("frame1", "frame2", "flow"),
                         (1, 0), (0, 0)),
    "pixel_splat": (T.pixel_splat, J.pixel_splat, ("frame1", "flow", "fw"), (0, 1), (1, 0)),
    "pixel_value": (T.pixel_value, J.pixel_value, ("frame1", "flow", "fw"), (0, 1), (1, 0)),
    "pixel_weight": (T.pixel_weight, J.pixel_weight, ("flow", "fw"), (0, 1), (1, 0)),
    "reliable_weight": (T.reliable_weight, J.reliable_weight, ("flow",), (0, 1), (1, 0)),
    "replication_pad2d": (lambda x: L.replication_pad2d(x, PAD),
                          lambda x: JL.replication_pad2d(x, PAD), ("frame1",), (0, 0), (0, 0)),
    "grid_sample_bilinear": (L.grid_sample_bilinear, JL.grid_sample_bilinear,
                             ("frame1", "grid"), (1, 0), (0, 0)),
}


def shard(mesh, key, t):
    """A whole input -> its tiles; the channels-last grid over its dims 1, 2."""
    if key == "grid":
        return shard_frames(mesh, t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return shard_frames(mesh, t)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def untiled_vjp(fn, args, cots):
    xs = [a.clone().requires_grad_(True) for a in args]
    out = as_tuple(fn(*xs))
    return [o.detach() for o in out], torch.autograd.grad(out, xs, cots)


def partitioned_vjp(grid, fn, keys, args, cots, frame=None):
    """(outputs gathered whole, input gradients, (gathers, reductions) of the
    forward, of the backward) of ``fn`` on the sharded inputs."""
    factory, axis_h, size = GRIDS[grid]
    mesh = factory()
    xs = [a.clone().requires_grad_(True) for a in args]
    with spatial_tiling(mesh, halo=HALO, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1) + (frame or size)))
        tiles = [shard(mesh, k, x) for k, x in zip(keys, xs)]
        PT.gathers.reset()
        PT.reductions.reset()
        out = as_tuple(fn(*tiles))
        fwd = (PT.gathers.count, PT.reductions.count)
        whole = [gather_frames(mesh, o) for o in out]
        PT.gathers.reset()
        PT.reductions.reset()
        grads = torch.autograd.grad(whole, xs, cots)
        bwd = (PT.gathers.count, PT.reductions.count)
    return [w.detach() for w in whole], grads, fwd, bwd


def assert_close(got, want, tol):
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_LAYER_TOL * max(top, 1e-30), top


def check(name, grid, x, frame=None):
    fn, jfn, keys, fwd_counts, bwd_counts = OPS[name]
    args = [torch.from_numpy(x[k]) for k in keys]
    want_out = [torch.from_numpy(np.asarray(o)) for o in
                as_tuple(jfn(*(jnp.asarray(x[k]) for k in keys)))]
    g = torch.Generator().manual_seed(3)
    port_out = as_tuple(fn(*args))
    cots = [torch.randn(o.shape, generator=g) for o in port_out]
    untiled, want_grads = untiled_vjp(fn, args, cots)
    got, grads, fwd, bwd = partitioned_vjp(grid, fn, keys, args, cots, frame)
    for o, u, j in zip(got, untiled, want_out):
        assert_close(o, u, LAYER_TOL)
        assert_close(o, j, OP_TOL)
        assert torch.equal(o == 0, u == 0)
        assert torch.equal(o == np.float32(1e-4), u == np.float32(1e-4))
    assert_grads_close(grads, want_grads)
    assert (fwd, bwd) == (fwd_counts, bwd_counts)
    return got


@pytest.mark.parametrize("amp", AMPS)
@pytest.mark.parametrize("name", list(OPS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_partitioned_op_matches_untiled_and_jax(grid, name, amp):
    check(name, grid, inputs(*GRIDS[grid][2], amp))


# level: (grid, frame, level) with tiles that do not divide the level
UNEVEN = {"tile4": ((64, 320), 5), "tile2x2": ((192, 320), 6)}


@pytest.mark.parametrize("name", ["bilinear_warp", "pixel_splat", "depth_flow_project"])
@pytest.mark.parametrize("grid", list(UNEVEN))
def test_uneven_level(grid, name):
    """2x10 on (1, 4) (3, 2, 3, 2 columns) and 3x5 on (1, 2, 2) (2, 1 rows,
    3, 2 columns): the stacked tiles' padding neither scatters nor is read."""
    frame, lvl = UNEVEN[grid]
    x = inputs(frame[0] >> lvl, frame[1] >> lvl, 4.0, seed=1)
    check(name, grid, x, frame=frame)


def test_every_name_runs_on_sharded_frames():
    """No name of ops.__all__ raises on sharded frames: the filter warps and
    flow_project on their tile-local steps (flows inside the halo budget),
    the others as above."""
    H, W = GRIDS["tile4"][2]
    x = {k: torch.from_numpy(v) for k, v in inputs(H, W, 3.0).items()}
    x["filt"] = torch.rand(2, 16, H, W, generator=torch.Generator().manual_seed(4))
    mesh = make_mesh(4, devices=CPU4)
    extra = {"filter_interp_warp": ("frame1", "flow", "filt"),
             "filter_interp_warp_split": ("frame1", "flow", "filt"), "flow_project": ("flow",)}
    with spatial_tiling(mesh, halo=HALO):
        shard_frames(mesh, x["frame1"])
        for name in T.__all__:
            keys = extra[name] if name in extra else OPS[name][2]
            tiles = [shard(mesh, k, x[k]) for k in keys]
            if name == "filter_interp_warp_split":
                out = T.filter_interp_warp_split((tiles[0],), *tiles[1:])
            else:
                out = getattr(T, name)(*tiles)
            assert all(bool(torch.isfinite(o).all()) for o in as_tuple(out)), name


def test_counts_and_depth_sums_exact():
    """The depth sums (quarters) and the gated count plane after K2's
    payload entry on tile origins (plain here) and the reduction equal the
    untiled sums exactly, on both grids."""
    for grid in GRIDS:
        factory, axis_h, (H, W) = GRIDS[grid]
        x = {k: torch.from_numpy(v) for k, v in inputs(H, W, 20.0).items()}
        payloads = {3: P.depth_payload(x["flow"], x["depth"]),
                    4: P.gated_payload(x["flow"], x["frame1"], x["frame2"], 0.2)}
        mesh = factory()
        for planes, payload in payloads.items():
            _, _, den = P.payload_average(x["flow"], payload)
            with spatial_tiling(mesh, halo=HALO, axis_h=axis_h):
                f, pl = shard_frames(mesh, x["flow"], payload)
                p = active_partition()
                n = f.shape[0]
                sums = P.payload_tile_sums_reference(f, pl, p.origins((H, W), n, f.device),
                                                     p.samples(n), H, W)
                assert torch.equal(sums[:, -1], den), (grid, planes)  # the whole frame's
                got = gather_frames(mesh, p.reduce(sums)[:, -1:])
            assert torch.equal(got[:, 0], den), (grid, planes)


@pytest.mark.parametrize("grid, frame, level", [("tile4", (8, 24), (2, 6)),
                                                ("tile2x2", (12, 12), (3, 3))])
def test_reduce_gradcheck(grid, frame, level):
    """torch.autograd.gradcheck in float64 of Partition.reduce (its backward
    is gather) at a level whose tiles do not divide it."""
    factory, axis_h, _ = GRIDS[grid]
    mesh = factory()
    g = torch.Generator().manual_seed(5)
    with spatial_tiling(mesh, halo=2, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1) + frame))
        p = active_partition()
        s = torch.randn((2, 2) + level, generator=g, dtype=torch.float64).requires_grad_(True)
        assert torch.autograd.gradcheck(p.reduce, (s,))
        t = p.reduce(s)
        assert torch.equal(p.merge(t), s.detach())


def test_derived_extents():
    """shard_frames and gather_frames take a derived extent; a tile width
    that names both a level and an extent raises, for shard_frames and for
    separable_conv (fs = 4 on 4 W tiles: 253 columns split 64, 63, 63, 63,
    and 64 is the full level's width)."""
    mesh = make_mesh(4, devices=CPU4)
    x = torch.rand(1, 2, 64, 250)
    with spatial_tiling(mesh, halo=HALO):
        shard_frames(mesh, torch.zeros(1, 1, 64, 256))
        t = shard_frames(mesh, x)
        assert t.shape == (4, 2, 64, 63) and torch.equal(gather_frames(mesh, t), x)
        with pytest.raises(ValueError, match="ambiguous"):
            shard_frames(mesh, torch.rand(1, 2, 64, 253))
        img = shard_frames(mesh, torch.rand(1, 3, 64, 256))
        with pytest.raises(ValueError, match="ambiguous"):
            T.separable_conv(img, torch.zeros(4, 4, 61, 64), torch.zeros(4, 4, 61, 64))


def test_separable_conv_flow_sentinel_in_padding_leaves_owned_pixels():
    """fs = 7 on 4 W tiles of 256: the valid extent of 250 columns splits
    63, 62, 63, 62; the padded columns of the stacked tiles (zero weights)
    take the -2000 sentinel and the owned pixels the untiled result."""
    rng = np.random.RandomState(6)
    vert, horiz = (torch.from_numpy(rng.rand(2, 7, 58, 250).astype(np.float32))
                   for _ in range(2))
    vert[0, :, 5, 100] = 0.0  # an owned sentinel too
    want = T.separable_conv_flow(vert, horiz)
    mesh = make_mesh(4, devices=CPU4)
    with spatial_tiling(mesh, halo=HALO):
        shard_frames(mesh, torch.zeros(1, 1, 64, 256))
        tv, th = shard_frames(mesh, vert, horiz)
        out = T.separable_conv_flow(tv, th)
        assert bool((out[2:4, :, :, -1] == FLOW_SENTINEL).all())  # tiles 1, 2's padding
        got = gather_frames(mesh, out)
    assert torch.equal(got == FLOW_SENTINEL, want == FLOW_SENTINEL)
    assert_close(got, want, LAYER_TOL)  # a sum over fs rounds by the tile's width


def test_jax_ops_on_frame_sharding_match_the_port():
    """The JAX ops on arrays placed with frame_sharding(make_mesh(4)) (GSPMD
    on 4 CPU devices) against the port's partitioned ops on (1, 4)."""
    x = inputs(64, 256, 20.0, seed=2)
    jmesh = JMesh.make_mesh(4)
    for name in ("bilinear_warp", "depth_flow_project", "pixel_splat", "weighted_flow_project"):
        fn, jfn, keys, _, _ = OPS[name]
        placed = [jax.device_put(jnp.asarray(x[k]), JMesh.frame_sharding(jmesh)) for k in keys]
        want = [torch.from_numpy(np.asarray(o)) for o in as_tuple(jfn(*placed))]
        args = [torch.from_numpy(x[k]) for k in keys]
        got, _, _, _ = partitioned_vjp("tile4", fn, keys, args,
                                       [torch.zeros_like(w) for w in want])
        for o, w in zip(got, want):
            assert_close(o, w, OP_TOL)
