"""The plain versions of K3's tile entry and K2's fused payload entries on the
CPU: the stacked-tile neighbour map K3's tile entry walks against
``TileRing.shift``; the payloads the scatter builds (N7's (-f d, d), N8's
gate) against the PyTorch payload compositions they replace, bit for bit,
and against the JAX package's depth_flow_project and weighted_flow_project,
whole and on partitioned frames; the tiled fill with carries given for an
axis against the carries it makes.  Small sizes: a few seconds in all.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import memcnet_tpu.ops as J

from memcnet_tpu_torch.ops import projection as TP
from memcnet_tpu_torch.ops.cuda import project_kernel as P
from memcnet_tpu_torch.ops.frame import TileFrame, WholeFrame
from memcnet_tpu_torch.parallel import (active_partition, make_mesh, make_mesh_2d, shard_frames,
                                        spatial_tiling)
from memcnet_tpu_torch.parallel import tiling as T

CPU4 = [torch.device("cpu")] * 4
GRIDS = {"tile4": (lambda: make_mesh(4, devices=CPU4), None),
         "tile2x2": (lambda: make_mesh_2d(4, devices=CPU4), "tile_h")}
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("data", [1, 2])
def test_stacked_neighbour_is_the_rings_shift(grid, data):
    """b - k inner, the tile K3's tile entry reads k tiles before b, is the
    tile TileRing.shift brings to b wherever that shift does not wrap
    around the frame's edge, and -1 exactly where it does."""
    factory, axis_h = GRIDS[grid]
    ring = T._ring(factory(), data, "tile", axis_h)
    for axis in ("tile",) + ((axis_h,) if axis_h else ()):
        t_, inner = ring.stacked(axis)
        idx = ring.index(axis, torch.device("cpu"))
        for k in [k for k in range(-(t_ - 1), t_) if k]:
            got = P.stacked_neighbour(ring.n, t_, inner, k)
            shifted = ring.shift(torch.arange(ring.n), axis, k)
            inside = (idx - k >= 0) & (idx - k < t_)
            assert torch.equal(got[inside], shifted[inside]), (axis, k)
            assert bool((got[~inside] == -1).all()), (axis, k)


def parent_weighted_payload(flow, frame1, frame2, threshold, fr):
    """The gated payload as PyTorch built it in front of the scatter before
    the scatter built it itself: err on ``fr``'s coordinates, frame2 read
    whole, the gate valid landing & err <= threshold."""
    f = flow.float()
    n, _, h, w = f.shape
    H, W = fr.size
    ys, xs = fr.coords(n, h, w, f.device)
    x3 = (xs + 2.0 * f[:, 0]).clamp(0.0, W - 1.0).to(torch.int32)
    y3 = (ys + 2.0 * f[:, 1]).clamp(0.0, H - 1.0).to(torch.int32)
    diff = (frame1.float() - fr.take(fr.whole(frame2).float(), y3, x3)).abs()
    three = torch.full((), 3.0)
    err = diff[:, 0] / three + diff[:, 1] / three + diff[:, 2] / three + 1e-8
    x2, y2 = xs + f[:, 0], ys + f[:, 1]
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 <= W - 1.0) & (y2 <= H - 1.0)
    gate = valid & (err <= threshold)
    payload = torch.cat([-f, err[:, None], torch.ones_like(err[:, None])], dim=1)
    return torch.where(gate[:, None], payload, 0.0)


def gated_inputs(rng, B, H, W):
    flow = (rng.randn(B, 2, H, W) * 3).astype(np.float32)
    flow[:, 0, :2] = 2.5 * W  # lands outside
    frame1 = rng.rand(B, 3, H, W).astype(np.float32)
    frame2 = np.clip(frame1 + rng.randn(B, 3, H, W).astype(np.float32) * 0.1, 0, 1)
    depth = (rng.randint(1, 8, (B, 1, H, W)) * 0.25).astype(np.float32)
    return flow, frame1, frame2.astype(np.float32), depth


def test_fused_payloads_whole_equal_the_compositions_and_jax(rng):
    """op_stage_reference (what the fused untiled entry is held against)
    equals the PyTorch payload + scatter composition bit for bit, with an
    err exactly at the threshold gated in and one ulp lower gated out; its
    result matches the JAX ops."""
    B, H, W = 2, 12, 21
    flow, f1, f2, depth = (t(a) for a in gated_inputs(rng, B, H, W))
    err = TP.brightness_error(flow, f1, f2)
    at = float(err[1, 5, 7])
    below = float(np.nextafter(np.float32(at), np.float32(0)))
    for threshold, gated in ((at, 1.0), (below, 0.0)):
        want = P.payload_stage_reference(
            flow, parent_weighted_payload(flow, f1, f2, threshold, WholeFrame(flow)), True)
        got = P.op_stage_reference("gated", flow, (f1, f2), threshold, True)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert all(torch.equal(g, w) for g, w in zip(got[3], want[3]))
        assert float(P.op_payload("gated", flow, (f1, f2), threshold)[1, 3, 5, 7]) == gated
    want = P.payload_stage_reference(flow, torch.cat([-flow * depth, depth], 1), False)
    got = P.op_stage_reference("depth", flow, (depth,), 0.0, False)
    assert all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
    jd = J.depth_flow_project(jnp.asarray(flow.numpy()), jnp.asarray(depth.numpy()))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jd), rtol=0, atol=TOL * 3 * W)
    _, out, extra, _ = P.op_stage_reference("gated", flow, (f1, f2), 0.1, False)
    jw, jwp = J.weighted_flow_project(*(jnp.asarray(a.numpy()) for a in (flow, f1, f2)),
                                      threshold=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jw), rtol=0, atol=TOL * 3 * W)
    np.testing.assert_allclose(extra.numpy(), np.asarray(jwp), rtol=0, atol=TOL)


@pytest.mark.parametrize("grid, frame, level", [("tile4", (16, 92), (8, 46)),
                                                ("tile2x2", (30, 38), (15, 19))])
def test_fused_payloads_on_tiles_equal_the_compositions_and_jax(rng, grid, frame, level):
    """payload_tile_reference (what the fused tile entry is held against)
    equals the payload + scatter composition of the partitioned ops bit for
    bit on a level whose tiles are uneven; its divided sums match the JAX
    ops on the whole frame."""
    factory, axis_h = GRIDS[grid]
    mesh = factory()
    H, W = level
    flow, f1, f2, depth = (t(a) for a in gated_inputs(rng, 2, H, W))
    with spatial_tiling(mesh, halo=2, axis_h=axis_h):
        shard_frames(mesh, torch.zeros((1, 1) + frame))
        ft, t1, t2, dt = shard_frames(mesh, flow, f1, f2, depth)
        p = active_partition()
        fr = TileFrame(p, (H, W))
        n = ft.shape[0]
        org, S = p.origins((H, W), n, ft.device), p.samples(n)
        assert len({int(w) for w in org[:, 3]}) > 1  # uneven owned widths
        cases = {"depth": ((dt,), TP.depth_payload(ft, dt)),
                 "gated": ((t1, p.gather(t2, (H, W))),
                           parent_weighted_payload(ft, t1, t2, 0.1, fr))}
        for op, (ins, payload) in cases.items():
            got = P.payload_tile_reference(op, ft, ins, 0.1, org, S, H, W)
            assert torch.equal(got, P.payload_tile_sums_reference(ft, payload, org, S, H, W)), op
            den = got[:, -1:]
            avg = got[:, :-1] / torch.where(den > 0, den, 1.0)
            if op == "depth":
                want = J.depth_flow_project(jnp.asarray(flow.numpy()),
                                            jnp.asarray(depth.numpy()))
            else:
                want = np.concatenate([np.asarray(a) for a in J.weighted_flow_project(
                    *(jnp.asarray(a.numpy()) for a in (flow, f1, f2)), threshold=0.1)], 1)
            np.testing.assert_allclose(avg.numpy(), np.asarray(want), rtol=0, atol=TOL * 3 * W)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tiled_fill_with_carries_given_equals_the_carries_it_makes(rng, grid):
    """The tiled fill's plain composition with an axis's carries given (an
    axis across ranks) equals the one that makes them from the stacked
    tiles, on (1, 4) carries from two tiles away included."""
    factory, axis_h = GRIDS[grid]
    ring = T._ring(factory(), 2, "tile", axis_h)
    n, H, W = ring.n, 9, 13
    cnt = t((rng.rand(n, H, W) < 0.04).astype(np.float32))
    avg = t(rng.randn(n, 2, H, W).astype(np.float32)) * (cnt > 0)[:, None]
    has = cnt > 0
    left, right = T._row_carries(avg, has, ring, "tile")
    up = T._up_carry(avg, has, ring, axis_h) if axis_h else None
    want = T._tiled_fill(avg, cnt, ring, "tile", axis_h, torch.float32)
    for given in ((left, right, up), (left, right, None), (None, None, up)):
        got = T.tiled_fill_reference(avg, cnt, ring, "tile", axis_h, torch.float32, *given)
        assert torch.equal(got, want)
    t_, inner = ring.stacked("tile")
    prev = P.stacked_neighbour(n, t_, inner, 1)
    empty_prev = ~has.any(2)[prev.clamp(min=0)] & (prev >= 0)[:, None]
    if t_ > 2:  # a carry from two tiles away
        assert bool(((left[:, 0] > 0) & empty_prev).any())
