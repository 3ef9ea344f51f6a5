"""CPU parity of the port's parallel layer (memcnet_tpu_torch.parallel) with
the JAX package, in one process: the mesh factorisations, the ZeRO-1
partition rule, the tiled warp and projection against the JAX package's
``tiled_*`` on the 8 virtual CPU devices (tests/conftest.py) and against
the port's global ops, the dispatch under ``spatial_tiling``, and the
tile-local versions' gradients.

In one process a mesh's tiles are stacked into the batch dimension
(parallel/ring.py), so these tests run the same tile-local code that one
card runs; tests/test_torch_multiprocess.py runs the ring across ranks.
Inputs are made with numpy from a seed, with the JAX tests' shapes (B 2,
32x256 and 64x128, halo 16 and 32) and draws (tests/test_parallel.py).
Tolerances: the warp 1e-5; the projection rtol 1e-4 and atol 1e-5 (the
spill bands are added in another order than the global fold), counts
exact; gradients 1e-5 of each gradient's largest.  The JAX tiled ops run
under ``jax.jit``, as the JAX package's sharded step runs them: eagerly, a
tiled projection with the fill takes some 45 s on this CPU, jitted 3.
"""

import numpy as np
import pytest
import torch

import jax

from memcnet_tpu.ops import filter_interp_warp as jwarp
from memcnet_tpu.ops.warp import filter_interp_warp_split as jwarp_split
from memcnet_tpu.ops import flow_project as jproject
from memcnet_tpu.parallel import context as jctx
from memcnet_tpu.parallel import mesh as jmesh
from memcnet_tpu.parallel import tiling as jtiling

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch import ops
from memcnet_tpu_torch.ops.cuda import project_kernel
from memcnet_tpu_torch.parallel import (make_mesh, make_mesh_2d, spatial_tiling, tiling,
                                        zero1_partition)

CPU8 = [torch.device("cpu")] * 8
WARP_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def mesh_1d():
    return make_mesh(8, max_tile=4, devices=CPU8), jmesh.make_mesh(8, max_tile=4)


def mesh_2d():
    return make_mesh_2d(8, tile_h=2, tile_w=2, devices=CPU8), jmesh.make_mesh_2d(8)


def warp_inputs(rng, B, C, H, W, halo):
    image = rng.rand(B, C, H, W).astype(np.float32)
    flow = (rng.rand(B, 2, H, W).astype(np.float32) - 0.5) * 2 * (halo - 6)
    filt = rng.rand(B, 16, H, W).astype(np.float32)
    return image, flow, filt


def jitted(fn, *arrays):
    """``fn(*arrays)`` under jax.jit (the spatial_tiling context, where one
    is active, is read while tracing)."""
    return jax.jit(fn)(*arrays)


def assert_projection(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("n, max_tile", [(8, 4), (8, 1), (8, 2), (4, 4), (2, 4), (1, 4)])
def test_make_mesh_factorises_as_jax(n, max_tile):
    mesh = make_mesh(n, max_tile=max_tile, devices=CPU8)
    assert mesh.shape == dict(jmesh.make_mesh(n, max_tile=max_tile).shape)
    assert mesh.size == n and not mesh.across and len(mesh.devices) == n


@pytest.mark.parametrize("n, th, tw", [(8, 2, 2), (4, 2, 2), (8, 1, 4), (8, 2, 1)])
def test_make_mesh_2d_factorises_as_jax(n, th, tw):
    mesh = make_mesh_2d(n, tile_h=th, tile_w=tw, devices=CPU8)
    assert mesh.shape == dict(jmesh.make_mesh_2d(n, tile_h=th, tile_w=tw).shape)


def test_make_mesh_2d_rejects_an_uneven_grid():
    with pytest.raises(ValueError):
        make_mesh_2d(6, devices=[torch.device("cpu")] * 6)


def _jax_zero1_dim(mesh, shape):
    spec = tuple(jmesh._zero1_leaf_sharding(mesh, shape).spec)
    dims = [d for d, s in enumerate(spec) if s is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_zero1_partition_matches_jax_on_star_parameters(n):
    shapes = {tuple(p.shape) for p in TM.get_model("MEMC_Net_star").parameters()}
    jm = jmesh.make_mesh(n)
    got = {s: zero1_partition(s, n) for s in shapes}
    assert got == {s: _jax_zero1_dim(jm, s) for s in shapes}
    if n > 1:  # both outcomes occur on star's parameters
        assert None in got.values() and any(d is not None for d in got.values())


# -- the tiled warp ------------------------------------------------------------


@pytest.mark.parametrize("halo", [16, 32])
def test_tiled_warp_matches_jax_and_global(rng, halo):
    mesh, jm = mesh_1d()
    image, flow, filt = warp_inputs(rng, 2, 3, 32, 256, halo)
    want = np.asarray(jitted(lambda i, f, k: jtiling.tiled_filter_interp_warp(
        jm, i, f, k, halo=halo), image, flow, filt))
    got = tiling.tiled_filter_interp_warp(mesh, t(image), t(flow), t(filt), halo=halo)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_TOL)
    glob = ops.filter_interp_warp(t(image), t(flow), t(filt))
    np.testing.assert_allclose(got.numpy(), glob.numpy(), rtol=0, atol=WARP_TOL)


def test_tiled_warp_clamps_out_of_budget_flow(rng):
    mesh, jm = mesh_1d()
    B, C, H, W = 1, 3, 16, 256
    image = rng.rand(B, C, H, W).astype(np.float32)
    flow = np.full((B, 2, H, W), 300.0, np.float32)
    filt = rng.rand(B, 16, H, W).astype(np.float32)
    got = tiling.tiled_filter_interp_warp(mesh, t(image), t(flow), t(filt), halo=16).numpy()
    np.testing.assert_allclose(got, image)  # every pixel invalid: passed through
    # within the frame but beyond the budget: the clamped flow, as in JAX
    flow = np.full((B, 2, H, W), 1.5, np.float32)
    flow[:, 0] = 40.0
    want = np.asarray(jitted(lambda i, f, k: jtiling.tiled_filter_interp_warp(
        jm, i, f, k, halo=16), image, flow, filt))
    got = tiling.tiled_filter_interp_warp(mesh, t(image), t(flow), t(filt), halo=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_TOL)
    clamped = flow.copy()
    clamped[:, 0] = 12.0
    glob = ops.filter_interp_warp(t(image), t(clamped), t(filt))
    np.testing.assert_allclose(got.numpy(), glob.numpy(), rtol=0, atol=WARP_TOL)


@pytest.mark.parametrize("halo", [16, 32])
def test_tiled_warp_2d_matches_jax_and_global(rng, halo):
    mesh, jm = mesh_2d()
    image, flow, filt = warp_inputs(rng, 2, 3, 64, 128, halo)
    want = np.asarray(jitted(lambda i, f, k: jtiling.tiled_filter_interp_warp(
        jm, i, f, k, halo=halo, axis_h="tile_h", batch_axis="data"), image, flow, filt))
    got = tiling.tiled_filter_interp_warp(mesh, t(image), t(flow), t(filt), halo=halo,
                                          axis_h="tile_h", batch_axis="data")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_TOL)
    glob = ops.filter_interp_warp(t(image), t(flow), t(filt))
    np.testing.assert_allclose(got.numpy(), glob.numpy(), rtol=0, atol=WARP_TOL)


def test_tiled_split_warp_keeps_sources_apart(rng):
    """Up to 4 sources go through one tile launch unconcatenated; the result
    is the JAX split warp's, which concatenates under tiling."""
    mesh, jm = mesh_1d()
    image, flow, filt = warp_inputs(rng, 2, 3, 32, 256, 16)
    ctx = rng.rand(2, 5, 32, 256).astype(np.float32)
    with jctx.spatial_tiling(jm, halo=16):
        want = jitted(lambda i, c, f, k: jwarp_split((i, c), f, k), image, ctx, flow, filt)
    got = tiling.tiled_filter_interp_warp_split(mesh, (t(image), t(ctx)), t(flow), t(filt),
                                                halo=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=WARP_TOL)


# -- the tiled projection --------------------------------------------------------


@pytest.mark.parametrize("fillhole", [False, True])
def test_tiled_project_matches_jax_and_global(rng, fillhole):
    mesh, jm = mesh_1d()
    B, H, W, halo = 2, 32, 256, 16
    flow = np.stack([(rng.rand(B, H, W) - 0.5) * 2 * (halo - 2),
                     (rng.rand(B, H, W) - 0.5) * 2 * 20], axis=1).astype(np.float32)
    want = jitted(lambda f: jtiling.tiled_flow_project(jm, f, halo=halo, fillhole=fillhole),
                  flow)
    got = tiling.tiled_flow_project(mesh, t(flow), halo=halo, fillhole=fillhole)
    assert_projection(got.numpy(), want)
    assert_projection(got.numpy(), ops.flow_project(t(flow), fillhole=fillhole).numpy())


@pytest.mark.parametrize("two_d", [False, True])
def test_tiled_project_counts_are_exact(rng, two_d):
    """The tiles' counts after the spill exchange are the global counts,
    exactly (sums of 1.0)."""
    mesh = (mesh_2d() if two_d else mesh_1d())[0]
    B, H, W = (2, 64, 128) if two_d else (2, 32, 256)
    flow = t(((rng.rand(B, 2, H, W) - 0.5) * 28.0).astype(np.float32))
    axis_h = "tile_h" if two_d else None
    _, cnt, ring = tiling._tiled_average(mesh, flow, 16, "tile", axis_h, None)
    _, _, want = project_kernel.sums_and_average(flow)
    assert torch.equal(ring.merge(cnt[:, None])[:, 0], want)


def test_tiled_project_fills_across_tiles(rng):
    """A hole in one tile fills from a projection in another (the carried
    searches)."""
    mesh, jm = mesh_1d()
    B, H, W = 1, 8, 256
    flow = np.zeros((B, 2, H, W), np.float32)
    flow[:, 1, :, 64:128] = 1000.0  # tile 1's pixels land nowhere
    want = jitted(lambda f: jtiling.tiled_flow_project(jm, f, halo=16, fillhole=True), flow)
    got = tiling.tiled_flow_project(mesh, t(flow), halo=16, fillhole=True)
    assert_projection(got.numpy(), want)
    assert_projection(got.numpy(), ops.flow_project(t(flow), fillhole=True).numpy())


def test_tiled_project_lands_where_the_global_op_lands():
    """The JAX tiled projection truncates the tile-local x + fx + halo, which
    can round across an integer where the frame's x0 + x + fx does not
    (x0 + x + fx = 218.0 in float32, x + fx + halo = 41.999992 in tile 3):
    it lands a pixel one cell off its own global op.  The port takes the
    frame's cell, so it equals the global op there."""
    mesh, jm = mesh_1d()
    rng = np.random.RandomState(0)
    for _ in range(2):  # the draws of test_tiled_warp_matches_jax_and_global
        warp_inputs(rng, 2, 3, 32, 256, 16)
    B, H, W, halo = 2, 32, 256, 16
    for _ in range(2):
        flow = np.stack([(rng.rand(B, H, W) - 0.5) * 2 * (halo - 2),
                         (rng.rand(B, H, W) - 0.5) * 2 * 20], axis=1).astype(np.float32)
    glob = np.asarray(jproject(flow, fillhole=True))
    jt = np.asarray(jitted(lambda f: jtiling.tiled_flow_project(jm, f, halo=halo,
                                                                 fillhole=True), flow))
    assert np.abs(jt - glob).max() > 1.0  # the JAX fault shows
    got = tiling.tiled_flow_project(mesh, t(flow), halo=halo, fillhole=True)
    assert_projection(got.numpy(), glob)


@pytest.mark.parametrize("fillhole", [False, True])
def test_tiled_project_2d_matches_jax_and_global(rng, fillhole):
    mesh, jm = mesh_2d()
    B, H, W = 2, 64, 128
    flow = (rng.rand(B, 2, H, W).astype(np.float32) - 0.5) * 20.0
    want = jitted(lambda f: jtiling.tiled_flow_project(
        jm, f, halo=16, fillhole=fillhole, axis_h="tile_h", batch_axis="data"), flow)
    got = tiling.tiled_flow_project(mesh, t(flow), halo=16, fillhole=fillhole, axis_h="tile_h",
                                    batch_axis="data")
    assert_projection(got.numpy(), want)
    assert_projection(got.numpy(), ops.flow_project(t(flow), fillhole=fillhole).numpy())


def test_tiled_project_2d_fills_down_across_tiles():
    """A hole in the bottom row of tiles fills from a projection that lives
    only in the top row (the up search carried over tile_h)."""
    mesh, jm = mesh_2d()
    B, H, W = 2, 64, 128
    flow = np.zeros((B, 2, H, W), np.float32)
    flow[:, 0] = -np.arange(W)[None, None, :] % 7
    flow[:, 1] = np.clip(-np.arange(H)[None, :, None] + 5.0, -14.0, 14.0)
    want = jitted(lambda f: jtiling.tiled_flow_project(
        jm, f, halo=16, fillhole=True, axis_h="tile_h", batch_axis="data"), flow)
    got = tiling.tiled_flow_project(mesh, t(flow), halo=16, fillhole=True, axis_h="tile_h")
    assert_projection(got.numpy(), want)
    assert_projection(got.numpy(), ops.flow_project(t(flow), fillhole=True).numpy())


def test_tiled_project_rejects_tiles_under_twice_the_halo():
    mesh, _ = mesh_1d()
    with pytest.raises(ValueError, match="twice the halo"):
        tiling.tiled_flow_project(mesh, torch.zeros(1, 2, 8, 128), halo=32)


# -- the dispatch under spatial_tiling ---------------------------------------------


@pytest.mark.parametrize("op", ["filter_interp_warp", "filter_interp_warp_split",
                                "flow_project"])
@pytest.mark.parametrize("two_d", [False, True])
def test_ops_dispatch_under_spatial_tiling_as_jax(rng, op, two_d):
    mesh, jm = mesh_2d() if two_d else mesh_1d()
    H, W = (64, 128) if two_d else (32, 256)
    kw = dict(halo=16, axis_h="tile_h" if two_d else None)
    image, flow, filt = warp_inputs(rng, 2, 3, H, W, 16)
    ctx = rng.rand(2, 4, H, W).astype(np.float32)
    calls = {"filter_interp_warp": (lambda m, a: m.filter_interp_warp(a[0], a[2], a[3]),
                                    jwarp),
             "filter_interp_warp_split": (
                 lambda m, a: m.filter_interp_warp_split((a[0], a[1]), a[2], a[3]),
                 jwarp_split),
             "flow_project": (lambda m, a: m.flow_project(a[2], fillhole=True), jproject)}
    call, _ = calls[op]

    class JaxOps:
        filter_interp_warp = staticmethod(jwarp)
        filter_interp_warp_split = staticmethod(jwarp_split)
        flow_project = staticmethod(jproject)

    arrays = (image, ctx, flow, filt)
    with jctx.spatial_tiling(jm, **kw):
        want = jitted(lambda *a: call(JaxOps, a), *arrays)
    with spatial_tiling(mesh, **kw):
        got = call(ops, [t(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # outside the context the global op runs again
    out = call(ops, [t(a) for a in arrays])
    assert len(out if isinstance(out, tuple) else (out,)) == len(got)


def test_fix_down_scan_bug_raises_under_tiling():
    mesh, _ = mesh_1d()
    flow = torch.zeros(1, 2, 8, 256)
    with spatial_tiling(mesh, halo=16):
        with pytest.raises(NotImplementedError):
            ops.flow_project(flow, fillhole=True, fix_down_scan_bug=True)
    ops.flow_project(flow, fillhole=True, fix_down_scan_bug=True)  # global: runs


# -- gradients -------------------------------------------------------------------


def _grads(fn, inputs, cot):
    xs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, xs, cot)


@pytest.mark.parametrize("two_d", [False, True])
def test_tiled_warp_gradients_match_global(rng, two_d):
    """Within the halo budget the tile-local warp's gradients (through the
    halo exchange and its ring shifts) equal autograd of the global op."""
    mesh = (mesh_2d() if two_d else mesh_1d())[0]
    H, W = (32, 128) if two_d else (16, 256)
    image, flow, filt = (t(a) for a in warp_inputs(rng, 2, 3, H, W, 16))
    ctx = t(rng.rand(2, 4, H, W).astype(np.float32))
    cot = [t(rng.randn(2, c, H, W).astype(np.float32)) for c in (3, 4)]
    axis_h = "tile_h" if two_d else None
    got = _grads(lambda im, cx, fl, fi: tiling.tiled_filter_interp_warp_split(
        mesh, (im, cx), fl, fi, halo=16, axis_h=axis_h), [image, ctx, flow, filt], cot)
    want = _grads(lambda im, cx, fl, fi: ops.filter_interp_warp_split((im, cx), fl, fi),
                  [image, ctx, flow, filt], cot)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("two_d", [False, True])
def test_tiled_project_gradient_matches_global(rng, two_d):
    mesh = (mesh_2d() if two_d else mesh_1d())[0]
    B, H, W = (2, 64, 128) if two_d else (2, 16, 256)
    flow = t(((rng.rand(B, 2, H, W) - 0.5) * 20.0).astype(np.float32))
    cot = [t(rng.randn(B, 2, H, W).astype(np.float32))]
    axis_h = "tile_h" if two_d else None
    for fill in (False, True):
        (got,) = _grads(lambda f: tiling.tiled_flow_project(
            mesh, f, halo=16, fillhole=fill, axis_h=axis_h), [flow], cot)
        (want,) = _grads(lambda f: ops.flow_project(f, fillhole=fill), [flow], cot)
        assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
        assert float(want.abs().max()) > 0.1


def test_parallel_modules_do_not_import_jax():
    """The port's parallel layer imports nothing of JAX or the JAX package."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "memcnet_tpu_torch" / "parallel"
    files = sorted(root.glob("*.py"))
    assert {f.name for f in files} >= {"context.py", "mesh.py", "tiling.py", "ring.py",
                                       "zero.py", "step.py", "gop.py"}
    for f in files:
        tree = ast.parse(f.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m and m.split(".")[0] in ("jax", "memcnet_tpu")], f
