"""The ranks of tests/test_torch_multiprocess.py: each scenario runs in
``world`` processes joined over gloo on the CPU, each rank writing its
results to ``<out>/rank<r>.pt`` for the test to hold against one process.

    python tests/torch_mp_workers.py <scenario> <rank> <world> <port> <out>

Scenarios: ``four`` (4 ranks: the ring-shift tiled ops, the partitioned
MEMC_Net_star and MEMC_Net_s forwards, three ops of the op library on
partitioned frames, then the sharded MEMC_Net_star step) and ``dp`` (2
ranks: the data-parallel MEMC_Net steps).

Imports torch and memcnet_tpu_torch only.
"""

import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from memcnet_tpu_torch.parallel import (gather_frames, make_mesh, make_mesh_2d,  # noqa: E402
                                        shard_frames, spatial_tiling, tiling)

DP_SIZE = (64, 128)   # the data-parallel MEMC_Net step: B 2 (one sample per rank)
DP_LR = 1e-4
# the ring scenario's meshes: (name, factory, frame size, H tile axis)
RING_MESHES = (("tile4", lambda **kw: make_mesh(4, max_tile=4, **kw), (16, 256), None),
               ("data2_tile2", lambda **kw: make_mesh(4, max_tile=2, **kw), (16, 256), None),
               ("tile2x2", lambda **kw: make_mesh_2d(4, **kw), (64, 128), "tile_h"))
# the partitioned forward's meshes: (name, factory, frame size, H tile axis); at
# 64x320 the 1/64 level's 5 columns split 2, 1, 1, 1, at 128x192 its 3 split 2, 1
PART_MESHES = (("tile4", RING_MESHES[0][1], (64, 320), None),
               ("tile2x2", RING_MESHES[2][1], (128, 192), "tile_h"))
PART_FLOW_PX = 3.0  # star's flows scaled to about this, inside the halo budget of 16
# MEMC_Net_s partitioned on (1, 4) across ranks: SPyNet's 4 levels at 64x256, each
# with a whole-level all-gather of the second frame
PART_S_SIZE = (64, 256)
# the op library on partitioned frames across ranks: B 2 on (1, 4), flows of up
# to 20 px (across tiles; no halo budget)
OPLIB_SIZE = (64, 256)
OPLIB_CALLS = (("depth_flow_project", ("flow", "depth"), ("g2",)),
               ("pixel_splat", ("image", "flow", "fw"), ("g3", "g1")),
               ("bilinear_warp", ("image", "flow"), ("g3",)))
SHARDED_LR = 2e-3   # the dryrun's Adamax
STEP_TOL = 1e-6


def ring_inputs(H, W, seed=0):
    """Whole-frame inputs of the ring scenario (B 2): image, context, flow
    within the halo budget of 16, filter, and cotangents."""
    rng = np.random.RandomState(seed)
    x = {"image": rng.rand(2, 3, H, W), "ctx": rng.rand(2, 4, H, W),
         "flow": (rng.rand(2, 2, H, W) - 0.5) * 20.0, "filt": rng.rand(2, 16, H, W),
         "g_image": rng.randn(2, 3, H, W), "g_ctx": rng.randn(2, 4, H, W),
         "g_flow": rng.randn(2, 2, H, W)}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in x.items()}


def ring_run(mesh, axis_h, x, rows=slice(None)):
    """The tiled warp (split, two sources) and projection (fill off and on)
    of the inputs' ``rows`` of the batch, with their input gradients."""
    kw = dict(halo=16, axis_h=axis_h)
    image, ctx, flow, filt = (x[k][rows].clone().requires_grad_(True)
                              for k in ("image", "ctx", "flow", "filt"))
    warped = tiling.tiled_filter_interp_warp_split(mesh, (image, ctx), flow, filt, **kw)
    out = {"warp_image": warped[0].detach(), "warp_ctx": warped[1].detach()}
    grads = torch.autograd.grad(warped, (image, ctx, flow, filt),
                                (x["g_image"][rows], x["g_ctx"][rows]))
    out.update({f"warp_grad_{k}": g for k, g in zip(("image", "ctx", "flow", "filt"), grads)})
    for fill in (False, True):
        f = x["flow"][rows].clone().requires_grad_(True)
        p = tiling.tiled_flow_project(mesh, f, fillhole=fill, **kw)
        out[f"project_{fill}"] = p.detach()
        out[f"project_grad_{fill}"] = torch.autograd.grad(p, f, x["g_flow"][rows])[0]
    return out


def scenario_ring(rank, world):
    res = {}
    for name, factory, (H, W), axis_h in RING_MESHES:
        mesh = factory(group=dist.group.WORLD)
        d = mesh.shape["data"]
        r = mesh.coords["data"]
        rows = slice(r * 2 // d, (r + 1) * 2 // d)
        res[name] = ring_run(mesh, axis_h, ring_inputs(H, W), rows)
    return res


@functools.lru_cache(maxsize=1)
def part_model():
    from memcnet_tpu_torch.cli.runner import build_model

    model = build_model("MEMC_Net_star", seed=0, device="cpu")
    return model, model.flownets.predict_flow2.weight.detach().clone()


def part_inputs(H, W, seed=4):
    """The partitioned forward's frames (B 2) and MEMC_Net_star, its
    FlowNetS last conv scaled to give flows of about PART_FLOW_PX."""
    rng = np.random.RandomState(seed)
    x0 = torch.from_numpy(rng.rand(2, 3, H, W).astype(np.float32))
    x2 = torch.roll(x0, (1, 2), (2, 3)) * 0.9 + 0.05
    model, weight = part_model()
    with torch.no_grad():
        model.flownets.predict_flow2.weight.copy_(weight)
        raw = float(model._flow(x0, x2).abs().max())
        model.flownets.predict_flow2.weight.mul_(PART_FLOW_PX / raw)
    return model, x0, x2


def part_run(mesh, axis_h, H, W):
    """The partitioned star forward: its rectified frame and first offset,
    gathered whole."""
    model, x0, x2 = part_inputs(H, W)
    with torch.no_grad(), spatial_tiling(mesh, halo=16, axis_h=axis_h):
        (_, rectified), offs, _, _ = model(*shard_frames(mesh, x0, x2))
        return {"rectified": gather_frames(mesh, rectified),
                "offset0": gather_frames(mesh, offs[0])}


@functools.lru_cache(maxsize=1)
def part_s_inputs(seed=7):
    """MEMC_Net_s, its SPyNet top-level (coarsest) last conv scaled to give
    flows of about PART_FLOW_PX, and its frames (B 2)."""
    from memcnet_tpu_torch.cli.runner import build_model

    rng = np.random.RandomState(seed)
    x0 = torch.from_numpy(rng.rand(2, 3, *PART_S_SIZE).astype(np.float32))
    x2 = torch.roll(x0, (1, 2), (2, 3)) * 0.9 + 0.05
    model = build_model("MEMC_Net_s", seed=0, device="cpu")
    top = model.flownets.moduleBasic[0].moduleBasic[8]
    with torch.no_grad():
        for _ in range(3):  # not linear in the scale: the finer levels' warps move
            raw = float(model._flow(x0, x2).abs().max())
            top.weight.mul_(PART_FLOW_PX / raw)
            top.bias.mul_(PART_FLOW_PX / raw)
    return model, x0, x2


def part_s_run(mesh):
    """The partitioned MEMC_Net_s forward on (1, 4): its rectified frame and
    first offset, gathered whole."""
    model, x0, x2 = part_s_inputs()
    with torch.no_grad(), spatial_tiling(mesh, halo=16):
        (_, rectified), offs, _, _ = model(*shard_frames(mesh, x0, x2))
        return {"rectified": gather_frames(mesh, rectified),
                "offset0": gather_frames(mesh, offs[0])}


def scenario_partition(rank, world):
    res = {name: part_run(factory(group=dist.group.WORLD), axis_h, H, W)
           for name, factory, (H, W), axis_h in PART_MESHES}
    res["MEMC_Net_s"] = part_s_run(make_mesh(4, group=dist.group.WORLD))
    return res


def oplib_inputs(seed=9):
    """The op library's whole inputs (B 2) and cotangents."""
    rng = np.random.RandomState(seed)
    H, W = OPLIB_SIZE
    x = {"image": rng.rand(2, 3, H, W), "flow": (rng.rand(2, 2, H, W) - 0.5) * 40.0,
         "depth": np.round(rng.rand(2, 1, H, W) * 4) / 4 + 0.25, "fw": rng.rand(2, 1, H, W),
         "g3": rng.randn(2, 3, H, W), "g2": rng.randn(2, 2, H, W), "g1": rng.randn(2, 1, H, W)}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in x.items()}


def oplib_run(mesh, x):
    """depth_flow_project (with the fill), pixel_splat and bilinear_warp on
    frames sharded over ``mesh`` (untiled where it is None): each op's
    outputs gathered whole and the gradients of its whole inputs."""
    from memcnet_tpu_torch import ops

    fns = {"depth_flow_project": lambda f, d: ops.depth_flow_project(f, d, fillhole=True),
           "pixel_splat": ops.pixel_splat, "bilinear_warp": ops.bilinear_warp}
    res = {}
    for name, keys, cot_keys in OPLIB_CALLS:
        ins = [x[k].clone().requires_grad_(True) for k in keys]
        if mesh is None:
            out = fns[name](*ins)
        else:
            with spatial_tiling(mesh, halo=16):
                tiles = shard_frames(mesh, *ins)
                out = fns[name](*(tiles if isinstance(tiles, tuple) else (tiles,)))
                out = tuple(gather_frames(mesh, o) for o in
                            (out if isinstance(out, tuple) else (out,)))
        out = out if isinstance(out, tuple) else (out,)
        res[name] = [o.detach() for o in out]
        res[name + "_grads"] = list(torch.autograd.grad(out, ins, [x[k] for k in cot_keys]))
    return res


def step_stats(got, want):
    """How far a step's state dict ``got`` is from ``want``, over the
    parameters: (share of elements within STEP_TOL, largest difference)."""
    total = close = 0
    worst = 0.0
    for k, w in want.items():
        if "running_" in k or "num_batches" in k:
            continue
        d = (got[k].float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        close += int((d <= STEP_TOL).sum())
    return close / total, worst


def state_sums(model):
    """Per-tensor float64 sums of the model's state: equal on every rank."""
    return torch.stack([v.double().sum() for v in model.state_dict().values()])


def dp_batches(seed=0):
    """Two whole batches (x0, x1, x2) of the data-parallel scenario."""
    rng = np.random.RandomState(seed)
    return [tuple(torch.from_numpy(rng.rand(2, 3, *DP_SIZE).astype(np.float32))
                  for _ in range(3)) for _ in range(2)]


def scenario_dp(rank, world, out):
    """Two data-parallel MEMC_Net steps (BatchNorm synced, DDP, ZeRO-1
    Adamax) on this rank's sample of batches 0 and 1; rank 0 writes the
    gathered checkpoint after the first and the model after the second."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.io import checkpoint
    from memcnet_tpu_torch.parallel.step import DataParallelStep
    from memcnet_tpu_torch.train.trainer import interp_loss_fn
    from memcnet_tpu_torch.parallel.zero import ZeroAdamax

    model = build_model("MEMC_Net", seed=0, device="cpu")
    opt = ZeroAdamax(model, dist.group.WORLD, lr=DP_LR)
    step = DataParallelStep(model, opt, interp_loss_fn(model), dist.group.WORLD, device="cpu")
    batches = [[t[rank:rank + 1] for t in batch] for batch in dp_batches()]
    loss = step(*batches[0])
    state = opt.state_dict()  # a collective: every rank gathers
    if rank == 0:  # the whole model and optimizer state once; the sums from every rank
        checkpoint.save(os.path.join(out, "zero1.pt"), model, opt_state=state, step=1)
    again = ZeroAdamax(model, dist.group.WORLD, lr=DP_LR)
    again.load_state_dict(state)  # the whole state sliced back to this rank's shards
    res = {"loss": loss, "sums": state_sums(model),
           "state_numel": sum(m.numel() for m in opt.mu),
           "whole_numel": sum(p.numel() for p in model.parameters()),
           "reloaded_equal": again.count == opt.count and all(
               torch.equal(a, b) for a, b in zip(opt.mu + opt.nu, again.mu + again.nu))}
    del again
    res["loss_2"] = step(*batches[1])
    if rank == 0:
        torch.save(model.state_dict(), os.path.join(out, "after_two.pt"))
    return res


def scenario_sharded(rank, world):
    """The dryrun's sharded MEMC_Net_star step on 4 ranks, (1, 2, 2), its
    frames partitioned; rank 1 then takes the same step in one process (the
    tiles stacked) and compares the parameters, and rank 0 the untiled step
    (TrainStep, Adamax) on the whole batch and compares the loss and the
    gradients (every rank ends the step with the same model)."""
    from memcnet_tpu_torch.cli.runner import build_model
    from memcnet_tpu_torch.parallel.step import sharded_frames, sharded_mesh, sharded_train_step
    from memcnet_tpu_torch.train.trainer import Adamax, TrainStep, interp_loss_fn

    mesh, axis_h = sharded_mesh(group=dist.group.WORLD)
    frames = sharded_frames(mesh)
    loss, model, opt = sharded_train_step(mesh, axis_h, frames, lr=SHARDED_LR, device="cpu")
    res = {"loss": loss, "mesh": dict(mesh.shape), "sums": state_sums(model),
           "state_numel": sum(m.numel() for m in opt.mu),
           "whole_numel": sum(p.numel() for p in model.parameters())}
    if rank == 1:
        stacked_mesh, stacked_h = sharded_mesh(devices=[torch.device("cpu")] * world)
        _, stacked, _ = sharded_train_step(stacked_mesh, stacked_h, frames, lr=SHARDED_LR,
                                           device="cpu")
        res["close_share"], res["max_abs"] = step_stats(model.state_dict(), stacked.state_dict())
    if rank == 0:
        grads = subnet_grads(model)
        ref = build_model("MEMC_Net_star", seed=0, device="cpu")
        res["ref_loss"] = TrainStep(ref, Adamax(ref, lr=SHARDED_LR), interp_loss_fn(ref),
                                    "cpu")(*frames)
        res["grad_errs"] = subnet_grad_errs(grads, subnet_grads(ref))
    return res


def subnet_grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()
            if p.grad is not None}


def subnet_grad_errs(got, want):
    """Per subnet (the parameter name's first part): the largest |got -
    want| and the largest |want|."""
    out = {}
    for k, w in want.items():
        err, top = out.get(k.split(".")[0], (0.0, 0.0))
        out[k.split(".")[0]] = (max(err, float((got[k] - w).abs().max())),
                                max(top, float(w.abs().max())))
    return out


def main():
    scenario, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)  # the ranks share the host's cores with each other
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        if scenario == "four":  # the ring, then the sharded step, on 4 ranks
            res = {"ring": scenario_ring(rank, world),
                   "partition": scenario_partition(rank, world),
                   "oplib": oplib_run(make_mesh(4, group=dist.group.WORLD), oplib_inputs()),
                   "sharded": scenario_sharded(rank, world)}
        elif scenario == "dp":
            res = scenario_dp(rank, world, out)
        else:
            raise ValueError(scenario)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
