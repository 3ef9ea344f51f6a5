"""Data-parallel and sharded train steps (the port of the JAX package's
sharded step, ``__graft_entry__.py::dryrun_multichip``).

``DataParallelStep`` is ``train.trainer.TrainStep`` over the ranks of a
data group: each rank runs the step on its slice of the batch;
``DistributedDataParallel`` averages the gradients over the group (gloo on
the CPU, NCCL on cards); train-mode BatchNorm reduces its statistics over
the group (``parallel.data_parallel``); and the loss the optimizer's plateau
reads and the step returns is the whole batch's, all-reduced, so the ranks'
plateaus never drift apart.  ``residual_loss`` is a mean, so with equal
slices the averaged gradients are the whole batch's.

``sharded_train_step`` is ``dryrun_multichip``: one MEMC_Net_star train step
on a (data, tile) mesh, or (data, tile_h, tile) when the mesh has a multiple
of 4 positions, with 64 px per tile and axis, under ``spatial_tiling(mesh,
halo=16)``, its frames placed sharded (``shard_frames``) as the dryrun
places them with ``frame_sharding``: every layer runs on its tile with halos
(``parallel.partition``), the warp and the projection on their tile-local
steps.  Where the mesh lives across ranks, DDP averages the gradients over
every rank of it: each rank's loss is its data slice's, all-reduced over
its tile lines, whose backward scales the gradient by the tile count, so the
average is the whole batch's (``train.loss``); ``ZeroAdamax`` shards the
optimizer over every rank.  Where every axis lives in this process the same
step runs in one process, its tiles stacked into the batch.
"""

import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from torch.profiler import record_function

from memcnet_tpu_torch.parallel.context import data_parallel, spatial_tiling
from memcnet_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, mesh_barrier, shard_frames
from memcnet_tpu_torch.parallel.zero import ZeroAdamax
from memcnet_tpu_torch.train.trainer import TrainStep, interp_loss_fn

TILE_PX = 64       # pixels per tile and axis (__graft_entry__.py:102-108)
SHARDED_HALO = 16  # the dryrun's halo: larger than the filter, small at 64 px a tile


class _Objective(torch.nn.Module):
    """A model and its loss function as one module, for DDP."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *inputs):
        return self.loss_fn(*inputs)


class DataParallelStep(TrainStep):
    """``TrainStep`` on this rank's slice of the batch, over the ranks of
    ``group``: gradients averaged by DDP, BatchNorm statistics and the
    returned loss over the whole batch.  ``loss_fn`` must compute with
    ``model``'s parameters (it is wrapped with the model into the module DDP
    runs)."""

    def __init__(self, model, optimizer, loss_fn, group, device="cuda"):
        super().__init__(model, optimizer, loss_fn, device)
        self.group = group
        self.size = dist.get_world_size(group)
        ids = [self.device.index or 0] if self.device.type == "cuda" else None
        # find_unused_parameters: MEMC_Net_star's ctx conv takes no gradient;
        # broadcast_buffers off: the synced BatchNorm keeps the running
        # statistics equal on every rank (newer torch names the option
        # forward_sync_buffers and warns about the old name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self.ddp = DistributedDataParallel(_Objective(model, loss_fn), device_ids=ids,
                                               process_group=group, find_unused_parameters=True,
                                               broadcast_buffers=False)

    def __call__(self, *inputs):
        inputs = [self._input(x) for x in inputs]
        self.model.train()
        self.optimizer.zero_grad()
        with data_parallel(self.group):
            with record_function("train_step.forward"):
                loss = self.ddp(*inputs)
            with record_function("train_step.backward"):
                loss.backward()
        whole = loss.detach().clone()
        dist.all_reduce(whole, group=self.group)
        whole /= self.size
        with record_function("train_step.optimizer"):
            self.optimizer.step(whole)
        return whole


def sharded_mesh(*, devices=None, group=None):
    """The dryrun's mesh over the positions of ``devices`` (in this process)
    or the ranks of ``group``: (data, tile_h 2, tile 2) when 4 divides their
    count, else (data, tile) with at most 2 tiles.  Returns (mesh, the H tile
    axis or None)."""
    n = dist.get_world_size(group) if group is not None else len(devices)
    if n % 4 == 0:
        return make_mesh_2d(n, tile_h=2, tile_w=2, devices=devices, group=group), "tile_h"
    return make_mesh(n, max_tile=2, devices=devices, group=group), None


def sharded_frames(mesh, seed=0):
    """The dryrun's whole batch (x0, x1, x2): one sample per data position,
    64 px per tile and axis, uniform in [0, 1) from a numpy seed."""
    B = mesh.shape["data"]
    H = TILE_PX * mesh.shape.get("tile_h", 1)
    W = TILE_PX * mesh.shape["tile"]
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(B, 3, H, W).astype(np.float32) for _ in range(3))


def sharded_train_step(mesh, axis_h, frames, *, seed=0, lr=2e-3, device="cuda"):
    """One MEMC_Net_star train step on ``mesh`` (``sharded_mesh``) over the
    whole batch ``frames`` (x0, x1, x2): under ``spatial_tiling(mesh,
    halo=16)``, the frames sharded into this process's stacked tiles or this
    rank's tile of its data slice, DDP over every rank where the mesh lives
    across ranks, ZeRO-1 Adamax (optax's ``adamax(lr)``) over every rank.
    Returns (the whole batch's loss, the model, the optimizer)."""
    from memcnet_tpu_torch.cli.runner import build_model

    model = build_model("MEMC_Net_star", seed=seed, device=device)
    opt = ZeroAdamax(model, mesh.group, lr=lr)
    loss_fn = interp_loss_fn(model)
    if mesh.group is not None:
        step = DataParallelStep(model, opt, loss_fn, mesh.group, device)
    else:
        step = TrainStep(model, opt, loss_fn, device)
    mesh_barrier(mesh)
    with spatial_tiling(mesh, halo=SHARDED_HALO, axis_h=axis_h):
        loss = step(*shard_frames(mesh, *(torch.from_numpy(f) for f in frames)))
    if not torch.isfinite(loss):
        raise FloatingPointError(f"the sharded step's loss is not finite: {float(loss)}")
    return loss, model, opt
