"""ZeRO-1 Adamax: the optimizer state sharded over every rank of a mesh
(the port of memcnet_tpu/parallel/mesh.py::zero1_sharding as the JAX
package's sharded step uses it).

In the JAX package GSPMD compiles an update whose state is placed by
``zero1_sharding`` into reduce-scatter(gradients), a per-shard Adamax and
all-gather(parameters).  ``ZeroAdamax`` does the same by hand: each rank
keeps ``mu`` and ``nu`` for its shard of each parameter only, by
``zero1_partition`` (the largest dim the rank count divides evenly, else the
whole parameter on every rank).  Per step:

  1. the gradients come averaged over the data axis (DDP averages them in
     ``parallel.step.DataParallelStep``; the ranks of a tile line hold the
     same ones), so every rank holds the whole batch's gradient;
  2. it clips by the norm of the whole gradient, the same on every rank;
  3. it updates its slice with ``Adamax``'s own arithmetic (optax's numbers,
     element for element);
  4. it all-gathers the parameters.

``state_dict`` gathers the whole state, so a checkpoint written by N ranks
loads into one process (``train.trainer.Adamax``) and back; ``load_state_dict``
slices it again.  ``torch.distributed.optim.ZeroRedundancyOptimizer`` wraps
only ``torch.optim`` classes and partitions whole parameters, so it serves
neither the port's Adamax nor the JAX rule.
"""

import torch
import torch.distributed as dist

from memcnet_tpu_torch.parallel.mesh import zero1_partition
from memcnet_tpu_torch.train.trainer import Adamax


class ZeroAdamax(Adamax):
    """``Adamax`` whose state holds this rank's shard of each parameter.

    Args:
      params: an ``nn.Module`` or a {name: tensor} dict, the same on every
        rank.
      group: the torch.distributed group the state is sharded over (every
        rank of the mesh); None for one process.
      **kw: ``Adamax``'s options.
    """

    def __init__(self, params, group=None, **kw):
        super().__init__(params, **kw)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.dims = [zero1_partition(tuple(p.shape), self.world) for p in self.params]
        self.mu = [torch.zeros_like(self._shard(p, i)) for i, p in enumerate(self.params)]
        self.nu = [torch.zeros_like(m) for m in self.mu]

    def _shard(self, t, i):
        d = self.dims[i]
        if d is None:
            return t
        k = t.shape[d] // self.world
        return t.narrow(d, self.rank * k, k)

    def _gather(self, shard, i):
        d = self.dims[i]
        if d is None or self.world == 1:
            return shard
        parts = [torch.empty_like(shard) for _ in range(self.world)]
        dist.all_gather(parts, shard.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def _whole(self, state, i):
        return self._gather(state, i)

    def _local(self, state, i):
        return self._shard(state, i)

    @torch.no_grad()
    def step(self, loss=None):
        """One update from the parameters' gradients, the whole batch's on
        every rank; ``loss`` must be the whole batch's too, as the plateau
        reads it."""
        u = self._gradients()
        self._update([self._shard(p, i) for i, p in enumerate(self.params)],
                     [self._shard(g, i) for i, g in enumerate(u)], loss)
        for i, p in enumerate(self.params):
            if self.dims[i] is not None and self.world > 1:
                p.copy_(self._gather(self._shard(p, i), i))
