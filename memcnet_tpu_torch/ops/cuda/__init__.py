"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper module each.

Each module keeps its kernel's launch wrapper, the plain PyTorch version of
the same function, an ``autograd.Function`` whose backward is autograd of
the plain version, and a launch counter per kernel.  A wrapper launches its
kernel on CUDA tensors (or raises) and takes the plain version only for CPU
tensors.

  warp_kernel     K1  filter-interpolation warp   (csrc/warp.cu)
  project_kernel  K2  projection scatter, folds and divide, and its payload
                      entry for the depth-weighted and gated projections,
                      which builds their payloads inside the scatter
                  K3  projection hole fill, with the down search on request
                                                            (csrc/project.cu)
  conv_kernel     K4  small-C conv on the tensor cores: bf16 (csrc/conv.cu),
                      float32 in three TF32 passes (csrc/conv_f32.cu)
  gather_kernel   K5  bilinear grid sample, and SPyNet's level input around it
                      in one launch               (csrc/gather.cu)

and the tile entries of the tiled warp and projection (parallel/tiling.py):
K1's (``warp_kernel.warp_tile``), K2's (``project_kernel.tile_sums``) and
K3's (``project_kernel.tile_fill``: the whole tiled fill), and of SPyNet's
level input on partitioned frames (parallel/partition.py): K5's
(``gather_kernel.level_input_tile``), and of the depth-weighted and gated
projections on partitioned frames: K2's payload entry on tile origins
(``project_kernel.payload_tile``), each with its own counter.  K4's float32
body also counts its own launches (``conv_kernel.f32_counter``, read by
``body_counts``; ``launch_counts`` counts them under K4).
"""

from memcnet_tpu_torch.ops.cuda import (
    conv_kernel,
    gather_kernel,
    project_kernel,
    warp_kernel,
)

COUNTERS = (warp_kernel.counter, project_kernel.scatter_counter, project_kernel.fill_counter,
            conv_kernel.counter, gather_kernel.counter, warp_kernel.tile_counter,
            project_kernel.tile_scatter_counter, project_kernel.carry_counter,
            gather_kernel.tile_counter, project_kernel.payload_tile_counter)


# launches of one body of a kernel, also counted in that kernel's counter
BODY_COUNTERS = (conv_kernel.f32_counter,)


def reset_counters():
    for c in COUNTERS + BODY_COUNTERS:
        c.reset()


def launch_counts():
    return {c.name: c.count for c in COUNTERS}


def body_counts():
    return {c.name: c.count for c in BODY_COUNTERS}
