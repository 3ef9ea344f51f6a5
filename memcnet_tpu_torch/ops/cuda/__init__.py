"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper module each.

Each module keeps its kernel's launch wrapper, the plain PyTorch version of
the same function, an ``autograd.Function`` whose backward is autograd of
the plain version, and a launch counter per kernel.  A wrapper launches its
kernel on CUDA tensors (or raises) and takes the plain version only for CPU
tensors.

  warp_kernel     K1  filter-interpolation warp   (csrc/warp.cu)
  project_kernel  K2  projection scatter, folds and divide  (csrc/project.cu)
                  K3  projection hole fill                  (csrc/project.cu)
  conv_kernel     K4  small-C conv: bf16 on tensor cores, float32 direct  (csrc/conv.cu)
  gather_kernel   K5  bilinear grid sample, and SPyNet's level input around it
                      in one launch               (csrc/gather.cu)
"""

from memcnet_tpu_torch.ops.cuda import (
    conv_kernel,
    gather_kernel,
    project_kernel,
    warp_kernel,
)

COUNTERS = (warp_kernel.counter, project_kernel.scatter_counter, project_kernel.fill_counter,
            conv_kernel.counter, gather_kernel.counter)


def reset_counters():
    for c in COUNTERS:
        c.reset()


def launch_counts():
    return {c.name: c.count for c in COUNTERS}
