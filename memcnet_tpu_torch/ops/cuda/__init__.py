"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper module each.

Each module keeps its kernel's launch wrapper, the plain PyTorch version of
the same function, an ``autograd.Function`` whose backward is autograd of
the plain version, and a launch ``counter``.  A wrapper launches its kernel
on CUDA tensors (or raises) and takes the plain version only for CPU tensors.

  warp_kernel     K1  filter-interpolation warp   (csrc/warp.cu)
  scatter_kernel  K2  projection base scatter     (csrc/scatter.cu)
  fill_kernel     K3  projection hole fill        (csrc/fill.cu)
  conv_kernel     K4  small-C conv: bf16 on tensor cores, float32 direct  (csrc/conv.cu)
  gather_kernel   K5  bilinear grid sample        (csrc/gather.cu)
"""

from memcnet_tpu_torch.ops.cuda import (
    conv_kernel,
    fill_kernel,
    gather_kernel,
    scatter_kernel,
    warp_kernel,
)

KERNELS = (warp_kernel, scatter_kernel, fill_kernel, conv_kernel, gather_kernel)


def reset_counters():
    for k in KERNELS:
        k.counter.reset()


def launch_counts():
    return {k.counter.name: k.counter.count for k in KERNELS}
