"""Flow projection to the intermediate time step (port of
memcnet_tpu/ops/projection.py::flow_project).

Reference semantics (my_lib_kernel.cu:1630-1836, as the JAX package pins
them): each source pixel p with flow f lands at x2 = p + f; if
0 <= x2 <= W-1 and 0 <= y2 <= H-1 it adds -f and a count of 1 to its four
integer neighbours, the right/bottom ones clamped to the border (a clamped
cell receives the contribution twice).  The sums are divided by the count
where it is > 0.  With ``fillhole`` (eval only), count-0 pixels take the mean
of the nearest projected value to the left, right and above; the down-scan is
dead in the reference and only ``fix_down_scan_bug=True`` enables it, on CPU
tensors only.

The four neighbours are the base cell plus constant offsets, so only the
base scatter is a scatter: the other three are border folds of its result.
On CUDA tensors the whole op is one autograd.Function over kernels K2
(scatter, folds, divide) and K3 (fill), at most four device operations
(ops/cuda/project_kernel.py, csrc/project.cu); on CPU tensors it is the plain
composition ``reference``.  Coordinates, sums and the fill are float32
whatever the flow's type; the result is cast back to it once.
"""

from memcnet_tpu_torch.ops.cuda import project_kernel


def project(flow, *, fillhole=False, fix_down_scan_bug=False):
    """Plain float32 (projected flow (B, 2, H, W), count (B, H, W))."""
    return project_kernel.average_and_count(flow, fillhole, fix_down_scan_bug)


def reference(flow, *, fillhole=False, fix_down_scan_bug=False):
    """The plain composition of ``flow_project``, on any device."""
    return project_kernel.reference(flow, fillhole, fix_down_scan_bug)


def flow_project(flow, *, fillhole=False, fix_down_scan_bug=False):
    """Project forward flow F_{t->t+1} (B, 2, H, W) to time t (negated
    average scatter).  Returns (B, 2, H, W) in the flow's type."""
    return project_kernel.flow_project(flow, fillhole, fix_down_scan_bug)
