"""The caching allocator's cudaMalloc and cudaFree calls a forward
(``num_device_alloc + num_device_free`` across each ``memc.forward``): the
program's ``cuda_allocs`` counter over the traced window.  Each such call
can hold the host until the card is idle."""

from benchmark import stages


def read(r):
    return stages.counter_ratio("cuda_allocs")
