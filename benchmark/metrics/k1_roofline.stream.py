"""K1's share of its roofline, %: the least time of its launches in the
traced window (``counts.k1``: bytes at 3.35 TB/s or operations at the CUDA
cores' float32 peak, the larger) over its device time there."""

from benchmark import peaks

KERNEL = "memc::filter_interp_warp_kernel"


def read(r):
    if r.trace is None or not r.trace.forwards:
        return None
    busy = r.trace.seconds_of(lambda n: KERNEL in n)
    if not busy:
        return None
    h, w = r.padded
    esize = 2 if r.config["dtype"] == "bfloat16" else 4
    least = peaks.least_seconds(r.counts.kernels(r.batch, h, w, esize)["k1"])
    return 100.0 * least * r.trace.forwards / busy
