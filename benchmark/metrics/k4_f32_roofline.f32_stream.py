"""K4's float32 body's share of its roofline, %: the least time of the
float32 convs it runs in the traced window (``counts.k4``: the algorithm's
multiply-adds at the TF32 rate, 495 TFLOP/s, or the bytes at 3.35 TB/s,
the larger; not the three passes the body makes) over its device time."""

from benchmark import peaks

KERNEL = "memc::conv2d_tf32x3"


def read(r):
    if r.trace is None or not r.trace.forwards or r.config["dtype"] != "float32":
        return None
    busy = r.trace.seconds_of(lambda n: KERNEL in n)
    if not busy:
        return None
    h, w = r.padded
    least = peaks.least_seconds(r.counts.kernels(r.batch, h, w, 4)["k4"])
    return 100.0 * least * r.trace.forwards / busy
