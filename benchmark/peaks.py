"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).  ``float32`` is the CUDA cores' rate; ``tf32``
is the tensor cores' rate for float32 inputs, the highest rate at which the
card multiplies float32 numbers, against which any float32 implementation
reads at most 100%."""

FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the peak an end-to-end share of a configuration's dtype is read against
MODEL_PEAK = {"bfloat16": "bfloat16", "float32": "tf32"}


def least_seconds(launches):
    """The least time of a kernel's launches: each the larger of its bytes
    at the HBM rate and its operations at its peak."""
    return sum(max(b / HBM_BYTES_PER_S, f / FLOPS[peak]) for b, f, peak in launches)
