"""Model FLOP utilisation of the stream: the benchmark's count of one
frame's conv operations (``benchmark/counts``) times the window's frames a
second, over the card's peak in the configuration's type (bf16 989 TFLOP/s;
float32 at the TF32 rate, 495 TFLOP/s, which no float32 path can pass), %."""

from benchmark import peaks


def read(r):
    h, w = r.padded
    peak = peaks.FLOPS[peaks.MODEL_PEAK[r.config["dtype"]]]
    return 100.0 * r.counts.flops(h, w) * r.frames_per_s / peak
