"""Device ms a frame of cuDNN's NCHW <-> NHWC transforms, by kernel name."""

NAMES = ("nchwToNhwc", "nhwcToNchw")


def read(r):
    if r.trace is None or not r.trace.frames:
        return None
    s = r.trace.seconds_of(lambda n: any(k in n for k in NAMES))
    return None if not s else 1e3 * s / r.trace.frames
