"""Device ms a frame under the flow subnet (FlowNetS, or SPyNet with K4 and
K5): the traced window's operations launched inside the ``bench.flow`` host
ranges that forward hooks on ``model.flownets`` open."""


def read(r):
    if r.trace is None or not r.trace.frames:
        return None
    s = r.trace.seconds_under("bench.flow")
    return None if not s else 1e3 * s / r.trace.frames
