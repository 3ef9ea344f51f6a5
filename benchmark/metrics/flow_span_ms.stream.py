"""Device ms a frame in the flow subnet (FlowNetS with its scale and
upsample, or SPyNet with K4 and K5, and its /2): the stream time between the
events of the program's ``memc.flow`` spans over the traced window, per frame."""

from benchmark import stages


def read(r):
    return stages.device_ms_per_frame(r, ("memc.flow",))
