"""Host ms a forward in the rectifier's call (RectifyNet with its input
concat): the program's ``memc.rectify`` spans over the traced window, per
forward."""

from benchmark import stages


def read(r):
    return stages.host_ms_per_forward(r, ("memc.rectify",))
