"""Device ms a frame in the rectifier (RectifyNet or EDSR, with its input
concat): the program's ``memc.rectify`` spans over the traced window, per frame."""

from benchmark import stages


def read(r):
    return stages.device_ms_per_frame(r, ("memc.rectify",))
