"""Device ms a frame in motion compensation: the program's ``memc.project``
(K2+K3), ``memc.ctx`` (star's contexts), ``memc.warp`` (K1) and ``memc.blend``
spans over the traced window, summed, per frame."""

from benchmark import stages

SPANS = ("memc.project", "memc.ctx", "memc.warp", "memc.blend")


def read(r):
    return stages.device_ms_per_frame(r, SPANS)
