"""Device ms a frame in the filter and occlusion nets (MonoNet5): the
program's ``memc.filters`` spans over the traced window, per frame."""

from benchmark import stages


def read(r):
    return stages.device_ms_per_frame(r, ("memc.filters",))
