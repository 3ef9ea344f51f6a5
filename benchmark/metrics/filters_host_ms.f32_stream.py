"""Host ms a forward in the filter net's call (MonoNet5): the program's
``memc.filters`` spans over the traced window, per forward."""

from benchmark import stages


def read(r):
    return stages.host_ms_per_forward(r, ("memc.filters",))
