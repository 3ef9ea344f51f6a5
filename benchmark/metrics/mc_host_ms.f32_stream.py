"""Host ms a forward in motion compensation's calls: the program's
``memc.project``, ``memc.ctx``, ``memc.warp`` and ``memc.blend`` spans over
the traced window, summed, per forward."""

from benchmark import stages

SPANS = ("memc.project", "memc.ctx", "memc.warp", "memc.blend")


def read(r):
    return stages.host_ms_per_forward(r, SPANS)
