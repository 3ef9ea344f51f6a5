"""Mean per-pixel |flow| (px) of the flows that enter the projection, both
directions: the program's ``flow_px`` counter over the traced window."""

from benchmark import stages


def read(r):
    return stages.counter_ratio("flow_px")
