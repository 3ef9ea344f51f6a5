"""Host ms a forward in the flow subnet's call (SPyNet with K4 and K5): the
program's ``memc.flow`` spans over the traced window, per forward.  Where it
is near the forward's whole call, the call waits for the card there."""

from benchmark import stages


def read(r):
    return stages.host_ms_per_forward(r, ("memc.flow",))
