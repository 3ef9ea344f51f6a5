"""Share of the projected pixels that K3 fills (count 0 after K2's scatter),
%: the program's ``holes`` counter over the traced window."""

from benchmark import stages


def read(r):
    return stages.counter_ratio("holes", 100.0)
