"""Mean device ms of a forward over the window: CUDA events recorded before
and after each model call."""


def read(r):
    ms = r.window.forward_ms
    return sum(ms) / len(ms) if ms else None
