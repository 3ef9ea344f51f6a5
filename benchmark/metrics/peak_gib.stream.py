"""The device memory the window held at its peak, GiB:
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""


def read(r):
    return r.peak_window_bytes / 2 ** 30 if r.peak_window_bytes else None
