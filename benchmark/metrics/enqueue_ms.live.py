"""Mean host ms of a forward's call over the window: from calling the model
to its return, while the device runs asynchronously."""


def read(r):
    ms = r.window.enqueue_ms
    return sum(ms) / len(ms) if ms else None
