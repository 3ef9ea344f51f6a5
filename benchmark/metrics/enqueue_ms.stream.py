"""Mean host ms of a forward's call over the window: from calling the model
to its return.  Dispatched ahead, it stays under the forward's device time
unless the call waits for the device."""


def read(r):
    ms = r.window.enqueue_ms
    return sum(ms) / len(ms) if ms else None
