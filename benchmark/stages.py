"""The program's stage spans and counters over the traced window, for the
per-layer readers: ``memcnet_tpu_torch/utils/tracing.py`` records them only
while a profile records, so its ``snapshot()`` after a run holds the traced
window and nothing else.  Each function returns None where the program keeps
no such recorder, or the snapshot holds no forward or not what is asked."""


def snapshot():
    """The recorder's snapshot, or None where it has none or saw no forward."""
    try:
        from memcnet_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = getattr(tracing, "snapshot", None)
    if snap is None:
        return None
    s = snap()
    return s if s.get("forwards") else None


def _sum(spans, names, key):
    found = [spans[n][key] for n in names if n in spans]
    if not found or any(v is None for v in found):
        return None
    return sum(found)


def device_ms_per_frame(r, names):
    """Device ms a frame of the spans ``names`` (those present, summed):
    their events' stream time over the traced forwards' frames."""
    s = snapshot()
    if s is None:
        return None
    ms = _sum(s["spans"], names, "device_ms")
    return None if ms is None else ms / (s["forwards"] * r.batch)


def host_ms_per_forward(r, names):
    """Host ms a forward of the spans ``names`` (those present, summed)."""
    s = snapshot()
    if s is None:
        return None
    ms = _sum(s["spans"], names, "host_ms")
    return None if ms is None else ms / s["forwards"]


def counter_ratio(name, scale=1.0):
    """Counter ``name``'s value over its total, times ``scale``."""
    s = snapshot()
    c = None if s is None else s["counters"].get(name)
    if c is None or not c["total"]:
        return None
    return scale * c["value"] / c["total"]
