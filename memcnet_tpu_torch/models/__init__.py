"""Model registry of the port (mirrors memcnet_tpu/models/__init__.py).
Only what is ported is listed; MEMC_Net_VE is queued in ROADMAP.md Queue A."""

from memcnet_tpu_torch.models.memc_net import MEMCNet, MEMCNetS, MEMCNetStar

_REGISTRY = {
    "MEMC_Net": MEMCNet,
    "MEMC_Net_s": MEMCNetS,
    "MEMC_Net_star": MEMCNetStar,
}
_NOT_PORTED = ("MEMC_Net_VE",)

__all__ = tuple(_REGISTRY)


def get_model(name, *, filter_size=4, channel=3):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to memcnet_tpu_torch yet (ROADMAP.md Queue A); "
            f"ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](filter_size=filter_size, channel=channel)
