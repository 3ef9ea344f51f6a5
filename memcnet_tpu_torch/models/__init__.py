"""Model registry of the port (mirrors memcnet_tpu/models/__init__.py)."""

from memcnet_tpu_torch.models.memc_net import MEMCNet, MEMCNetS, MEMCNetStar
from memcnet_tpu_torch.models.memc_net_ve import MEMCNetVE

_REGISTRY = {
    "MEMC_Net": MEMCNet,
    "MEMC_Net_s": MEMCNetS,
    "MEMC_Net_star": MEMCNetStar,
    "MEMC_Net_VE": MEMCNetVE,
}

__all__ = tuple(_REGISTRY)


def get_model(name, *, filter_size=4, channel=3):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](filter_size=filter_size, channel=channel)
