"""Import of a reference ``.pth`` state dict into a port module (port of
memcnet_tpu/io/pth_import.py).

The port's modules carry the reference's PyTorch state-dict names and
layouts, so import is a name-for-name tensor copy.  The filter-update-load
idiom of the demos (tolerate missing/extra keys, demo_MiddleBury.py:45-51) is
reproduced, with a strict mode for CI.  BatchNorm's ``num_batches_tracked``
is counted on neither side: a reference ``.pth`` from PyTorch 0.2 has none,
the JAX package keeps none, and the port's BatchNorm modules do.
"""

import numpy as np
import torch


def _skip(key):
    return key.endswith("num_batches_tracked")


def load_pth_state_dict(path):
    """Load a .pth file (a state dict or a ``{"state_dict": ...}`` wrapper)
    into a {name: np.ndarray} dict, on the CPU."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict) and "state_dict" in data:
        data = data["state_dict"]
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in data.items()}


def import_state_dict(module, state, *, strict=False):
    """Overlay ``state`` ({name: array or tensor}) onto ``module`` in place.

    Keys the module lacks are skipped; module keys the state lacks keep their
    values and are listed as missing; strict=True requires an exact 1:1 match.
    A shape mismatch always raises.  Values take the module tensor's dtype
    and device.  Returns the module and {"loaded", "skipped", "missing"}.
    """
    state = {k: torch.as_tensor(v) for k, v in state.items() if not _skip(k)}
    own = {k: v for k, v in module.state_dict().items() if not _skip(k)}
    loaded = [k for k in state if k in own]
    skipped = [k for k in state if k not in own]
    missing = [k for k in own if k not in state]
    for k in loaded:
        if tuple(own[k].shape) != tuple(state[k].shape):
            raise ValueError(f"shape mismatch for {k}: module {tuple(own[k].shape)} "
                             f"vs pth {tuple(state[k].shape)}")
    if strict and (skipped or missing):
        raise KeyError(f"strict import: extra keys {skipped[:5]}..., missing keys {missing[:5]}...")
    with torch.no_grad():
        for k in loaded:
            own[k].copy_(state[k])
    return module, {"loaded": loaded, "skipped": skipped, "missing": missing}


def import_pth(module, path, *, strict=False):
    return import_state_dict(module, load_pth_state_dict(path), strict=strict)
