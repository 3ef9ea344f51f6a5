"""Checkpoints of the port through ``torch.save`` / ``torch.load``, in the
JAX package's layout (memcnet_tpu/io/checkpoint.py): a dict with "params"
(the state dict), and "opt_state" and "step" where given.  The JAX package
writes orbax directories; this module does not read them (import the
reference's ``.pth`` with io.pth_import, or the JAX flat dict with
io.params)."""

import os

import torch


def save(path, module_or_state_dict, opt_state=None, step=None):
    path = os.path.abspath(path)
    params = module_or_state_dict
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    ckpt = {"params": {k: v.detach().cpu() for k, v in params.items()}}
    if opt_state is not None:
        ckpt["opt_state"] = opt_state
    if step is not None:
        ckpt["step"] = step
    torch.save(ckpt, path)
    return path


def load(path):
    """The saved dict: "params", and "opt_state" and "step" where they were
    saved (``train.trainer.Adamax.load_state_dict`` takes "opt_state")."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_params(module, params):
    """Strict-load a checkpoint's "params" into ``module``; BatchNorm's
    ``num_batches_tracked``, where the params lack it, keeps its own value."""
    params = dict(params)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in params:
            params[k] = v
    module.load_state_dict(params, strict=True)
    return module
