"""Weights bridge from the JAX package's flat parameter dict.

The JAX package keys its parameters by the reference's PyTorch state-dict
names in PyTorch layouts (OIHW / IOHW), and the port's modules are built so
their ``state_dict()`` keys are the same names.  So the bridge is
``torch.from_numpy`` key for key and a strict ``load_state_dict``.
"""

import numpy as np
import torch

from memcnet_tpu_torch.io.checkpoint import load_params


def params_from_jax(flat):
    """{name: array} -> {name: tensor} (float32 arrays stay float32)."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def load_jax_params(module, flat):
    """Strict-load a JAX flat dict into ``module``.  BatchNorm's
    ``num_batches_tracked`` (which JAX does not keep) keeps its own value."""
    return load_params(module, params_from_jax(flat))
