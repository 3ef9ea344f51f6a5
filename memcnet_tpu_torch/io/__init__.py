"""Parameter I/O (ports of memcnet_tpu/io): the JAX flat dict bridge, the
reference's .pth import and torch.save checkpoints.  The .t7 import is still
to port (ROADMAP.md Queue A)."""

from memcnet_tpu_torch.io.checkpoint import load as load_checkpoint
from memcnet_tpu_torch.io.checkpoint import save as save_checkpoint
from memcnet_tpu_torch.io.params import load_jax_params, params_from_jax
from memcnet_tpu_torch.io.pth_import import import_pth, import_state_dict, load_pth_state_dict

__all__ = ("import_pth", "import_state_dict", "load_pth_state_dict",
           "load_checkpoint", "save_checkpoint", "load_jax_params", "params_from_jax")
