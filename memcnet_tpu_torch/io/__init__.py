"""Parameter I/O (ports of memcnet_tpu/io): the JAX flat dict bridge, the
reference's .pth import, SPyNet's Torch7 .t7 weights and torch.save
checkpoints."""

from memcnet_tpu_torch.io.checkpoint import load as load_checkpoint
from memcnet_tpu_torch.io.checkpoint import save as save_checkpoint
from memcnet_tpu_torch.io.params import load_jax_params, params_from_jax
from memcnet_tpu_torch.io.pth_import import import_pth, import_state_dict, load_pth_state_dict
from memcnet_tpu_torch.io.t7_import import import_spynet_t7, load_t7_tensor, save_t7_tensor

__all__ = ("import_pth", "import_state_dict", "load_pth_state_dict",
           "load_checkpoint", "save_checkpoint", "import_spynet_t7", "load_t7_tensor",
           "save_t7_tensor", "load_jax_params", "params_from_jax")
