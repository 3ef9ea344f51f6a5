from memcnet_tpu_torch.train.loss import charbonnier, l1, residual_loss
from memcnet_tpu_torch.train.trainer import (
    make_interp_train_step,
    make_optimizer,
    make_ve_train_step,
)

__all__ = ["charbonnier", "l1", "residual_loss", "make_interp_train_step", "make_optimizer",
           "make_ve_train_step"]
