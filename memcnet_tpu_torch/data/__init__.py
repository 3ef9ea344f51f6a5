"""Dataset readers, YUV I/O and padding geometry (ports of memcnet_tpu/data);
the registry mirrors datasets_benchmark.__all__ (datasets_benchmark/__init__.py:18)."""

from memcnet_tpu_torch.data.middlebury import MiddleburyOther
from memcnet_tpu_torch.data.padding import pad_frame, pad_plan, unpad_frame
from memcnet_tpu_torch.data.vbm4d import VBM4D, BayesSR
from memcnet_tpu_torch.data.vimeo90k import Vimeo90K, Vimeo_90K_db, Vimeo_90K_dn, Vimeo_90K_sr
from memcnet_tpu_torch.data.yuv import YUVRead, YUVWrite

DATASETS = {
    "Vimeo_90K_sr": Vimeo_90K_sr,
    "Vimeo_90K_dn": Vimeo_90K_dn,
    "Vimeo_90K_db": Vimeo_90K_db,
    "VBM4D": VBM4D,
}

__all__ = (
    "MiddleburyOther", "VBM4D", "BayesSR", "Vimeo90K", "Vimeo_90K_sr",
    "Vimeo_90K_dn", "Vimeo_90K_db", "YUVRead", "YUVWrite", "DATASETS",
    "pad_frame", "pad_plan", "unpad_frame",
)
