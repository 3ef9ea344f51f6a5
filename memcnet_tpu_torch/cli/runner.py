"""Serving entry points: model construction and padded evaluation (port of
memcnet_tpu/cli/runner.py::build_model, PaddedInterp and PaddedVE).

All run on the card unless the caller asks for the CPU: ``device`` defaults
to ``"cuda"`` and raises when CUDA is not available.
"""

import numpy as np
import torch

from memcnet_tpu_torch import models as M
from memcnet_tpu_torch.data import pad_frame, pad_plan, unpad_frame


def resolve_device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "memcnet_tpu_torch runs on a CUDA device by default and CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def build_model(net_name="MEMC_Net_star", *, seed=0, dtype=torch.float32, device="cuda",
                filter_size=4, channels=3):
    """A model with seeded random weights (the reference's init rules),
    cast to ``dtype`` and moved to ``device``, in eval mode."""
    dev = resolve_device(device)
    model = M.get_model(net_name, filter_size=filter_size, channel=channels)
    model.init_params(torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


def _padded(x_np, plan, device, dtype):
    """A (3, H, W) host frame padded by ``plan`` as a (1, 3, H', W') tensor."""
    t = torch.from_numpy(np.ascontiguousarray(pad_frame(x_np, plan)[None]))
    return t.to(device=device, dtype=dtype)


class PaddedInterp:
    """Pad -> forward -> unpad for the interpolation models."""

    def __init__(self, model, save_which=1, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.save_which = save_which
        self.dtype = dtype
        self.last_out_dtype = None

    def __call__(self, x0_np, x2_np):
        """x0/x2: (3, H, W) float32 in [0, 1] -> (out (3, H, W), aux dict)."""
        _, H, W = x0_np.shape
        if W > 1280 or H > 720:  # demo_MiddleBury.py:96-97
            raise ValueError(f"frames up to 1280x720, got {W}x{H}")
        plan = pad_plan(H, W)
        x0, x2 = (_padded(x, plan, self.device, self.dtype) for x in (x0_np, x2_np))
        with torch.inference_mode():
            outs, offs, filts, occs = self.model(x0, x2)

            def host(t):
                return unpad_frame(t[0].float().cpu().numpy(), plan, H, W)

            self.last_out_dtype = outs[self.save_which].dtype
            out = host(outs[self.save_which])
            aux = {
                "interp": host(outs[0]),
                "offsets": [host(o) for o in offs],
                "filters": [host(f) for f in filts],
                "occlusions": [host(o) for o in occs],
            }
        return out, aux


class PaddedVE:
    """Pad -> forward -> unpad for MEMC_Net_VE (7-frame windows)."""

    def __init__(self, model, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.dtype = dtype
        self.last_out_dtype = None

    def __call__(self, frames_np):
        """frames_np: 7 frames (3, H, W) float32 in [0, 1] -> the enhanced
        center frame (3, H, W) float32."""
        _, H, W = frames_np[0].shape
        plan = pad_plan(H, W)
        frames = [_padded(f, plan, self.device, self.dtype) for f in frames_np]
        with torch.inference_mode():
            out = self.model(frames)
            self.last_out_dtype = out.dtype
            return unpad_frame(out[0].float().cpu().numpy(), plan, H, W)
