"""CPU parity of the port's MEMC_Net_VE with the JAX package, through the
``params_from_jax`` weights bridge.

Weights and frames are made with numpy from a seed and handed to both
packages; everything is float32.  Tolerances: the forward and PaddedVE
MODEL_TOL 1e-3 relative to each output's scale, as for the interpolation
models (tests/test_torch_models.py), and the gradient of the context conv's
weight GRAD_TOL 1e-3 relative to the largest JAX gradient.  That gradient
runs back through EDSR's ten ReLU resblocks, and each package's float32
gradient is about 1.6e-4 (JAX) and 1.8e-4 (port) of its largest element away
from the port's float64 gradient on these inputs, so 1e-4 is below the
float32 floor; the two packages differ by 1.3e-4, and dropping the detach of
the warped contexts moves the gradient by 0.57.  The forward runs at B=2,
so a batch-major neighbour layout where the JAX package has a sample-major
one would show.  BatchNorm running variances lie in [0.5, 1.5].  FlowNetS's
last layers are scaled as in the MEMC_Net_star fixture: VE's flow is twice an
interpolation model's (x 20, no /2) and stays within a fraction of a pixel,
clear of the integer cell boundaries where the warp is discontinuous.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as jr
import torch

from memcnet_tpu import models as JM
from memcnet_tpu.cli import runner as jrunner

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch.cli import runner as TR
from memcnet_tpu_torch.io import load_jax_params, params_from_jax
from memcnet_tpu_torch.models.memc_net_ve import MEMCNetVE

from test_torch_models import MODEL_TOL, close, numpy_params, to_jax

GRAD_TOL = 1e-3
CTX_W = "ctxNet.conv1.weight"


def window(rng, B, H, W):
    """7 frames (B, 3, H, W): one textured scene, each frame moved by a pixel
    or two from the center's position and dimmed a little."""
    base = rng.rand(B, 3, H, W).astype(np.float32)
    frames = []
    for t in range(7):
        d = t - 3
        frames.append(np.roll(base, (d, 2 * d), axis=(2, 3)) * (1.0 - 0.02 * abs(d)))
    return frames


@pytest.fixture(scope="module")
def ve():
    """JAX params from numpy, the port model through the bridge, a B=2
    64x128 window and the JAX forward's (rectified, flow, filter)."""
    jmodel = JM.get_model("MEMC_Net_VE")
    shapes = {k: v.shape for k, v in jax.eval_shape(jmodel.init_params, jr.PRNGKey(0)).items()}
    flat = numpy_params(shapes, 41, flow_scale=0.02)
    rng = np.random.RandomState(42)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    model = MEMCNetVE()
    load_jax_params(model, flat)
    model.eval()
    frames = window(rng, 2, 64, 128)
    fwd = jax.jit(lambda p, fr: jmodel.forward(p, list(fr), debug=True))
    want = jax.tree.map(np.asarray, fwd(to_jax(flat), tuple(jnp.asarray(f) for f in frames)))
    return dict(jmodel=jmodel, model=model, flat=flat, frames=frames,
                want=dict(zip(("rectified", "flow", "filter"), want)))


def test_params_from_jax_is_key_for_key(ve):
    sd = params_from_jax(ve["flat"])
    own = {k for k in MEMCNetVE().state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    assert sum(k.endswith("running_var") for k in sd) == 10  # the trunk's BN layers
    assert not any(k.startswith(("initScaleNets_filter2.", "initScaleNets_occlusion"))
                   for k in sd)
    assert ve["flat"]["rectifyNet.head.0.weight"].shape[1] == ve["model"].rectify_in == 577
    k = "initScaleNets_filter.6.running_mean"
    assert torch.equal(ve["model"].state_dict()[k], sd[k])


@pytest.mark.parametrize("output", ["rectified", "flow", "filter"])
def test_forward_matches_jax(ve, output):
    with torch.no_grad():
        rect, flow, filt = ve["model"]([torch.from_numpy(f) for f in ve["frames"]], debug=True)
    got = {"rectified": rect, "flow": flow, "filter": filt}[output]
    assert got.shape[0] == (2 if output == "rectified" else 12)
    assert float(np.abs(ve["want"]["flow"]).max()) > 0.01  # the flows are not trivial
    close(got, ve["want"][output], MODEL_TOL)


def test_padded_ve_on_cpu_odd_window(ve):
    """40x100 frames pad to 128x128 (both pads, uneven splits)."""
    rng = np.random.RandomState(43)
    frames = [f[0] for f in window(rng, 1, 40, 100)]
    want = jrunner.PaddedVE(ve["jmodel"], to_jax(ve["flat"]))(frames)
    serve = TR.PaddedVE(ve["model"], device="cpu")
    got = serve(frames)
    assert got.shape == (3, 40, 100) and got.dtype == np.float32 and np.isfinite(got).all()
    assert serve.last_out_dtype == torch.float32
    close(torch.from_numpy(got), want, MODEL_TOL)


def test_ctx_gradient_matches_jax(ve):
    """d sum(out) / d ctxNet.conv1.weight: through the center's context and
    EDSR only, since the warped contexts are detached in both packages."""
    jmodel, flat, frames = ve["jmodel"], ve["flat"], ve["frames"]
    params = to_jax(flat)

    def loss(w, params, frames):  # params and frames as arguments: no constant folding
        return jnp.sum(jmodel.forward(dict(params, **{CTX_W: w}), list(frames)))

    want = np.asarray(jax.jit(jax.grad(loss))(params[CTX_W], params,
                                              tuple(jnp.asarray(f) for f in frames)))
    model = ve["model"]
    w = model.ctxNet.conv1.weight
    model.requires_grad_(False)
    w.requires_grad_(True)
    try:
        model([torch.from_numpy(f) for f in frames]).sum().backward()
        got = w.grad.numpy().copy()
    finally:
        w.grad = None
        model.requires_grad_(True)
    assert float(np.abs(want).max()) > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * float(np.abs(want).max()))


def test_build_model_ve_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.build_model("MEMC_Net_VE")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.PaddedVE(torch.nn.Identity())
    model = TR.build_model("MEMC_Net_VE", seed=3, device="cpu")
    assert isinstance(model, MEMCNetVE) and isinstance(TM.get_model("MEMC_Net_VE"), MEMCNetVE)
    assert not model.training
    again = TR.build_model("MEMC_Net_VE", seed=3, device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())
    w = model.initScaleNets_filter[0].weight.detach()  # kaiming uniform, fan_in 6 * 9
    assert 0.0 < float(w.abs().max()) <= np.sqrt(6.0 / 54)
