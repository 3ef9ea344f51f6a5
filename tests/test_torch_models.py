"""CPU parity of the PyTorch port's models (memcnet_tpu_torch.models) with the
JAX package, through the ``params_from_jax`` weights bridge.

Weights and frames are made with numpy from a seed and handed to both
packages; everything is float32.  Tolerances: subnets ATOL 1e-4 relative to
the output's scale (float32 convs summed in another order); the full
MEMC_Net_star forward MODEL_TOL 1e-3 relative to each output's scale (a few
hundred float32 layers).  The FlowNetS weights are scaled so the flows are up to
about a tenth of a pixel: then no landing coordinate sits within the two
packages' float32 noise of an integer cell boundary, where the projection and
the warp are discontinuous.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as jr
import torch

from memcnet_tpu import models as JM
from memcnet_tpu.models import edsr as jedsr
from memcnet_tpu.models import flownets as jflownets
from memcnet_tpu.models import mononet as jmono

from memcnet_tpu_torch.cli.runner import PaddedInterp, build_model
from memcnet_tpu_torch.data import pad_frame, pad_plan, unpad_frame
from memcnet_tpu_torch.io import load_jax_params, params_from_jax
from memcnet_tpu_torch.models import edsr, flownets, mononet
from memcnet_tpu_torch.models.memc_net import MEMCNetStar
from memcnet_tpu_torch.nn import init as I

ATOL = 1e-4
MODEL_TOL = 1e-3


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def numpy_params(shapes, seed, flow_scale=1.0):
    """Random float32 weights for a flat {name: shape} dict: fan-in scaled
    normals, small uniform biases."""
    rng = np.random.RandomState(seed)
    flat = {}
    for k in sorted(shapes):
        shp = tuple(shapes[k])
        if k.endswith(".bias"):
            v = rng.uniform(-0.02, 0.02, shp)
        else:
            transposed = ("deconv" in k) or ("upsampled_flow" in k)
            fan_in = shp[0] * shp[2] * shp[3] / 4 if transposed else np.prod(shp[1:])
            v = rng.randn(*shp) / np.sqrt(fan_in)
            if k.startswith("flownets.predict_flow") or "upsampled_flow" in k:
                v = v * flow_scale
        flat[k] = v.astype(np.float32)
    return flat


def to_jax(flat):
    return {k: jnp.asarray(v) for k, v in flat.items()}


def state_shapes(module, prefix=""):
    return {prefix + k: tuple(v.shape) for k, v in module.state_dict().items()}


# -- subnets -------------------------------------------------------------------


def test_flownets_matches_jax(rng):
    net = flownets.FlowNetS()
    flat = numpy_params(state_shapes(net, "flownets."), 1)
    load_jax_params(torch.nn.ModuleDict({"flownets": net}), flat)
    x = rng.rand(1, 6, 64, 128).astype(np.float32)
    want = jflownets.forward(to_jax(flat), jnp.asarray(x))
    close(net(torch.from_numpy(x)), want, ATOL)


@pytest.mark.parametrize("with_bn", [False, True])
def test_mononet_dual_path_matches_jax(rng, with_bn):
    specs = jmono.mononet5_specs(3, "full", with_bn)
    assert specs == mononet.mononet5_specs(3, with_bn)
    mods = torch.nn.ModuleDict({"a": mononet.build_modulelist(specs),
                                "b": mononet.build_modulelist(specs)})
    flat = numpy_params({k: v for k, v in state_shapes(mods).items()
                         if "num_batches_tracked" not in k}, 2)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    load_jax_params(mods, flat).eval()  # BatchNorm follows the module's mode
    x = rng.rand(1, 6, 64, 64).astype(np.float32)
    want = jmono.forward_dual_path(to_jax(flat), "a", "b", specs, jnp.asarray(x))
    got = mononet.forward_dual_path(mods["a"], mods["b"], specs, torch.from_numpy(x))
    for g, w in zip(got, want):
        close(g, w, ATOL)
    close(mononet.forward_single_path(mods["b"], specs, torch.from_numpy(x)), want[1], ATOL)


def test_edsr_pieces_match_jax(rng):
    net = edsr.EDSR(11, n_resblocks=3, n_feats=16)
    flat = numpy_params(state_shapes(net, "rectifyNet."), 3)
    load_jax_params(torch.nn.ModuleDict({"rectifyNet": net}), flat)
    pieces = [rng.rand(1, c, 16, 24).astype(np.float32) for c in (3, 2, 4, 2)]
    want = jedsr.forward_pieces(to_jax(flat), [jnp.asarray(p) for p in pieces], n_resblocks=3)
    close(net.forward_pieces([torch.from_numpy(p) for p in pieces]), want, ATOL)


def test_initialisers_are_seeded_and_bounded():
    g = torch.Generator().manual_seed(3)
    w = I.xavier_uniform((64, 32, 3, 3), g)
    assert float(w.abs().max()) <= np.sqrt(6.0 / (32 * 9 + 64 * 9))
    assert torch.equal(w, I.xavier_uniform((64, 32, 3, 3), torch.Generator().manual_seed(3)))
    k = I.kaiming_uniform((64, 32, 3, 3), g)
    assert float(k.abs().max()) <= np.sqrt(6.0 / (32 * 9))
    n = I.flownets_normal((128, 64, 5, 5), g)
    assert abs(float(n.std()) - 0.02 / (25 * 128)) < 0.1 * 0.02 / (25 * 128)
    m = I.resnet_msra((64, 3, 7, 7), g)
    assert abs(float(m.std()) - np.sqrt(2.0 / (49 * 64))) < 0.1 * np.sqrt(2.0 / (49 * 64))
    a = build_model(seed=5, device="cpu").state_dict()
    b = build_model(seed=5, device="cpu").state_dict()
    assert all(torch.equal(a[key], b[key]) for key in a)


# -- MEMC_Net_star end to end -------------------------------------------------


@pytest.fixture(scope="module")
def star():
    """JAX params from numpy, the port model through the bridge, a 100x120
    pair padded to 128x128, and the JAX forward's outputs."""
    jmodel = JM.get_model("MEMC_Net_star")
    shapes = {k: v.shape for k, v in jax.eval_shape(jmodel.init_params, jr.PRNGKey(0)).items()}
    flat = numpy_params(shapes, 11, flow_scale=0.02)
    model = MEMCNetStar()
    assert set(model.state_dict()) == set(flat)
    load_jax_params(model, flat)
    model.eval()
    rng = np.random.RandomState(12)
    a = rng.rand(3, 100, 120).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    plan = pad_plan(100, 120)
    x0, x2 = (pad_frame(f, plan)[None] for f in (a, b))
    outs = jax.jit(jmodel.forward)(to_jax(flat), jnp.asarray(x0), jnp.asarray(x2))
    want = jax.tree.map(np.asarray, outs)
    return dict(model=model, flat=flat, a=a, b=b, plan=plan, x0=x0, x2=x2, want=want)


def test_params_from_jax_is_key_for_key(star):
    sd = params_from_jax(star["flat"])
    assert set(sd) == set(star["model"].state_dict())
    k = "rectifyNet.body.3.body.2.bias"
    assert torch.equal(sd[k], torch.from_numpy(star["flat"][k]))
    assert torch.equal(star["model"].state_dict()[k], sd[k])


def test_star_forward_matches_jax(star):
    with torch.no_grad():
        got = star["model"](torch.from_numpy(star["x0"]), torch.from_numpy(star["x2"]))
    (gi, gr), goffs, gfilts, goccs = got
    (wi, wr), woffs, wfilts, woccs = star["want"]
    assert float(np.abs(woffs[0]).max()) > 0.05  # the flows are not trivial
    for g, w in [(gi, wi), (gr, wr), *zip(goffs, woffs), *zip(gfilts, wfilts),
                 *zip(goccs, woccs)]:
        close(g, w, MODEL_TOL)


def test_padded_interp_on_cpu(star):
    a, b, plan = star["a"], star["b"], star["plan"]
    interp = PaddedInterp(star["model"], device="cpu")
    out, aux = interp(a, b)
    assert out.shape == (3, 100, 120) and np.isfinite(out).all()
    assert interp.last_out_dtype == torch.float32
    (wi, wr), woffs, _wf, _wo = star["want"]
    close(torch.from_numpy(out), unpad_frame(wr[0], plan, 100, 120), MODEL_TOL)
    close(torch.from_numpy(aux["interp"]), unpad_frame(wi[0], plan, 100, 120), MODEL_TOL)
    close(torch.from_numpy(aux["offsets"][1]), unpad_frame(woffs[1][0], plan, 100, 120),
          MODEL_TOL)
