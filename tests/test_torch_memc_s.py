"""CPU parity of the port's MEMC_Net and MEMC_Net_s with the JAX package,
through the ``params_from_jax`` weights bridge.

Weights and frames are made with numpy from a seed and handed to both
packages; everything is float32.  Tolerances: the thin trunk ATOL 1e-4 relative
to the output's scale (float32 convs summed in another order); the full
forwards MODEL_TOL 1e-3 relative to each output's scale, as for MEMC_Net_star
(tests/test_torch_models.py).  The flow nets' last layers are scaled so the
flows stay below a pixel: the projection and the warp are discontinuous at
integer cell boundaries, where float32 noise could flip a cell between the
packages.  FlowNetS's flows are those of the MEMC_Net_star fixture.  SPyNet's
last convs get a constant bias besides, so its flow sits near (0.35, 0.21) px
after halving, at least MARGIN from every cell boundary.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as jr
import torch

from memcnet_tpu import models as JM
from memcnet_tpu.models import mononet as jmono
from memcnet_tpu.models import spynet as jspynet

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch.cli.runner import PaddedInterp
from memcnet_tpu_torch.data import pad_frame, pad_plan, unpad_frame
from memcnet_tpu_torch.io import load_jax_params, params_from_jax
from memcnet_tpu_torch.models import mononet

from test_torch_models import ATOL, MODEL_TOL, close, numpy_params, state_shapes, to_jax

MARGIN = 1e-3


def model_params(name, seed):
    """numpy params for a JAX model: BN running variances in [0.5, 1.5];
    the flow net's last layers scaled down (FlowNetS as in the MEMC_Net_star
    fixture; SPyNet's last conv of each level, with bias (0.1, 0.06), so the
    three levels of a 128x128 input sum to a flow near (0.7, 0.42))."""
    jmodel = JM.get_model(name)
    shapes = {k: v.shape for k, v in jax.eval_shape(jmodel.init_params, jr.PRNGKey(0)).items()}
    flat = numpy_params(shapes, seed, flow_scale=0.02)
    rng = np.random.RandomState(seed + 1)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
        if k.startswith("flownets.moduleBasic.") and k.endswith(".moduleBasic.8.weight"):
            flat[k] = flat[k] * 0.02
        if k.startswith("flownets.moduleBasic.") and k.endswith(".moduleBasic.8.bias"):
            flat[k] = np.array([0.1, 0.06], np.float32)
    return jmodel, flat


def landing_margin(flow):
    """Least distance of a landing coordinate p + f (p an integer) from a cell
    boundary."""
    frac = flow - np.floor(flow)
    return float(np.minimum(frac, 1.0 - frac).min())


@functools.lru_cache(maxsize=None)
def built(name):
    """JAX params from numpy, the port model through the bridge, a 100x120
    pair padded to 128x128, and the JAX forward's outputs."""
    jmodel, flat = model_params(name, 31)
    model = TM.get_model(name)
    load_jax_params(model, flat)
    model.eval()
    rng = np.random.RandomState(32)
    a = rng.rand(3, 100, 120).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    plan = pad_plan(100, 120)
    x0, x2 = (pad_frame(f, plan)[None] for f in (a, b))
    outs = jax.jit(jmodel.forward)(to_jax(flat), jnp.asarray(x0), jnp.asarray(x2))
    want = jax.tree.map(np.asarray, outs)
    return dict(name=name, model=model, flat=flat, a=a, b=b, plan=plan, x0=x0, x2=x2,
                want=want)


MODELS = ["MEMC_Net", "MEMC_Net_s"]


@pytest.mark.parametrize("name", MODELS)
def test_params_from_jax_is_key_for_key(name):
    net = built(name)
    sd = params_from_jax(net["flat"])
    own = {k for k in net["model"].state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    k = "rectifyNet.14.bias"
    assert torch.equal(net["model"].state_dict()[k], sd[k])
    assert hasattr(net["model"], "initScaleNets_occlusion") == (net["name"] == "MEMC_Net")


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    net = built(name)
    with torch.no_grad():
        got = net["model"](torch.from_numpy(net["x0"]), torch.from_numpy(net["x2"]))
    (gi, gr), goffs, gfilts, goccs = got
    (wi, wr), woffs, wfilts, woccs = net["want"]
    assert float(np.abs(woffs[0]).max()) > 0.01  # the flows are not trivial
    for g, w in [(gi, wi), (gr, wr), *zip(goffs, woffs), *zip(gfilts, wfilts),
                 *zip(goccs, woccs)]:
        close(g, w, MODEL_TOL)


def test_padded_interp_on_cpu_memc_s():
    net = built("MEMC_Net_s")
    a, b, plan = net["a"], net["b"], net["plan"]
    interp = PaddedInterp(net["model"], device="cpu")
    out, aux = interp(a, b)
    assert out.shape == (3, 100, 120) and np.isfinite(out).all()
    (wi, wr), woffs, _wf, woccs = net["want"]
    close(torch.from_numpy(out), unpad_frame(wr[0], plan, 100, 120), MODEL_TOL)
    close(torch.from_numpy(aux["interp"]), unpad_frame(wi[0], plan, 100, 120), MODEL_TOL)
    close(torch.from_numpy(aux["occlusions"][1]), unpad_frame(woccs[1][0], plan, 100, 120),
          MODEL_TOL)


def test_spynet_flow_keeps_off_cell_boundaries():
    """MEMC_Net_s's halved SPyNet flow (what flow_project lands) is as the
    JAX package's and keeps MARGIN from cell boundaries."""
    net = built("MEMC_Net_s")
    x0, x2 = net["x0"], net["x2"]
    first = np.concatenate([x0, x2])
    second = np.concatenate([x2, x0])
    want = np.asarray(jax.jit(jspynet.forward)(to_jax(net["flat"]), jnp.asarray(first),
                                               jnp.asarray(second))) / 2.0
    with torch.no_grad():
        got = net["model"].flownets(torch.from_numpy(first), torch.from_numpy(second)) / 2.0
    close(got, want, ATOL)
    assert landing_margin(want) > MARGIN


@pytest.mark.parametrize("with_bn", [True, False])
def test_thin_mononet_matches_jax(rng, with_bn):
    specs = jmono.mononet5_specs(3, "thin", with_bn)
    assert specs == mononet.mononet5_specs(3, with_bn, variant="thin")
    mods = torch.nn.ModuleDict({"t": mononet.build_modulelist(specs)})
    flat = numpy_params({k: v for k, v in state_shapes(mods).items()
                         if "num_batches_tracked" not in k}, 5)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    load_jax_params(mods, flat).eval()  # BatchNorm follows the module's mode
    x = rng.rand(1, 6, 64, 64).astype(np.float32)
    want = jmono.forward_single_path(to_jax(flat), "t", specs, jnp.asarray(x))
    close(mononet.forward_single_path(mods["t"], specs, torch.from_numpy(x)), want, ATOL)


def test_rectify_specs_match_jax():
    assert mononet.rectify_specs(41) == jmono.rectify_specs(41)
