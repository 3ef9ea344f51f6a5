"""CPU parity of the four models' train mode with the JAX package, through
the ``params_from_jax`` weights bridge: ``train_residuals``, the gradient of
``residual_loss`` for every parameter, the BatchNorm running-statistics
updates, ``flow_project(fillhole=False)``'s gradient, and one train step.

B = 2 (the sample-major layouts need it), 64x128, full widths, float32,
weights and frames made with numpy from a seed (tests/test_torch_memc_s.py's
``model_params``: flows below a pixel, away from cell boundaries, where the
projection and the warp are discontinuous).  Tolerances:
  * residuals within MODEL_TOL (1e-3) of each residual's scale, as the
    eval-mode forwards;
  * running statistics within 1e-5, the same key set as the JAX
    ``bn_updates``;
  * gradients, per subnet (the first component of the parameter name): the
    largest |port - JAX| within GRAD_TOL (1e-2) of the subnet's largest
    |JAX gradient|, and within TRUNK_GRAD_TOL (0.1) in the BatchNorm trunks
    (``initScaleNets_filter`` and ``initScaleNets_occlusion`` of MEMC_Net,
    MEMC_Net_s and MEMC_Net_VE).  Train-mode BatchNorm's backward amplifies
    float32 rounding: the two packages' trunk gradients differ by up to
    5.2e-2 of the trunk's largest (VE), elsewhere by at most 7.4e-3 (VE's
    ctx conv) and 3e-4 in MEMC_Net_star, which has no BatchNorm.  Each
    tensor also within 0.25 of its own L2 norm, and exactly zero where the
    JAX gradient is (star's detached ctx conv, SPyNet's levels that a
    64x128 input does not reach);
  * flow_project's gradient within 1e-5 (the same gather of the cotangent);
  * a train step: the loss within 1e-5 relative, the running statistics
    within 1e-5, and the parameters within STEP_TOL (1e-6) of the JAX step's
    on at least 99% of their elements and within 2 lr everywhere: Adamax's
    first update is lr * g / (|g| + 1e-8), about lr * sign(g), so a
    gradient element that float32 noise moves across 0 moves its parameter
    by 2 lr.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from memcnet_tpu.ops import projection as JP
from memcnet_tpu.train import loss as jloss
from memcnet_tpu.train import trainer as jtrainer

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch import train as ttrain
from memcnet_tpu_torch.io import load_jax_params
from memcnet_tpu_torch.ops import flow_project

from test_torch_memc_s import model_params
from test_torch_models import MODEL_TOL, close, to_jax

GRAD_TOL = 1e-2
TRUNK_GRAD_TOL = 0.1
L2_TOL = 0.25
BN_TOL = 1e-5
STEP_TOL = 1e-6
STEP_LR = 1e-4
B, H, W = 2, 64, 128
MODELS = ["MEMC_Net", "MEMC_Net_s", "MEMC_Net_star", "MEMC_Net_VE"]
TRUNKS = ("initScaleNets_filter", "initScaleNets_occlusion")


def inputs(name):
    """numpy inputs of ``train_residuals``: (x0, x1, x2) with x1 between the
    two moved frames, or (frames, y) for VE's 7-frame window."""
    rng = np.random.RandomState(3)
    base = rng.rand(B, 3, H, W).astype(np.float32)
    if name == "MEMC_Net_VE":
        frames = [np.roll(base, (k - 3, 2 * (k - 3)), axis=(2, 3)) * 0.9 + 0.05
                  for k in range(7)]
        return frames, frames[3] * 0.9 + 0.05
    x2 = np.roll(base, (1, 2), axis=(2, 3)) * 0.9 + 0.05
    return base, (base + x2) / 2, x2


def to_torch(args):
    return [to_torch(a) if isinstance(a, list) else torch.from_numpy(a.copy()) for a in args]


def jax_args(args):
    return [jax_args(a) if isinstance(a, list) else jnp.asarray(a) for a in args]


def residuals_of(name, out):
    return out if name == "MEMC_Net_VE" else out[0]


def jax_residuals(jmodel, name, params, args):
    """(residuals, bn_updates) of the JAX ``train_residuals``."""
    out = jmodel.train_residuals(params, *args)
    return (out[0], out[1]) if name == "MEMC_Net_VE" else (out[0], out[4])


@functools.lru_cache(maxsize=None)
def run(name):
    """Both packages' train-mode residuals, loss, gradients and running
    statistics from the same weights and inputs."""
    jmodel, flat = model_params(name, 31)
    args = inputs(name)

    def loss_fn(params):
        res, upd = jax_residuals(jmodel, name, params, jax_args(args))
        return jloss.residual_loss(res), (res, upd)

    (jl, (jres, jupd)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(flat))
    model = TM.get_model(name)
    load_jax_params(model, flat)
    model.train()
    res = residuals_of(name, model.train_residuals(*to_torch(args)))
    loss = ttrain.residual_loss(res)
    loss.backward()
    return dict(jmodel=jmodel, flat=flat, args=args, model=model, loss=float(loss.detach()),
                res=[r.detach() for r in res], jloss=float(jl),
                jres=[np.asarray(r) for r in jres], jupd={k: np.asarray(v) for k, v in jupd.items()},
                jgrads={k: np.asarray(v) for k, v in jgrads.items()})


@pytest.mark.parametrize("name", MODELS)
def test_train_residuals_match_jax(name):
    r = run(name)
    assert len(r["res"]) == len(r["jres"]) == (7 if name == "MEMC_Net_VE" else 2)
    for g, w in zip(r["res"], r["jres"]):
        close(g, w, MODEL_TOL)
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_bn_updates_match_jax(name):
    """The running statistics the train-mode forward wrote into the buffers
    are the JAX ``bn_updates``: the same keys (none for star), within
    BN_TOL, and they moved."""
    r = run(name)
    sd = r["model"].state_dict()
    assert set(r["jupd"]) == {k for k in sd if "running_" in k}
    assert bool(r["jupd"]) == (name != "MEMC_Net_star")
    for k, v in r["jupd"].items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=BN_TOL, err_msg=k)
        assert not np.allclose(v, r["flat"][k]), k


@pytest.mark.parametrize("name", MODELS)
def test_every_parameter_gradient_matches_jax(name):
    r = run(name)
    named = dict(r["model"].named_parameters())
    # the JAX params also hold the running statistics: state, with zero gradients
    assert set(r["jgrads"]) == set(named) | set(r["jupd"])
    assert not any(r["jgrads"][k].any() for k in r["jupd"])
    subnet_max = {}
    for k in named:
        sub = k.split(".")[0]
        subnet_max[sub] = max(subnet_max.get(sub, 0.0), float(np.abs(r["jgrads"][k]).max()))
    for k, p in named.items():
        want = r["jgrads"][k]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if not want.any():
            assert not got.any(), f"{k}: JAX's gradient is zero, the port's is not"
            continue
        sub = k.split(".")[0]
        tol = TRUNK_GRAD_TOL if sub in TRUNKS and name != "MEMC_Net_star" else GRAD_TOL
        err = float(np.abs(got - want).max())
        assert err <= tol * subnet_max[sub], f"{k}: {err} > {tol} x {subnet_max[sub]}"
        assert np.linalg.norm(got - want) <= L2_TOL * np.linalg.norm(want), k


def test_flow_project_without_fill_gradient_matches_jax_vjp(rng):
    """flow_project(fillhole=False), the train path's projection: output and
    gradient against jax.vjp, on flows up to 3 px with pixels landing out of
    the frame and clamped cells."""
    flow = (rng.randn(2, 2, 24, 40) * 3).astype(np.float32)
    flow[:, 0, :, -3:] = 4.0  # lands past x = W-1: invalid
    g = rng.randn(2, 2, 24, 40).astype(np.float32)
    want, vjp = jax.vjp(lambda f: JP.flow_project(f, fillhole=False), jnp.asarray(flow))
    (want_g,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(flow.copy()).requires_grad_()
    out = flow_project(tf, fillhole=False)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want_g)).max() > 0.1


@pytest.mark.parametrize("name", ["MEMC_Net", "MEMC_Net_star", "MEMC_Net_VE"])
def test_train_step_matches_jax_step(name):
    """One ``make_interp_train_step`` (``make_ve_train_step`` for VE) from the
    same weights and inputs as the JAX package's step with the same
    optimizer: the loss, the running statistics and the parameters after
    the update."""
    jmodel, flat = model_params(name, 31)
    args = inputs(name)
    jopt = jtrainer.make_optimizer(lr=STEP_LR, subnet_lr=True, plateau=True)
    make = jtrainer.make_ve_train_step if name == "MEMC_Net_VE" else \
        jtrainer.make_interp_train_step
    jparams, _, jl = jax.jit(make(jmodel, jopt))(to_jax(flat), jopt.init(to_jax(flat)),
                                                 *jax_args(args))
    model = TM.get_model(name)
    load_jax_params(model, flat)
    opt = ttrain.make_optimizer(model, lr=STEP_LR, subnet_lr=True, plateau=True)
    make = ttrain.make_ve_train_step if name == "MEMC_Net_VE" else ttrain.make_interp_train_step
    loss = make(model, opt, device="cpu")(*to_torch(args))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    sd = model.state_dict()
    close_elems = total = 0
    for k, want in jparams.items():
        want = np.asarray(want)
        got = sd[k].numpy()
        if "running_" in k:
            np.testing.assert_allclose(got, want, rtol=0, atol=BN_TOL, err_msg=k)
            continue
        diff = np.abs(got - want)
        assert diff.max() <= 2 * STEP_LR * (1 + 1e-3), k
        close_elems += int((diff <= STEP_TOL).sum())
        total += diff.size
    assert close_elems >= 0.99 * total, close_elems / total
