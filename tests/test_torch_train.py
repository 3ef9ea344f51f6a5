"""CPU parity of the port's training layers with the JAX package: train-mode
BatchNorm, FlowNetS's multi-scale train output, the losses, the Adamax
optimizer against the optax chain, the config's trainer fields and ``fit``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 BatchNorm within 1e-5 (output, running statistics and
gradients; the same float32 arithmetic summed in another order); bf16
BatchNorm within 2^-7 of each output's largest magnitude (one bf16 rounding
of values computed in float32 apart); FlowNetS's scales within 1e-4 of each
output's scale (tests/test_torch_models.py); losses within 1e-6; the
optimizer's parameters within 1e-6 of optax's after each of 8 steps (float32
elementwise arithmetic; torch may fuse a multiply-add that XLA rounds
twice), its plateau state exactly.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from memcnet_tpu.models import flownets as jflownets
from memcnet_tpu.models import mononet as jmono
from memcnet_tpu.nn import layers as JL
from memcnet_tpu.train import loss as jloss
from memcnet_tpu.train import trainer as jtrainer
from memcnet_tpu.utils import config as jax_config

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch import probe
from memcnet_tpu_torch import train as ttrain
from memcnet_tpu_torch.cli.runner import build_model
from memcnet_tpu_torch.data.vimeo90k import VimeoTriplet
from memcnet_tpu_torch.io import checkpoint, load_jax_params
from memcnet_tpu_torch.models import flownets, mononet
from memcnet_tpu_torch.nn import layers as L
from memcnet_tpu_torch.ops.cuda import conv_kernel
from memcnet_tpu_torch.train import trainer as ttrainer
from memcnet_tpu_torch.utils import config as torch_config

from test_torch_models import ATOL, close, numpy_params, state_shapes, to_jax

BN_TOL = 1e-5
OPT_TOL = 1e-6


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 24), (2, 64, 2, 4), (1, 5, 1, 1)])
def test_batch_norm_train_matches_jax(rng, dtype, shape):
    """Output, new running statistics and the gradients of x, gamma and
    beta; float32 statistics whatever the input type, the running statistics
    in their own type, none of them differentiable."""
    C = shape[1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    m = rng.randn(C).astype(np.float32)
    v = (rng.rand(C) + 0.5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def f(x, g, b):
        y, nm, nv = JL.batch_norm_train(x, g, b, jnp.asarray(m, jdt), jnp.asarray(v, jdt))
        return jnp.sum(y.astype(jnp.float32) * r), (y, nm, nv)

    (_, (jy, jnm, jnv)), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (x, g, b)))
    tx, tg, tb = (t(a).to(tdt).requires_grad_() for a in (x, g, b))
    rm, rv = t(m).to(tdt), t(v).to(tdt)
    y, nm, nv = L.batch_norm_train(tx, tg, tb, rm, rv)
    assert y.dtype == tdt and nm.dtype == tdt and nv.dtype == tdt
    assert not nm.requires_grad and not nv.requires_grad
    (y.float() * t(r)).sum().backward()
    tol = BN_TOL if dtype == "float32" else 2.0 ** -7
    for got, want in [(y, jy), (nm, jnm), (nv, jnv), (tx.grad, jgrads[0]),
                      (tg.grad, jgrads[1]), (tb.grad, jgrads[2])]:
        close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("variant", ["full", "thin"])
def test_mononet_train_mode_writes_the_jax_bn_updates(rng, variant):
    """A BN trunk in train mode -- MEMC_Net's paired trunk as one groups=2
    walk, MEMC_Net_s's thin trunk alone: the outputs and the running
    statistics written into each BatchNorm equal the JAX walk's outputs and
    its ``bn_updates``, key for key; eval mode then reads the new
    statistics, and no parameter changes."""
    specs = jmono.mononet5_specs(3, variant, True)
    names = ("a", "b") if variant == "full" else ("a",)
    mods = torch.nn.ModuleDict({n: mononet.build_modulelist(specs) for n in names})
    flat = numpy_params({k: v for k, v in state_shapes(mods).items()
                         if "num_batches_tracked" not in k}, 5)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    load_jax_params(mods, flat)
    x = rng.rand(2, 6, 64, 64).astype(np.float32)

    def jax_walk(params, **kw):
        if variant == "full":
            return jmono.forward_dual_path(params, "a", "b", specs, jnp.asarray(x), **kw)
        return (jmono.forward_single_path(params, "a", specs, jnp.asarray(x), **kw),)

    def walk():
        if variant == "full":
            return mononet.forward_dual_path(mods["a"], mods["b"], specs, t(x))
        return (mononet.forward_single_path(mods["a"], specs, t(x)),)

    upd = {}
    want = jax_walk(to_jax(flat), training=True, bn_updates=upd)
    mods.train()
    params_before = {k: p.detach().clone() for k, p in mods.named_parameters()}
    for g, w in zip(walk(), want):
        close(g.detach(), w, ATOL)
    sd = mods.state_dict()
    assert set(upd) == {k for k in sd if "running_" in k}
    for k, v in upd.items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(v), rtol=0, atol=BN_TOL)
    for k, p in mods.named_parameters():
        assert torch.equal(p.detach(), params_before[k])
    mods.eval()
    want = jax_walk(to_jax({k: np.asarray(v) for k, v in {**flat, **upd}.items()}))
    with torch.no_grad():
        for g, w in zip(walk(), want):
            close(g, w, ATOL)


def test_flownets_training_returns_every_scale(rng):
    net = flownets.FlowNetS()
    flat = numpy_params(state_shapes(net, "flownets."), 1)
    load_jax_params(torch.nn.ModuleDict({"flownets": net}), flat)
    x = rng.rand(2, 6, 64, 128).astype(np.float32)
    want = jflownets.forward(to_jax(flat), jnp.asarray(x), training=True)
    with torch.no_grad():
        got = net(t(x), training=True)
        assert torch.equal(got[0], net(t(x)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g, w, ATOL)


# ---------------------------------------------------------------- losses


def test_losses_match_jax(rng):
    res = [rng.randn(2, 3, 8, 8).astype(np.float32) * s for s in (1.0, 1e-6, 0.3)]
    for eps in (1e-6, 0.1):
        for r in res:
            np.testing.assert_allclose(float(ttrain.charbonnier(t(r), eps)),
                                       float(jloss.charbonnier(jnp.asarray(r), eps)),
                                       rtol=OPT_TOL)
    np.testing.assert_allclose(float(ttrain.l1(t(res[0]))), float(jloss.l1(jnp.asarray(res[0]))),
                               rtol=OPT_TOL)
    for alpha in (None, [1.0, 0.0, 0.5]):
        got = ttrain.residual_loss([t(r) for r in res], alpha)
        want = jloss.residual_loss([jnp.asarray(r) for r in res], alpha)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL)
    got = ttrain.residual_loss([t(r).bfloat16() for r in res])
    assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        ttrain.residual_loss([t(r) for r in res], [1.0, 0.0])


# ---------------------------------------------------------------- optimizer

OPT_SHAPES = {"flownets.conv1.0.weight": (4, 3, 3, 3), "flownets.predict_flow2.weight": (2, 6),
              "initScaleNets_filter.0.weight": (5, 3), "initScaleNets_occlusion.2.bias": (7,),
              "rectifyNet.0.weight": (3, 4), "ctxNet.conv1.weight": (4, 2)}
NO_GRAD = "ctxNet.conv1.weight"  # as star's ctx conv, whose only use is detached
CONFIGS = {
    # clipping that fires on the large steps, weight decay, subnet LRs and a
    # plateau that fires at step `patience` exactly
    "all": dict(lr=1e-2, weight_decay=1e-2, clip_norm=1.0, subnet_lr=True, plateau=True,
                patience=2, factor=0.5),
    "upstream": dict(lr=2e-3, subnet_lr=True, plateau=True),
    "plain": dict(lr=1e-3),
    "subnet_dict": dict(lr=1e-2, subnet_lr={"rectifyNet": 0.5, "flownets.conv1": 0.1}),
}
# the first loss improves on inf, the next two do not (plateau count 2 ==
# patience at step 3), then one improves and three do not
LOSSES = [1.0, 1.0, 0.9999, 0.9, 0.95, 0.8999, 0.93, 0.5]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_optimizer_matches_optax(config):
    """8 steps of ``make_optimizer`` against the JAX package's optax chain on
    fed gradients and losses: the parameters after every step within
    OPT_TOL, the plateau's scale exactly; the parameter without a gradient
    takes optax's zero gradient."""
    kw = CONFIGS[config]
    rng = np.random.RandomState(7)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    jopt = jtrainer.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = ttrain.make_optimizer(tp, **kw)
    scales, clipped = [], 0
    for i, loss in enumerate(LOSSES):
        g = {k: rng.randn(*s).astype(np.float32) * (4.0 if i % 2 else 0.05)
             for k, s in OPT_SHAPES.items()}
        g[NO_GRAD] = np.zeros(OPT_SHAPES[NO_GRAD], np.float32)
        clipped += np.sqrt(sum((v ** 2).sum() for v in g.values())) >= kw.get("clip_norm", np.inf)
        up, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                                 value=jnp.float32(loss))
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            p.grad = None if k == NO_GRAD else t(g[k])
        topt.step(loss)
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=OPT_TOL, err_msg=f"{config} step {i} {k}")
        if kw.get("plateau"):
            jscale = float(jstate[-1].scale) if isinstance(jstate, tuple) else None
            assert float(topt.scale) == jscale
            scales.append(float(topt.scale))
    assert topt.count == len(LOSSES)
    if kw.get("weight_decay"):
        assert not np.allclose(tp[NO_GRAD].detach().numpy(), p0[NO_GRAD])
    if kw.get("clip_norm"):
        assert 0 < clipped < len(LOSSES)
    if config == "all":
        # patience 2: steps 1 and 2 do not improve (0.9999 is not below
        # (1 - 1e-4) * 1.0), so step 2's update is halved; step 5 improves
        # on 0.9 by just over the tolerance, so no second reduction
        assert scales == [1.0, 1.0] + [0.5] * 6, scales


def test_plateau_reduces_at_patience_where_torch_waits_one_step():
    """With constant losses and patience 2, optax (and the port) scale the
    update of the 3rd step by the factor: the step that counts the 2nd
    non-improvement.  torch's ReduceLROnPlateau, stepped after the update,
    would change the 4th."""
    losses = [1.0] * 6
    opt = jtrainer.make_optimizer(lr=1.0, plateau=True, patience=2, factor=0.5)
    jp = {"w": jnp.ones(2)}
    st = opt.init(jp)
    want = []
    for loss in losses:
        up, st = opt.update({"w": jnp.ones(2)}, st, jp, value=jnp.float32(loss))
        want.append(abs(float(up["w"][0])))
    w = torch.ones(2, requires_grad=True)
    topt = ttrain.make_optimizer({"w": w}, lr=1.0, plateau=True, patience=2, factor=0.5)
    got = []
    for loss in losses:
        before = w.detach().clone()
        w.grad = torch.ones(2)
        topt.step(loss)
        got.append(abs(float((w.detach() - before)[0])))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == pytest.approx(1.0) and got[2] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        topt.step()  # the plateau needs the loss


def test_subnet_lr_scaling():
    """my_args.py:44's flow_lr_coe: flownets' update is 0.01 of the filter's."""
    params = {"flownets.c.w": torch.ones(4, requires_grad=True),
              "initScaleNets_filter.0.w": torch.ones(4, requires_grad=True)}
    opt = ttrain.make_optimizer(params, lr=1e-2, subnet_lr=True)
    for p in params.values():
        p.grad = torch.ones(4)
    opt.step()
    d = {k: 1.0 - float(p.detach()[0]) for k, p in params.items()}
    assert abs(d["flownets.c.w"] / d["initScaleNets_filter.0.w"] - 0.01) < 1e-4
    assert ttrainer.subnet_coef("spynet.x", ttrainer.SUBNET_LR) == 0.01
    assert ttrainer.subnet_coef("rectifyNet.0.weight", ttrainer.SUBNET_LR) == 1.0


def test_updates_bump_version_so_k4_repacks_bf16_weights():
    """K4's bf16 packed weights are cached by (pointer, version): the
    optimizer updates in place through the version counter, so the next
    launch packs the updated weights (a ``p.data`` update would not bump it
    and the kernel would read stale weights)."""
    w = torch.randn(64, 3, 7, 7).bfloat16().requires_grad_()
    opt = ttrain.make_optimizer({"ctxNet.conv1.weight": w}, lr=0.1)
    packed, _ = conv_kernel._prepared_weights(w, torch.bfloat16)
    version = w._version
    w.grad = torch.ones_like(w)
    opt.step()
    assert w._version > version
    repacked, sums = conv_kernel._prepared_weights(w, torch.bfloat16)
    assert not torch.equal(repacked, packed)
    assert torch.equal(repacked, conv_kernel.pack_weights(w.detach(), torch.bfloat16))
    assert torch.equal(sums, conv_kernel.abs_weight_sums(w.detach(), torch.bfloat16))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("values", [{}, {"lr": "1e-3", "epsilon": "1e-5", "alpha": "1.0,0.5"},
                                    {"lr": 5e-4, "alpha": (0.25, 0.75)}])
def test_config_trainer_fields_match_jax(values):
    """lr, epsilon and alpha: the JAX defaults and coercions (alpha's comma
    form); the demos' parsers take them, as the JAX demos' do."""
    cfgs = [dataclasses.asdict(mod.config_from_args(argparse.Namespace(**values)))
            for mod in (torch_config, jax_config)]
    for k in torch_config.TRAINER_FIELDS:
        assert cfgs[0][k] == cfgs[1][k], k
    assert cfgs[0]["alpha"] == tuple(cfgs[0]["alpha"])
    flags = vars(torch_config.add_config_args(argparse.ArgumentParser()).parse_args([]))
    assert set(torch_config.TRAINER_FIELDS) <= set(flags)


# ---------------------------------------------------------------- the step and fit


def test_train_step_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """Without CUDA a step raises unless the caller asks for the CPU, and a
    step refuses a model on another device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model("MEMC_Net_s", device="cpu")
    opt = ttrain.make_optimizer(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.make_interp_train_step(model, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.build_interp_trainer(model)
    with pytest.raises(ValueError, match="move the model"):
        ttrainer.TrainStep(model.to("meta"), opt, lambda: None, device="cpu")


def test_train_residuals_needs_train_mode():
    model = build_model("MEMC_Net_s", device="cpu")
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(RuntimeError, match="model.train"):
        model.train_residuals(x, x, x)
    ve = TM.get_model("MEMC_Net_VE").eval()
    with pytest.raises(RuntimeError, match="model.train"):
        ve.train_residuals([x] * 7, x)


def test_fit_over_vimeo_triplets_writes_checkpoints(tmp_path):
    """``build_interp_trainer`` + ``fit`` over a ``probe.write_vimeo`` tree
    read by VimeoTriplet: finite losses, a log line and a checkpoint every
    ``eval_every`` steps, and the checkpoint read back equals the model and
    the optimizer state."""
    root = probe.write_vimeo(str(tmp_path / "vimeo"), 2, 64, 96, seed=3)
    ds = VimeoTriplet(root, crop=(64, 64), seed=0)
    assert len(ds) == 2
    model = build_model("MEMC_Net_s", seed=2, device="cpu")
    cfg = torch_config.Config(lr=1e-4, alpha=(1.0, 0.0))
    opt, step = ttrainer.build_interp_trainer(model, cfg, device="cpu")
    assert opt.plateau and opt.coefs is not None and opt.lr == 1e-4 and not opt.clip_norm
    lines = []
    hist = ttrainer.fit(step, ds.batches(1), steps=4, eval_every=2,
                        eval_fn=lambda m: 0.5, checkpoint_dir=str(tmp_path / "ckpt"),
                        log=lines.append)
    assert len(hist) == 4 and all(np.isfinite(hist))
    assert lines == [f"step 2: loss {hist[1]:.5f}, eval 0.5000",
                     f"step 4: loss {hist[3]:.5f}, eval 0.5000"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2.pt", "step_4.pt"]
    ck = checkpoint.load(str(tmp_path / "ckpt" / "step_4.pt"))
    assert ck["step"] == 4 and ck["opt_state"]["count"] == 4
    fresh = checkpoint.load_params(build_model("MEMC_Net_s", seed=9, device="cpu"),
                                   ck["params"])
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    for k, p in model.named_parameters():
        assert torch.equal(ck["opt_state"]["mu"][k], opt.mu[opt.names.index(k)])

    def boom(*_):
        return torch.tensor(float("nan"))

    with pytest.raises(FloatingPointError, match="diverged at step 0"):
        ttrainer.fit(boom, ds.batches(1), steps=1)
