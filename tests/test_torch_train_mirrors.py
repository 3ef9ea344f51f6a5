"""The JAX package's trainer tests (tests/test_train.py), run on the port:
the train steps give finite losses that fall when one example is overfitted,
gradients reach every subnet, the running statistics move, and alpha
[1, 0] leaves the rectifier untrained.  As there: the JAX package's
``init_params(PRNGKey(0))`` weights (carried over by ``load_jax_params``;
the overfit curves of a few Adamax steps depend on the random weights),
frames drawn from the ``rng`` fixture in the same order, float32, B = 1,
128x128; on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.random as jr

from memcnet_tpu import models as JM

from memcnet_tpu_torch import models as TM
from memcnet_tpu_torch import train as ttrain
from memcnet_tpu_torch.io import load_jax_params

H, W = 128, 128  # tests/test_train.py's size


def frames(rng, n, B=1):
    return [torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32)) for _ in range(n)]


def train_model(name):
    flat = {k: np.asarray(v) for k, v in JM.get_model(name).init_params(jr.PRNGKey(0)).items()}
    return load_jax_params(TM.get_model(name), flat).train()


def grads_of(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            for k, p in model.named_parameters()}


def live(grads, keys):
    return sum(int(bool(grads[k].any())) for k in keys)


@pytest.mark.parametrize("name", ["MEMC_Net", "MEMC_Net_star"])
def test_loss_decreases(rng, name):
    model = train_model(name)
    # small lr: Adamax's first update overshoots from random init
    step = ttrain.make_interp_train_step(model, ttrain.make_optimizer(model, lr=1e-4),
                                         device="cpu")
    x0, x2 = frames(rng, 2)
    x1 = (x0 + x2) / 2
    losses = [float(step(x0, x1, x2)) for _ in range(5)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[1], losses
    assert losses[-1] < losses[-2] < losses[-3], losses


def test_grads_cover_all_params(rng):
    """The bulk of star's parameters get a gradient; the ctx conv, whose
    only use is detached, gets none."""
    model = train_model("MEMC_Net_star")
    residuals, *_ = model.train_residuals(*frames(rng, 3))
    sum(r.abs().mean() for r in residuals).backward()
    grads = grads_of(model)
    assert live(grads, grads) > 0.8 * len(grads)
    assert not grads["ctxNet.conv1.weight"].any()


def test_running_stats_update_and_loss_decreases(rng):
    model = train_model("MEMC_Net")
    step = ttrain.make_interp_train_step(model, ttrain.make_optimizer(model, lr=1e-4),
                                         device="cpu")
    x0, x2 = frames(rng, 2)
    x1 = (x0 + x2) / 2
    bn_keys = [k for k in model.state_dict() if k.endswith("running_mean")]
    assert bn_keys, "MEMC_Net must carry BN running stats"
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    losses = [float(step(x0, x1, x2)) for _ in range(4)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[1], losses
    sd = model.state_dict()
    assert all(not torch.allclose(before[k], sd[k]) for k in before)


def test_thin_model_bn_updates(rng):
    model = train_model("MEMC_Net_s")
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    assert any(k.endswith("running_mean") for k in before)
    res, *_ = model.train_residuals(*frames(rng, 3))
    assert len(res) == 2
    sd = model.state_dict()
    assert all(not torch.equal(before[k], sd[k]) for k in before)


def test_ve_step_runs(rng):
    model = train_model("MEMC_Net_VE")
    params_before = {k: p.detach().clone() for k, p in model.named_parameters()}
    bn_before = {k: v.clone() for k, v in model.state_dict().items() if "running_mean" in k}
    step = ttrain.make_ve_train_step(model, ttrain.make_optimizer(model, lr=1e-3),
                                     device="cpu")
    loss = step(frames(rng, 7), frames(rng, 1)[0])
    assert np.isfinite(float(loss))
    named = dict(model.named_parameters())
    assert sum(int(not torch.equal(named[k], v)) for k, v in list(params_before.items())[:20])
    sd = model.state_dict()
    assert bn_before and all(not torch.equal(sd[k], v) for k, v in bn_before.items())


def test_ve_grads_reach_all_subnets_and_loss_decreases(rng):
    """Gradients reach flownets, the ctx conv, EDSR and the filter trunk
    (the residual structure of MEMC_Net_VE.py:270-275), and a few overfit
    steps descend."""
    model = train_model("MEMC_Net_VE")
    window = frames(rng, 7)
    y = window[3] * 0.9 + 0.05
    ttrain.residual_loss(model.train_residuals(window, y)).backward()
    grads = grads_of(model)
    for prefix in ("flownets", "ctxNet", "rectifyNet", "initScaleNets_filter"):
        sub = [k for k in grads if k.startswith(prefix)]
        assert sub, prefix
        assert live(grads, sub) > 0.5 * len(sub), prefix
    step = ttrain.make_ve_train_step(model, ttrain.make_optimizer(model, lr=1e-4),
                                     device="cpu")
    losses = [float(step(window, y)) for _ in range(4)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[1], losses


def test_alpha_1_0_trains_interp_head_only(rng):
    """alpha [1, 0] puts no weight on the rectified residual, so the
    rectifier (reached only by it) gets zero gradients and the rest trains."""
    model = train_model("MEMC_Net")
    residuals, *_ = model.train_residuals(*frames(rng, 3))
    ttrain.residual_loss(residuals, [1.0, 0.0]).backward()
    grads = grads_of(model)
    rect = [k for k in grads if k.startswith("rectifyNet")]
    other = [k for k in grads if not k.startswith("rectifyNet")]
    assert rect and live(grads, rect) == 0
    assert live(grads, other) > 0.8 * len(other)
