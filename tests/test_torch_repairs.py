"""Two places where the port refused what the JAX package does: the demos'
flags and resuming a training run.

  * Every flag of the JAX demos (one per field of the JAX ``Config``) is
    accepted by each of the port's demos; those the port does not read are
    dropped, and --lr, --epsilon and --alpha set the port's own fields.
  * A run resumed from ``step_N.pt`` (model and ``Adamax`` state loaded into
    a fresh model and optimizer) equals N + M steps run straight: float32
    on the CPU, losses and parameters within 1e-6.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from memcnet_tpu.utils import config as jax_config

from memcnet_tpu_torch import probe
from memcnet_tpu_torch.cli import demo_hd720p, demo_middlebury, demo_vimeo_ve
from memcnet_tpu_torch.cli.runner import build_model
from memcnet_tpu_torch.data.vimeo90k import VimeoTriplet
from memcnet_tpu_torch.io import checkpoint
from memcnet_tpu_torch.train import trainer
from memcnet_tpu_torch.utils import config as torch_config

RESUME_TOL = 1e-6

VALUES = {"net_name": "MEMC_Net_s", "dtype": "bfloat16", "task": "sr", "lr": "0.25",
          "epsilon": "1e-4", "alpha": "1.0,0.5"}
BY_TYPE = {"int": "2", "float": "0.5", "str": "x", "Optional[str]": "x",
           "Sequence[float]": "3.0,1.0"}


def jax_flags():
    """Every flag of the JAX demos with a value of its field's type."""
    argv = []
    for f in dataclasses.fields(jax_config.Config):
        argv += ["--" + f.name.replace("_", "-"),
                 VALUES.get(f.name, BY_TYPE[jax_config._type_key(f.type)])]
    return argv


@pytest.mark.parametrize("demo,own", [
    (demo_hd720p, ["--yuv", "in.yuv"]),
    (demo_middlebury, ["--data-dir", "d"]),
    (demo_vimeo_ve, ["--root", "r"]),
])
def test_demos_accept_every_jax_flag(demo, own, monkeypatch):
    seen = []
    monkeypatch.setattr(demo, "run", lambda cfg, *a, **k: seen.append(cfg))
    demo.main(own + jax_flags() + ["--device", "cpu"])
    (cfg,) = seen
    assert isinstance(cfg, torch_config.Config)
    assert cfg.lr == 0.25 and cfg.epsilon == 1e-4 and cfg.alpha == (1.0, 0.5)
    assert cfg.seed == 2 and cfg.uid == "x" and cfg.dtype == "bfloat16"
    dropped = set(torch_config.JAX_ONLY_FIELDS)
    assert dropped == {f.name for f in dataclasses.fields(jax_config.Config)} - {
        f.name for f in dataclasses.fields(torch_config.Config)}
    assert not dropped & set(dataclasses.asdict(cfg))


def test_config_from_args_drops_the_jax_only_flags():
    ap = torch_config.add_config_args(argparse.ArgumentParser())
    args = ap.parse_args(["--batch-size", "4", "--num-epoch", "3", "--lr", "1e-3"])
    assert args.batch_size == "4"
    assert torch_config.config_from_args(args) == torch_config.Config(lr=1e-3)


# ---------------------------------------------------------------- resume


def run_fit(model, batches, steps, **kw):
    opt, step = trainer.build_interp_trainer(model, torch_config.Config(lr=1e-4),
                                             device="cpu", patience=1)
    return opt, trainer.fit(step, iter(batches), steps=steps, **kw)


def test_resumed_run_equals_a_straight_run(tmp_path):
    N, M = 2, 2
    root = probe.write_vimeo(str(tmp_path / "vimeo"), 2, 64, 96, seed=3)
    it = VimeoTriplet(root, crop=(64, 64), seed=0).batches(1)
    batches = [next(it) for _ in range(N + M)]

    straight = build_model("MEMC_Net_s", seed=2, device="cpu")
    opt_s, hist_s = run_fit(straight, batches, N + M)

    first = build_model("MEMC_Net_s", seed=2, device="cpu")
    _, hist_1 = run_fit(first, batches, N, eval_every=N, checkpoint_dir=str(tmp_path / "ck"),
                        log=lambda _: None)
    ck = checkpoint.load(str(tmp_path / "ck" / f"step_{N}.pt"))
    resumed = checkpoint.load_params(build_model("MEMC_Net_s", seed=9, device="cpu"),
                                     ck["params"])
    opt_r, step_r = trainer.build_interp_trainer(resumed, torch_config.Config(lr=1e-4),
                                                 device="cpu", patience=1)
    opt_r.load_state_dict(ck["opt_state"])
    assert opt_r.count == N
    hist_2 = trainer.fit(step_r, iter(batches[N:]), steps=M)

    np.testing.assert_allclose(hist_1 + hist_2, hist_s, rtol=0, atol=RESUME_TOL)
    for (k, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), rtol=0,
                                   atol=RESUME_TOL, err_msg=k)
    assert opt_r.count == opt_s.count == N + M
    assert (opt_r.best, opt_r.plateau_count, float(opt_r.scale)) == \
        (opt_s.best, opt_s.plateau_count, float(opt_s.scale))
    for a, b in zip(opt_r.nu, opt_s.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=RESUME_TOL)


def test_load_state_dict_refuses_a_wrong_name_or_shape():
    params = {"a": torch.zeros(3, requires_grad=True), "b": torch.zeros(2, 2, requires_grad=True)}
    opt = trainer.Adamax(params, plateau=True)
    sd = opt.state_dict()
    sd["mu"]["a"] = torch.full((3,), 0.5, dtype=torch.float64)
    sd["plateau"].update(best=1.5, plateau_count=2, scale=0.2)
    fresh = trainer.Adamax(params, plateau=True)
    fresh.load_state_dict(sd)
    assert fresh.mu[0].dtype == torch.float32 and float(fresh.mu[0][0]) == 0.5
    assert fresh.best == np.float32(1.5) and fresh.plateau_count == 2
    assert float(fresh.scale) == pytest.approx(0.2)
    for mutate, err in ((lambda s: s["nu"].pop("b"), KeyError),
                        (lambda s: s["mu"].__setitem__("c", torch.zeros(1)), KeyError),
                        (lambda s: s["nu"].__setitem__("b", torch.zeros(4)), ValueError)):
        bad = trainer.Adamax(params).state_dict()
        mutate(bad)
        with pytest.raises(err):
            trainer.Adamax(params).load_state_dict(bad)
