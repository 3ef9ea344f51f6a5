"""A data-parallel MEMC_Net step across 2 gloo ranks on the CPU
(tests/torch_mp_workers.py, scenario dp), held against one process: DDP,
BatchNorm synced over the ranks and ZeRO-1 Adamax, equal to the
one-process step on the whole batch in its loss, parameters and running
statistics; the ZeRO-1 state gathered and sliced back; and the 2-rank
checkpoint resumed in one process, equal to the ranks' own next step.

One spawned group, in a module-scoped fixture whose results the cases
read; every join has a timeout of 120 s.  Tolerances: the loss within 1e-5
relative, running statistics within 1e-5, parameters within 1e-6 on at
least 99.9% of their elements and within 2 lr everywhere (Adamax's first
update is about lr * sign(g), so a gradient element that float32 noise
moves across 0 moves its parameter by 2 lr; the ranks sum BatchNorm's
statistics and the gradients in another order than one process).
"""

import numpy as np
import pytest
import torch

from memcnet_tpu_torch.cli.runner import build_model
from memcnet_tpu_torch.io import checkpoint
from memcnet_tpu_torch.train.trainer import Adamax, TrainStep, interp_loss_fn

import torch_mp_workers as W
from test_torch_multiprocess import assert_step_params, few_threads, load_and_remove, spawn


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    ranks = spawn("dp", 2, out)
    batches = W.dp_batches()
    model = build_model("MEMC_Net", seed=0, device="cpu")
    step = TrainStep(model, Adamax(model, lr=W.DP_LR), interp_loss_fn(model), "cpu")
    with few_threads():
        loss = step(*batches[0])
    return dict(ranks=ranks, ckpt=load_and_remove(out / "zero1.pt"), batches=batches, loss=loss,
                model=model, after_one={k: v.clone() for k, v in model.state_dict().items()},
                ranks_after_two=load_and_remove(out / "after_two.pt"))


def test_data_parallel_step_loss_is_the_whole_batch(dp):
    for r in dp["ranks"]:
        np.testing.assert_allclose(float(r["loss"]), float(dp["loss"]), rtol=1e-5)


def test_data_parallel_ranks_hold_equal_models(dp):
    a, b = (r["sums"] for r in dp["ranks"])
    assert torch.equal(a, b)
    # ZeRO-1: each rank keeps about half the state
    for r in dp["ranks"]:
        assert r["state_numel"] < 0.51 * r["whole_numel"]


def test_zero1_state_dict_reloads_into_the_shards(dp):
    """ZeroAdamax.load_state_dict slices the gathered state back into each
    rank's shards, equal to the ones it held."""
    assert all(r["reloaded_equal"] for r in dp["ranks"])


@pytest.mark.parametrize("part", ["parameters", "running statistics"])
def test_data_parallel_step_equals_one_process_step(dp, part):
    got, want = dp["ckpt"]["params"], dp["after_one"]
    stats = {k for k in want if "running_" in k}
    assert stats  # MEMC_Net's BatchNorm trunks
    if part == "parameters":
        assert_step_params(got, {k: v for k, v in want.items()
                                 if k not in stats and "num_batches" not in k}, W.DP_LR)
    else:
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
            assert not torch.equal(want[k], torch.zeros_like(want[k]) if "mean" in k
                                   else torch.ones_like(want[k])), k  # the step moved it


def test_zero1_checkpoint_resumes_in_one_process(dp):
    """The 2-rank ZeRO-1 checkpoint after one step (the whole state,
    gathered) loads into one process's Adamax, and the next step there
    equals the ranks' own next step."""
    ckpt = dp["ckpt"]
    model = dp["model"]  # reused: its own state is overwritten by the checkpoint's
    checkpoint.load_params(model, ckpt["params"])
    opt = Adamax(model, lr=W.DP_LR)
    opt.load_state_dict(ckpt["opt_state"])
    assert opt.count == 1 and ckpt["step"] == 1
    for n, p in model.named_parameters():
        assert tuple(opt.mu[opt.names.index(n)].shape) == tuple(p.shape)
    with few_threads():
        loss = TrainStep(model, opt, interp_loss_fn(model), "cpu")(*dp["batches"][1])
    np.testing.assert_allclose(float(loss), float(dp["ranks"][0]["loss_2"]), rtol=1e-5)
    want = dp["ranks_after_two"]
    assert_step_params(model.state_dict(), {k: v for k, v in want.items()
                                            if "running_" not in k and "num_batches" not in k},
                       W.DP_LR)


# -- the sharded MEMC_Net_star step ----------------------------------------------------
