"""The card-side measurement script of the port's kernels
(memcnet_tpu_torch/bench/kernel_ab.py), on the CPU: it must time the shapes
that chip_smoke.py checks and the served model runs, and refuse to run
without a card."""

import numpy as np
import torch

import chip_smoke
from memcnet_tpu_torch import probe
from memcnet_tpu_torch.bench import kernel_ab
from memcnet_tpu_torch.models import spynet


def test_kernel_ab_flow_is_chip_smokes():
    """kernel_ab.py loads, by its path, the probe module that chip_smoke.py
    imports, so both time and check the same flow."""
    got = kernel_ab.PROBE.synthetic_flow(1, "cpu")
    want = probe.synthetic_flow(1, "cpu")
    assert got.shape == (1, 2, kernel_ab.H, kernel_ab.W)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_ab_times_spynets_convs_at_every_level():
    assert kernel_ab.BASIC == spynet.BASIC
    assert kernel_ab.LEVELS == spynet.LEVELS
    assert (kernel_ab.H, kernel_ab.W) == (chip_smoke.H, chip_smoke.W) == (probe.H, probe.W)


def test_kernel_ab_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["kernel_ab.py"])
    assert kernel_ab.main() == 1
    assert "CUDA" in capsys.readouterr().err
