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
from memcnet_tpu_torch.ops.cuda import gather_kernel


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


def test_probe_level_flow_and_prologue_fit_every_spynet_level():
    """probe.level_flow gives the coarse flow of each 720p SPyNet level, and
    probe.level_prologue (the separate ops that chip_smoke.py and
    kernel_ab.py time against the fused level input) computes what the
    fused level input's plain version computes."""
    for lvl in range(spynet.LEVELS):
        flow = probe.level_flow(1, lvl, "cpu")
        assert flow.shape == (1, 2, (probe.H >> lvl) // 2, (probe.W >> lvl) // 2)
    assert float(probe.level_flow(1, 5, "cpu").abs().max()) > 20.0  # an out-of-frame block
    rng = np.random.RandomState(0)
    fst, snd = (torch.from_numpy(rng.rand(1, 3, 24, 42).astype(np.float32)) for _ in range(2))
    flow = probe.level_flow(1, 5, "cpu")
    assert torch.equal(probe.level_prologue(fst, snd, flow),
                       gather_kernel.level_input_reference(fst, snd, flow))


def test_chip_smoke_serves_ve_at_the_vimeo_window():
    """chip_smoke.py serves MEMC_Net_VE on seven 256x448 frames, which pad to
    the 320x512 window its kernel checks run at, with one K1 and one K4
    launch per window."""
    from memcnet_tpu_torch.data import pad_plan

    left, right, top, bottom = pad_plan(chip_smoke.VE_FRAME_H, chip_smoke.VE_FRAME_W)
    assert (chip_smoke.VE_FRAME_H + top + bottom, chip_smoke.VE_FRAME_W + left + right) == (
        chip_smoke.VE_H, chip_smoke.VE_W) == (320, 512)
    assert chip_smoke.EXPECTED_PER_FRAME["MEMC_Net_VE"] == {
        "filter_interp_warp": 1, "base_scatter": 0, "fill_holes": 0, "conv2d_small": 1,
        "grid_sample": 0}
    frames = chip_smoke.synthetic_window(0, 40, 60)
    assert len(frames) == 7 and all(f.shape == (3, 40, 60) for f in frames)
    assert all(not np.array_equal(frames[3], f) for t, f in enumerate(frames) if t != 3)


def test_probe_flow_at_the_ve_window_keeps_its_blocks():
    """synthetic_flow at another size keeps its +-20 px field and its
    out-of-frame blocks; at the default size it is the 720p flow."""
    flow = probe.synthetic_flow(1, "cpu", size=(320, 512))
    assert flow.shape == (1, 2, 320, 512)
    assert int((flow[0, 0] == 2000.0).sum()) == (58 - 41) * (114 - 76)
    assert int((flow[0, 1] == -900.0).sum()) == (258 - 250) * (34 - 19)
    smooth = flow[0, 0][flow[0, 0] != 2000.0]
    assert 15.0 < float(smooth.abs().max()) <= 20.0
    assert probe.synthetic_flow(1, "cpu").shape == (1, 2, probe.H, probe.W)
