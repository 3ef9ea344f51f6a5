"""The reference agrees with the program's CPU path; the control and the
faults a run can have come out not correct.

Each test drives ``run.run_cell`` on the CPU -- everything a run does but
its look for a card -- at a small frame (100x200, padded to 128x256) with
the cell's own traffic and limits.  Here, not in the reference, the program
is imported."""

import pytest
import torch

from benchmark import check, run as R

SMALL = dict(frame=[100, 200], clip_frames=6, warmup_batches=1, sample_frames=4)


def small_run(cell, seed=7, **kw):
    torch.set_num_threads(4)
    _, _, config, traffic = R.load_cell(cell)
    traffic = dict(traffic, **SMALL)
    return config, R.run_cell(config, traffic, seed=seed, seconds=0.01, device="cpu", **kw)


def correct(config, out):
    return check.judge(config["compare"], out.readings, out.complete)[0]


@pytest.mark.parametrize("cell", ["s_f32_720p_stream", "s_f32_720p_live"])
def test_float32_program_matches_the_reference(cell):
    config, out = small_run(cell, control=True)
    assert out.sampled == min(4, out.window.frames) >= 1 and out.complete
    assert out.readings["rms_rel"] < 1e-5 and out.readings["max_rel"] < 1e-3
    assert correct(config, out)
    # the control (TF32 operands) fails a limit
    assert any(out.control[k] > config["compare"][k] for k in config["compare"])


def test_star_control_fails_its_limits():
    config, out = small_run("star_bf16_720p_live", control=True)
    assert out.sampled == out.window.frames >= 1 and out.complete
    assert any(out.control[k] > config["compare"][k] for k in config["compare"])


class HalfBatch(torch.nn.Module):
    """The forward runs the first half of the batch; the rest repeat it."""

    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, x0, x2):
        n = max(1, x0.shape[0] // 2)
        (interp, rect), *rest = self.core(x0[:n], x2[:n])
        rep = (x0.shape[0] + n - 1) // n
        return ((interp.repeat(rep, 1, 1, 1)[:x0.shape[0]],
                 rect.repeat(rep, 1, 1, 1)[:x0.shape[0]]), *rest)


class Altered(torch.nn.Module):
    """Each frame altered where it is produced: shifted by one pixel."""

    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, x0, x2):
        (interp, rect), *rest = self.core(x0, x2)
        return ((interp, torch.roll(rect, 1, dims=-1)), *rest)


# the faults each cell can have: a live cell's batch is one pair, none to leave out
FAULTS = [(cell, fault) for cell in ("s_f32_720p_stream", "star_bf16_720p_stream")
          for fault in (HalfBatch, Altered)]
FAULTS += [(cell, Altered) for cell in ("s_f32_720p_live", "star_bf16_720p_live")]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_faults_come_out_not_correct(cell, fault):
    config, out = small_run(cell, wrap=fault)
    assert out.complete and out.sampled >= 1 and not correct(config, out)


@pytest.mark.parametrize("cell", ["star_bf16_720p_stream", "star_bf16_720p_live"])
def test_star_program_within_its_limits(cell):
    config, out = small_run(cell)
    assert correct(config, out), out.readings
