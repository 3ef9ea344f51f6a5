"""Samples of ``benchmark/driver.py``: a sample is a window of the call's INPUTS frames,
``pair_gap`` apart; a pair is the window of two.  Driven on the CPU."""

import sys
import types

import pytest
import torch

from benchmark import check, clip, driver, run as R
from benchmark.calls import memc_pair, memc_window


class Recorder(torch.nn.Module):
    """A pair model that returns its inputs and keeps them."""

    def __init__(self):
        super().__init__()
        self.sent = []

    def forward(self, x0, x2):
        self.sent.append((x0[:, 0, 0, 0].tolist(), x2[:, 0, 0, 0].tolist()))
        return (x0, x2), None


# one cycle over an 18-frame clip, pairs (i, i + 2): the first frames of each forward
CYCLES = {
    "stream": [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15]],
    "live": [[i] for i in range(16)],
}


@pytest.mark.parametrize("traffic_name", sorted(CYCLES))
def test_a_pair_is_a_window_of_two(traffic_name):
    traffic = R.load_json(f"{R.HERE}/traffic/{traffic_name}.json")
    assert traffic["clip_frames"] == 18 and traffic["pair_gap"] == 2
    traffic = dict(traffic, frame=[8, 8])  # padded to 128 x 128
    n = traffic["clip_frames"]
    frames = torch.arange(n, dtype=torch.float32).view(n, 1, 1, 1).expand(n, 3, 128, 128)
    model = Recorder()
    drv = driver.Driver(model, memc_pair, frames.contiguous(), traffic, "cpu")
    cycle = CYCLES[traffic_name]
    assert [idx for idx, _ in drv.cycle] == cycle
    shown = []
    win = drv.run(frames=n - 2, sampler=lambda idx, buf: shown.append(
        (idx, buf[:, 0, 0, 0].tolist())))
    assert win.attempted == win.frames == n - 2
    assert model.sent == [([float(i) for i in b], [float(i + 2) for i in b]) for b in cycle]
    # the frame a sample returns here is its second input: the sample is keyed by its first
    assert shown == [(b, [float(i + 2) for i in b]) for b in cycle]


def test_memc_pair_is_the_pair_models_call():
    from memcnet_tpu_torch.models import get_model

    torch.manual_seed(0)
    m = get_model("MEMC_Net_s").init_params(torch.Generator().manual_seed(3)).eval()
    x0, x2 = torch.rand((2, 1, 3, 64, 128)).unbind(0)
    with torch.inference_mode():
        assert torch.equal(memc_pair.rectified(m, [x0, x2]), m(x0, x2)[0][1])


class Toy7(torch.nn.Module):
    """Seven frames to one: a 1x1 conv over the window's 21 channels."""

    def __init__(self, filter_size=4, channel=3):
        super().__init__()
        self.mix = torch.nn.Conv2d(7 * channel, channel, 1, bias=False)
        self.seen = []

    def forward(self, frames):
        self.seen.append([f.clone() for f in frames])
        return self.mix(torch.cat(frames, 1))


class Swapped(torch.nn.Module):
    """Input 2 of each window replaced by input 3's frame."""

    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, frames):
        return self.core(frames[:2] + [frames[3]] + frames[3:])


TOY_CONFIG = {
    "model": "Toy7", "reference": "toy7", "call": "memc_window",
    "filter_size": 4, "channel": 3, "dtype": "float32",
    "allow_tf32": {"cudnn": False, "matmul": False},
    "init": [{"match": "mix\\.weight", "init": "kaiming_uniform"}],
    "control": "tf32", "compare": {"max_rel": 1e-6},
}
TOY_TRAFFIC = {"frame": [100, 200], "clip_frames": 16, "pair_gap": 2, "batch": 2,
               "in_flight": 1, "warmup_batches": 1, "sample_frames": 4, "trace_frames": 4}


@pytest.fixture
def toy(monkeypatch):
    """run_cell on Toy7 and its reference: (run, the model, the reference's windows)."""
    import memcnet_tpu_torch.models as models

    built, windows = [], []

    def get_model(name, **kw):
        assert name == "Toy7"
        built.append(Toy7(**kw))
        return built[-1]

    def forward(p, *frames):
        windows.append([f.clone() for f in frames])
        return p.conv(torch.cat(frames, 1), "mix", padding=0, bias=False)

    ref = types.ModuleType("benchmark.reference.toy7")
    ref.forward = forward
    monkeypatch.setattr(models, "get_model", get_model)
    monkeypatch.setitem(sys.modules, "benchmark.reference.toy7", ref)

    def run(**kw):
        out = R.run_cell(TOY_CONFIG, TOY_TRAFFIC, seed=2**31 + 11, seconds=1.0,
                         device="cpu", **kw)
        return out, built[-1], windows

    return run


def window_starts(window, frames, gap):
    """The first frame s of a window whose input j is frames[s + j * gap]."""
    starts = []
    for b in range(window[0].shape[0]):
        s = next(i for i in range(frames.shape[0]) if torch.equal(window[0][b], frames[i]))
        assert all(torch.equal(x[b], frames[s + j * gap]) for j, x in enumerate(window))
        starts.append(s)
    return starts


def test_a_seven_frame_window_runs_and_checks(toy):
    out, model, windows = toy()
    g = TOY_TRAFFIC["pair_gap"]
    frames = clip.make(2**31 + 11, TOY_TRAFFIC["clip_frames"], *TOY_TRAFFIC["frame"], "cpu")
    assert out.complete and out.sampled == min(4, out.window.frames) >= 1
    assert check.judge(TOY_CONFIG["compare"], out.readings, out.complete)[0]
    # the program's windows and the reference's, read at offsets 0, g, ... 6g
    samples = TOY_TRAFFIC["clip_frames"] - 6 * g
    sent = [window_starts(w, frames, g) for w in model.seen]
    cycle = [[0, 1], [2, 3]]  # samples 0-3, two a forward
    assert samples == 4 and sent == [[0, 1]] + [cycle[k % 2] for k in range(len(sent) - 1)]
    checked = [s for w in windows for s in window_starts(w, frames, g)]
    assert len(checked) == len(windows) >= 1 and set(checked) <= set(range(samples))


def test_a_window_with_an_input_swapped_fails_the_check(toy):
    out, _, _ = toy(wrap=Swapped)
    assert out.complete and out.sampled == min(4, out.window.frames) >= 1
    assert not check.judge(TOY_CONFIG["compare"], out.readings, out.complete)[0]


def test_memc_net_ve_runs_through_memc_window():
    from memcnet_tpu_torch.models import get_model

    torch.set_num_threads(4)
    m = get_model("MEMC_Net_VE").init_params(torch.Generator().manual_seed(5)).eval()
    traffic = {"frame": [100, 200], "clip_frames": 8, "pair_gap": 1, "batch": 1,
               "in_flight": 1}
    frames = clip.make(5, traffic["clip_frames"], 100, 200, "cpu")
    assert frames.shape[2:] == (128, 256)
    drv = driver.Driver(m, memc_window, frames, traffic, "cpu")
    shown = []
    win = drv.run(frames=2, sampler=lambda idx, buf: shown.append((idx, buf.clone())))
    assert win.attempted == win.frames == 2 and len(win.enqueue_ms) == 2
    assert [idx for idx, _ in shown] == [[0], [1]]
    for _, out in shown:
        assert out.shape == (1, 3, 100, 200) and torch.isfinite(out).all()
    # the first window's output is the model's on frames 0-6, cropped
    with torch.inference_mode():
        want = m([frames[j:j + 1] for j in range(7)])[drv.crop]
    assert torch.allclose(shown[0][1], want, rtol=0, atol=1e-5)


def test_a_clip_too_short_for_a_window_raises():
    frames = torch.zeros((6, 3, 128, 128))
    traffic = {"frame": [100, 100], "pair_gap": 1, "batch": 1, "in_flight": 1}
    with pytest.raises(ValueError, match="no sample"):
        driver.Driver(torch.nn.Identity(), memc_window, frames, traffic, "cpu")

