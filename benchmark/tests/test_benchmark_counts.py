"""The counts agree with torch's FLOP counter over the reference, and the
trace arithmetic counts overlapping operations once."""

import importlib
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import peaks, run as R, weights as W
from benchmark.reference.layers import Params
from benchmark.trace import Trace, busy_intervals, union_seconds


def params(config):
    from memcnet_tpu_torch.models import get_model

    m = get_model(config["model"])
    template = {k: torch.empty_like(v, device="meta") for k, v in m.state_dict().items()}
    return Params(W.make(template, config["init"], 3, "cpu"))


@pytest.mark.parametrize("name", ["memc_net_star-bf16", "memc_net_s-f32"])
@pytest.mark.parametrize("hw", [(128, 128), (128, 256)])
def test_flops_match_the_flop_counter(name, hw):
    config = R.load_json(f"{R.HERE}/configs/{name}.json")
    fwd = importlib.import_module(f"benchmark.reference.{config['reference']}").forward
    counts = importlib.import_module(f"benchmark.counts.{config['counts']}")
    x = torch.rand((1, 3) + hw)
    with FlopCounterMode(display=False) as fc:
        fwd(params(config), x, x.flip(-1))
    assert counts.flops(*hw) == fc.get_total_flops()


def test_published_sizes_at_720p():
    from benchmark.counts import memc_net_s, memc_net_star

    assert round(memc_net_star.flops(768, 1344) / 1e12, 2) == 7.67
    assert round(memc_net_s.flops(768, 1344) / 1e12, 2) == 1.95
    # K1 at star's shape is bound by its bytes: 308 bytes a pixel
    (nbytes, flops, peak), _ = memc_net_star.kernels(1, 768, 1344, 2)["k1"]
    assert nbytes == 768 * 1344 * 308 and peaks.least_seconds([(nbytes, flops, peak)]) == \
        nbytes / peaks.HBM_BYTES_PER_S


@pytest.mark.parametrize("B", [1, 4])
def test_every_conv_of_memc_net_s_float32_is_counted_on_k4(B):
    """A float32 forward on the card runs all of MEMC_Net_s's convs on K4's
    float32 body: SPyNet's 30 and the walkers' 24."""
    from benchmark.counts import memc_net_s

    for hw, n in [((128, 256), 5 * 4 + 24), ((768, 1344), 5 * 6 + 24)]:
        launches = memc_net_s.kernels(B, *hw, 4)["k4"]
        assert len(launches) == n and {p for *_, p in launches} == {"tf32"}
        assert sum(f for _, f, _ in launches) == B * memc_net_s.flops(*hw)


def test_union_counts_overlaps_once():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 12.0)]
    assert union_seconds(ivs, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 2.0)
    assert busy_intervals(ivs, 0.0, 10.0) == [(0.0, 3.0), (5.0, 6.0), (8.0, 10.0)]
    assert union_seconds([], 0.0, 1.0) == 0.0
    assert union_seconds([(2.0, 3.0)], 0.0, 1.0) == 0.0


def _event(name, start_us, end_us, device, id_=0):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us),
                           device_type=kind, id=id_)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_trace_idle_share_gaps_and_ranges():
    ev = [_event("bench.window", 0, 100, False),
          _event("bench.forward", 5, 40, False),
          _event("bench.flow", 6, 20, False),
          _event("bench.wait", 60, 100, False),
          _event("cudaLaunchKernel", 7, 8, False, 1),
          _event("cudaLaunchKernel", 30, 31, False, 2),
          _event("k_flow", 10, 30, True, 1),
          _event("k_other", 20, 50, True, 2),   # overlaps k_flow: busy counts it once
          _event("bench.flow", 10, 30, True),   # the device side of a range: no operation
          _event("k_late", 70, 80, True, 3)]
    tr = Trace(_Prof(ev))
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.seconds_under("bench.flow") == pytest.approx(20e-6)
    assert tr.seconds_of(lambda n: n.startswith("k_")) == pytest.approx(60e-6)
    gaps = sorted([n, round(v * 1e6, 6)] for n, v in tr.idle_gaps())
    assert gaps == [["bench.wait", 20.0], ["host:outside any range", 10.0],
                    ["host:outside any range", 20.0]]
    assert tr.top_ops()[0] == ["k_other", pytest.approx(30e-6)]
