"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration file and a traffic file; the run builds the program's
model from the configuration with weights drawn from the seed on the card,
makes the moving clip from the seed on the card, warms up the cell's shapes
(all of that is ``setup_s``), then drives the traffic for ``--seconds``
(``benchmark/driver.py``), each sample through the configuration's call
(``benchmark/calls/<call>.py``).  With ``--trace 1`` it then drives a further
traced window and reads the cell's per-layer metrics, each from its own
reader ``benchmark/metrics/<metric>.py``.  Last, once the program's state is
freed, the configuration's plain reference checks a sample of the window's
frames (``benchmark/check.py``).  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``, each compared number
beside its limit.  A run on a machine without a CUDA device, or with fewer
than the cell's chips, fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules the process may not hold: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "memcnet_tpu")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def cell_metrics(bench, cell, trace):
    """The metrics the cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(metric):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def quantile(values, q):
    """The q-th percentile (1-99) of ``values``, inclusive method."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def run_cell(config, traffic, *, seed, seconds, trace=False, device="cuda", control=False,
             wrap=None):
    """Set up, warm up, drive the window (and the traced window), check.
    ``wrap`` (tests) replaces the model the window drives; ``control`` also
    reads the control against the reference."""
    import torch

    from benchmark import check, clip, driver, weights
    from benchmark.trace import Trace, capture
    from memcnet_tpu_torch.models import get_model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, config["dtype"])
    torch.backends.cudnn.allow_tf32 = config["allow_tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = config["allow_tf32"]["matmul"]
    with dev:
        core = get_model(config["model"], filter_size=config["filter_size"],
                         channel=config["channel"])
    template = {k: torch.empty_like(v, device="meta") for k, v in core.state_dict().items()}
    core.load_state_dict(weights.make(template, config["init"], seed, dev))
    core = core.to(dtype).eval()
    model = wrap(core) if wrap else core
    h, w = traffic["frame"]
    frames = clip.make(seed, traffic["clip_frames"], h, w, dev).to(dtype)
    call = importlib.import_module(f"benchmark.calls.{config['call']}")
    drv = driver.Driver(model, call, frames, traffic, dev)
    drv.run(frames=traffic["warmup_batches"] * traffic["batch"])
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sample = driver.Reservoir(seed, traffic["sample_frames"])
    win = drv.run(seconds=seconds, sampler=sample)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0

    tr = None
    if trace:
        prof, twin = capture(lambda: drv.run(frames=traffic["trace_frames"],
                                             span=torch.profiler.record_function))
        tr = Trace(prof)
        tr.frames = twin.frames
        tr.forwards = twin.frames // traffic["batch"]
        del prof

    crop = drv.crop
    del drv, model, core
    if cuda:
        torch.cuda.empty_cache()

    ref = check.Reference(config, template, seed, dev)
    gap = traffic["pair_gap"]
    firsts = sorted({first for first, _ in sample.items.values()})
    want, ctrl = {}, {}
    for s in firsts:
        inputs = [frames[i:i + 1].float() for i in driver.inputs_of(s, call.INPUTS, gap)]
        want[s] = ref.frames(inputs, crop)[0]
        if control:
            ctrl[s] = ref.frames(inputs, crop, config["control"])[0]
    per_frame = [check.readings(f.to(dev), want[s]) for s, f in sample.items.values()]
    limits = config["compare"]
    bad = sum(any(limits.get(k) is not None and r[k] > limits[k] for k in r)
              for r in per_frame)
    return SimpleNamespace(
        config=config, traffic=traffic, window=win, trace=tr, setup_s=setup_s,
        peak_bytes=max(peak_setup, peak_window), peak_window_bytes=peak_window,
        readings=check.worst(per_frame), sampled=len(per_frame),
        control=check.worst([check.readings(ctrl[s], want[s]) for s in firsts]) if control
        else None,
        failed=(win.attempted - win.frames) + bad, complete=win.frames == win.attempted,
        padded=tuple(frames.shape[2:]), device=dev)


def end_to_end(out):
    """The end-to-end quantities; a metric ``<quantity>.<variant>`` (its own
    bound, on other cells) reads its quantity."""
    win = out.window
    return {
        "setup_s": out.setup_s,
        "frames_per_s": win.frames / win.seconds,
        "frame_ms_p50": statistics.median(win.latency_ms),
        "frame_ms_p95": quantile(win.latency_ms, 95),
    }


def result(bench, cell, out, trace):
    """The result object, the metrics in their cell's order, ``check`` last;
    and the lines of the check for standard error."""
    import torch

    from benchmark import check

    values = end_to_end(out)
    reading = SimpleNamespace(
        config=out.config, traffic=out.traffic, window=out.window, trace=out.trace,
        padded=out.padded, batch=out.traffic["batch"],
        counts=importlib.import_module(f"benchmark.counts.{out.config['counts']}"),
        frames_per_s=values["frames_per_s"], peak_window_bytes=out.peak_window_bytes)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = reader(m["name"])(reading) if trace else values[m["name"].split(".")[0]]
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, lines = check.judge(out.config["compare"], out.readings, out.complete)
    cuda = out.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.get("chips", 1),
              "memory_peak_bytes": out.peak_bytes}
    line = {"correct": correct, "attempted": out.window.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    line["check"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in lines}
    return line, lines


def window_summary(win):
    """One line on the window's forwards, for the record of a run."""
    def q(v):
        return "/".join(f"{quantile(v, k):.2f}" for k in (5, 50, 95)) if v else "-"

    return (f"window: {win.frames} frames of {win.attempted} sent in {win.seconds:.3f} s; "
            f"ms p5/p50/p95: forward (events) {q(win.forward_ms)}, enqueue {q(win.enqueue_ms)}, "
            f"frame {q(win.latency_ms)}")


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    importlib.import_module("memcnet_tpu_torch.models")  # the program under test

    import torch

    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace))
    line, lines = result(bench, cell, out, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"benchmark: the process holds {', '.join(found)}: it may not import JAX or the "
            "JAX package")
        return 3
    log(f"card: {power_limit()}")
    log(window_summary(out.window))
    if not lines:
        log("check: the configuration states no limit")
    for name, value, limit, good in lines:
        log(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
