"""Kernels K1 (warp) and K4 (small conv) and the flow projection (K2 and K3)
timed on one card at the 720p paths' shapes, against another checkout of the
repo and against K1's design steps.

    python memcnet_tpu_torch/bench/kernel_ab.py [--other DIR] [--out FILE]

Measures this tree's K1 -- MEMC_Net_star's split warp of (frame, context),
67 channels, and the 3-channel frame warp, on the smooth +-20 px flow that
chip_smoke.py checks (``memcnet_tpu_torch/probe.py``), bf16 and float32 --
and K4 -- the ctx conv (3 -> 64) and SPyNet's five 7x7 convs at each of its
six pyramid levels, B = 2, bf16 and float32 -- and ``flow_project`` with the fill at B = 2 (both directions of
the smooth flow), bf16 and float32, with its device operations and device ms
per call from torch.profiler and, in this tree, its K2 and K3 stages; each the
median device time of repeated launches after a 256 MB L2 flush, and each
checked against the tree's own plain version (the projection against the
tree's CPU path).

With ``--other DIR`` (a checkout of another commit, e.g. the parent unpacked
with ``git archive``), the same measurements run on that tree's kernels too,
in separate processes in the order other, this, this, other, so that both
meet the same card; the table keeps the mean of each tree's two runs.  The
other tree builds its own kernels into its own ``_build`` directory.

The design steps of K1 (``warp_steps.cu``: tiled and vector-load gathers,
and the floor of 16 loads per channel that all hit the pixel itself) are
timed in this tree's process, and ``mma_probe.cu`` shows how the tensor
cores add: 1 + 2^-k and 1 - 1 + 2^-k in one MMA, for which k the small term
survives.  Results go to ``--out`` as JSON (default
``chiprun_out/kernel_ab/results.json``) and a table to standard output.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _load_probe():
    """This tree's ``memcnet_tpu_torch/probe.py`` (the flow chip_smoke.py
    checks, the device-operation count), loaded by its path: the measuring
    process imports the package of the tree it measures, which may be
    another checkout's."""
    spec = importlib.util.spec_from_file_location(
        "memcnet_probe", os.path.join(ROOT, "memcnet_tpu_torch", "probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _load_probe()
H, W = PROBE.H, PROBE.W  # 1280x720 padded (data/padding.py)
LEVELS = 6
BASIC = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]  # models/spynet.py
WARP_STEPS = ["128x1 gather (earlier tile)", "32x4 gather", "128x1 vector rows",
              "32x4 vector rows", "floor: every tap at the pixel", "one gather per filter row"]


def noisy_flow(torch, dev):
    """The smooth flow plus +-30 px white noise: the patches of a block
    spread too far for K1's shared-memory box."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flow = PROBE.synthetic_flow(1, dev)
    return (flow + 30.0 * torch.randn(flow.shape, generator=gen, device=dev)).contiguous()


def timed_ms(torch, fn, flush, reps=10):
    import numpy as np

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_ulps(torch, got, ref, slack):
    """Largest |got - ref| - slack in bf16 units of each ref value (float32:
    plain max abs error)."""
    if ref.dtype == torch.float32:
        return float((got - ref).abs().max())
    r = ref.float().abs()
    e = torch.floor(torch.log2(torch.where(r > 0, r, torch.ones_like(r))))
    ulp = torch.where(r > 0, torch.exp2(e - 7), torch.full_like(r, 2.0 ** -133))
    return float((((got.float() - ref.float()).abs() - slack).clamp(min=0.0) / ulp).max())


def measure(root, steps):
    """This process's measurements of the kernels of the tree at ``root``."""
    sys.path.insert(0, root)
    import torch

    from memcnet_tpu_torch.nn import init as I
    from memcnet_tpu_torch.ops import projection
    from memcnet_tpu_torch.ops.cuda import _lib, conv_kernel, warp_kernel

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    step_lib = build(_lib, "warp_steps") if steps else None
    if steps:
        res["mma probe"] = mma_probe(torch, build(_lib, "mma_probe"))
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        pflow = PROBE.synthetic_flow(2, dev).to(dt)  # both directions, as served
        # both trees' CPU path is the plain composition
        ref = projection.flow_project(pflow.cpu(), fillhole=True).to(dev)
        got = projection.flow_project(pflow, fillhole=True)
        n_ops, dev_ms, by_kernel = PROBE.device_ops(
            lambda: projection.flow_project(pflow, fillhole=True))
        key = f"flow_project {name}"
        res[key] = dict(ms=timed_ms(torch, lambda: projection.flow_project(pflow, fillhole=True),
                                    flush),
                        err=max_ulps(torch, got, ref, 0.0), launches=n_ops, device_ms=dev_ms,
                        kernels=by_kernel)
        if steps:
            res[key]["steps"] = projection_steps(torch, projection, pflow, flush)
        del ref, got
        smooth = PROBE.synthetic_flow(1, dev).to(dt).float()
        frame = torch.rand((1, 3, H, W), generator=gen, device=dev).to(dt)
        ctx = torch.randn((1, 64, H, W), generator=gen, device=dev).to(dt)
        filt = (torch.rand((1, 16, H, W), generator=gen, device=dev) / 8.0).to(dt)
        noisy = noisy_flow(torch, dev).to(dt).float()
        for srcs, flow, tag in (((frame, ctx), smooth, ""), ((frame,), smooth, ""),
                                ((frame, ctx), noisy, " noisy flow")):
            key = f"K1 {sum(s.shape[1] for s in srcs)}ch{tag} {name}"
            ref = warp_kernel.reference(srcs, flow, filt, 4)
            got = warp_kernel.launch(srcs, flow, filt, 4)
            res[key] = dict(ms=timed_ms(torch, lambda: warp_kernel.launch(srcs, flow, filt, 4),
                                        flush),
                            err=max(max_ulps(torch, g, r, 0.0) for g, r in zip(got, ref)))
            if step_lib is not None and not tag:
                res[key]["steps"] = time_steps(torch, step_lib, warp_kernel, _lib, srcs, flow,
                                               filt, flush)
        del frame, ctx, filt, noisy
        convs = [("ctx 3->64", 3, 64, H, W, False, False)]
        convs += [(f"L{lvl} {H >> lvl}x{W >> lvl} {cin}->{cout}", cin, cout, H >> lvl, W >> lvl,
                   True, j < len(BASIC) - 1)
                  for lvl in range(LEVELS) for j, (cin, cout) in enumerate(BASIC)]
        wgen = torch.Generator().manual_seed(2)
        for label, cin, cout, h, w_, bias, relu in convs:
            x = (torch.rand((2, cin, h, w_), generator=gen, device=dev) * 4.0 - 2.0).to(dt)
            if bias:
                w = I.torch_default_uniform((cout, cin, 7, 7), wgen).to(dev).to(dt)
                b = I.torch_default_uniform((cout,), wgen, fan_in=cin * 49).to(dev)
            else:
                w = I.resnet_msra((cout, cin, 7, 7), torch.Generator().manual_seed(1)).to(dev).to(dt)
                b = None
            got = conv_kernel.launch(x, w, b, relu=relu)
            ref = conv_kernel.reference(x, w, b, relu=relu)
            res[f"K4 {label} {name}"] = dict(
                ms=timed_ms(torch, lambda: conv_kernel.launch(x, w, b, relu=relu), flush),
                err=max_ulps(torch, got, ref, 5e-4 if bias else 0.0))
            del x, w, b, got, ref
        torch.cuda.empty_cache()
    return res


def projection_steps(torch, projection, flow, flush):
    """The fused projection's stages, this tree only: K2 (memset, scatter,
    fold-and-divide) with and without the fill's masks, K3 (the fill), and
    the whole op without the L2 flush before it (host time shows)."""
    from memcnet_tpu_torch.ops.cuda import project_kernel as P

    _, avg, masks = P.launch_sums(flow, True)
    steps = {
        "K2 stage (memset, scatter, fold-and-divide, masks)":
            timed_ms(torch, lambda: P.launch_sums(flow, True), flush),
        "K2 stage without the fill (result in the flow's type)":
            timed_ms(torch, lambda: P.launch_sums(flow, False), flush),
        "K3 stage (fill)": timed_ms(torch, lambda: P.launch_fill(avg, masks, flow.dtype), flush),
    }
    steps["whole op, no L2 flush before it"] = timed_ms(
        torch, lambda: projection.flow_project(flow, fillhole=True), torch.empty(0, device="cuda"))
    return steps


def build(_lib, name):
    """nvcc ``<name>.cu`` of this folder into a library beside the kernels'."""
    so = os.path.join(_lib.BUILD_ROOT, f"{name}.so")
    os.makedirs(_lib.BUILD_ROOT, exist_ok=True)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC_DIR),
                    os.path.join(HERE, f"{name}.cu"), "-o", so],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "warp_steps":
        lib.memc_warp_step.argtypes = [i, vp, vp, vp, i, i, i, i, vp]
        lib.memc_warp_step.restype = i
    else:
        lib.memc_mma_probe.argtypes = [vp, vp, vp, vp]
        lib.memc_mma_probe.restype = i
    return lib


def mma_probe(torch, lib):
    """For k = 20..30: what one MMA returns for 1 + 2^-k (the accumulator 1,
    one product 2^-k) and for 1 - 1 + 2^-k (three products), less the large
    part, in units of 2^-k: 1 where the small term survives, 0 where it is
    dropped."""
    def mma(products, c0):
        A = torch.zeros(16, 16, dtype=torch.float64)
        A[0, :len(products)] = torch.tensor(products, dtype=torch.float64)
        A = A.to("cuda", torch.bfloat16)
        Bt = torch.ones(8, 16, device="cuda", dtype=torch.bfloat16)
        C = torch.zeros(16, 8, device="cuda")
        C[0, 0] = c0
        D = torch.zeros(16, 8, device="cuda")
        err = lib.memc_mma_probe(A.data_ptr(), Bt.data_ptr(), C.data_ptr(), D.data_ptr())
        if err:
            raise RuntimeError(f"mma probe: CUDA error {err}")
        return float(D[0, 0].double())

    return {k: {"c=1, p=2^-k": (mma([2.0 ** -k], 1.0) - 1.0) / 2.0 ** -k,
                "p=1, -1, 2^-k": mma([1.0, -1.0, 2.0 ** -k], 0.0) / 2.0 ** -k}
            for k in range(20, 31)}


def time_steps(torch, lib, warp_kernel, _lib, srcs, flow, filt, flush):
    outs = [torch.empty_like(s) for s in srcs]
    sources = warp_kernel._WarpSources()
    for k, (a, o) in enumerate(zip(srcs, outs)):
        sources.src[k], sources.out[k], sources.channels[k] = a.data_ptr(), o.data_ptr(), a.shape[1]
    sources.n = len(srcs)
    code = _lib.dtype_code(srcs[0].dtype)
    ms = {}
    for v, label in enumerate(WARP_STEPS):
        def run():
            err = lib.memc_warp_step(v, ctypes.byref(sources), flow.data_ptr(), filt.data_ptr(),
                                     1, H, W, code, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"warp step {label}: CUDA error {err}")
        ms[label] = timed_ms(torch, run, flush)
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="checkout of another commit to time beside this one")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "kernel_ab",
                                                  "results.json"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # internal: one tree's process
    ap.add_argument("--steps", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.steps)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    trees = [("this", ROOT)] + ([("other", os.path.abspath(args.other))] if args.other else [])
    order = ["other", "this", "this", "other"] if args.other else ["this"]
    runs = {name: [] for name, _ in trees}
    for i, name in enumerate(order):
        root = dict(trees)[name]
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root]
        if name == "this" and not any(r for r in runs["this"]):
            cmd.append("--steps")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    probe = runs["this"][0].pop("mma probe")
    for r in runs["this"][1:]:
        r.pop("mma probe", None)
    table = {}
    for key in runs["this"][0]:
        row = {}
        for name, rs in runs.items():
            row[f"{name}_ms"] = sum(r[key]["ms"] for r in rs) / len(rs)
            row[f"{name}_err"] = max(r[key]["err"] for r in rs)
            if "launches" in rs[0][key]:
                row[f"{name}_launches"] = rs[0][key]["launches"]
                row[f"{name}_device_ms"] = sum(r[key]["device_ms"] for r in rs) / len(rs)
                row[f"{name}_kernels"] = rs[0][key]["kernels"]
        if "steps" in runs["this"][0][key]:
            row["steps_ms"] = runs["this"][0][key]["steps"]
        table[key] = row
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "order": order, "rows": table, "mma_probe": probe,
                   "runs": runs}, f, indent=1)
    print(f"card: {card}; order {order}")
    for k, row in probe.items():
        print(f"mma probe k={k}: " + ", ".join(f"{n} -> {v:g}" for n, v in row.items()))
    for key, row in table.items():
        line = f"{key:<34} this {row['this_ms']:.4f} ms (err {row['this_err']:.3g})"
        if "other_ms" in row:
            line += f"  other {row['other_ms']:.4f} ms (err {row['other_err']:.3g})"
        if "this_launches" in row:
            line += "  device ops, device ms a call: " + ", ".join(
                f"{n} {row[f'{n}_launches']}, {row[f'{n}_device_ms']:.4f}" for n in runs)
        print(line)
        for n in runs:
            for k, ms in row.get(f"{n}_kernels", {}).items():
                print(f"    {n} kernel {k[:70]:<70} {ms:.4f} ms")
        for label, ms in row.get("steps_ms", {}).items():
            print(f"    step {label:<32} {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
