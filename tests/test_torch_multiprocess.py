"""The port's parallel layer across processes: gloo groups of 2-4 ranks on
the CPU (tests/torch_mp_workers.py), each held against one process.

  * the tiled warp and projection with their ring shifts across 4 ranks on
    a (1, 4), a (2, 2) and a (1, 2, 2) mesh, results and input gradients
    equal to the tiles stacked in one process;
  * MEMC_Net_star's partitioned forward (frames sharded, every layer on its
    tile) across 4 ranks on a (1, 4) grid at 64x320 and a (1, 2, 2) grid at
    128x192, each with a level that does not divide, equal to the tiles
    stacked in one process and to the untiled forward;
  * the op library on partitioned frames across 4 ranks on (1, 4) at
    64x256 -- depth_flow_project with the fill (the reduce-scatter, the
    carries), pixel_splat (the reduce-scatter) and bilinear_warp (the
    whole-level all-gather), flows of up to 20 px -- equal to the tiles
    stacked in one process and to the untiled ops, with their input
    gradients (each rank's gradient holds its tile's part);
  * the dryrun's sharded MEMC_Net_star step on 4 ranks, (1, 2, 2) with 64
    px tiles, its frames partitioned: equal to the same step in one process
    (the tiles stacked), its loss and gradients to the untiled step's;
  * the HD720p demo's --multihost launch, 2 processes at 64x96 (MEMC_Net):
    the stitched stream byte-equal to one process, as tests/
    test_multiprocess.py holds the JAX demo.

(tests/test_torch_multiprocess_dp.py holds the data-parallel step and the
ZeRO-1 checkpoint.)  One spawned group per scenario (the ring, the
partitioned forward and the sharded step share one 4-rank group), in a
module-scoped fixture whose results the parametrised cases read; the
one-process references run while the ranks do.  Every spawn and join has a
timeout of 120 s.
Tolerances: the tiled ops exactly (the same float32 arithmetic in the same
order); the partitioned forward within 1e-5 of each output's scale of one
process (convs of one tile against convs of a batch of tiles) and 1e-4 of
the untiled forward (tests/test_torch_partition.py's rule); a train step's
loss within 1e-5 relative and its parameters within 1e-6 on at least 99.9%
of their elements and within 2 lr everywhere (Adamax's first update is
about lr * sign(g), so a gradient element that float32 noise moves across 0
moves its parameter by 2 lr; the ranks sum the gradients in another order
than one process), and its gradients within 1e-2 of their subnet's largest
of the untiled step's (tests/test_torch_train_models.py's rule: the convs of
a tile sum in another order than the whole frame's).
"""

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from memcnet_tpu_torch.cli import demo_hd720p
from memcnet_tpu_torch.data import YUVWrite
from memcnet_tpu_torch.parallel.gop import split_gops, stitch_parts

import torch_mp_workers as W

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120
CPU = torch.device("cpu")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"a rank failed:\n{out[-2000:]}\n{err[-4000:]}"
    return outs


def load_and_remove(path):
    """A file the ranks wrote (hundreds of MB for a whole model), then gone."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    finally:
        os.remove(path)


def start(scenario, world, out):
    """Start ``scenario`` of torch_mp_workers in ``world`` ranks; ``collect``
    waits for them."""
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mp_workers.py"), scenario, str(r),
         str(world), port, str(out)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def collect(procs, out):
    """Each rank's results."""
    _wait(procs)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def spawn(scenario, world, out):
    """Run ``scenario`` of torch_mp_workers in ``world`` ranks; returns each
    rank's results."""
    return collect(start(scenario, world, out), out)


@contextlib.contextmanager
def few_threads(n=2):
    """This process's own reference steps on n threads: the ranks and the
    other test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def assert_step_stats(close_share, max_abs, lr):
    assert close_share >= 0.999, close_share
    assert max_abs <= 2 * lr * (1 + 1e-3), max_abs


def assert_step_params(got, want, lr):
    assert_step_stats(*W.step_stats(got, want), lr)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank group's results, and the ring's and the partitioned
    forward's meshes stacked in one process (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("four")
    procs = start("four", 4, out)
    want, part = {}, {}
    try:
        with few_threads():
            for name, factory, (H, Wd), axis_h in W.RING_MESHES:
                mesh = factory(devices=[CPU] * 4)
                want[name] = (mesh, W.ring_run(mesh, axis_h, W.ring_inputs(H, Wd)))
            for name, factory, (H, Wd), axis_h in W.PART_MESHES:
                model, x0, x2 = W.part_inputs(H, Wd)
                with torch.no_grad():
                    (_, rectified), offs, _, _ = model(x0, x2)
                part[name] = (W.part_run(factory(devices=[CPU] * 4), axis_h, H, Wd),
                              {"rectified": rectified, "offset0": offs[0]})
            model, x0, x2 = W.part_s_inputs()
            with torch.no_grad():
                (_, rectified), offs, _, _ = model(x0, x2)
            part["MEMC_Net_s"] = (W.part_s_run(W.make_mesh(4, devices=[CPU] * 4)),
                                  {"rectified": rectified, "offset0": offs[0]})
            x = W.oplib_inputs()
            oplib = (W.oplib_run(W.make_mesh(4, devices=[CPU] * 4), x), W.oplib_run(None, x))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = collect(procs, out)
    return dict(ring=[r["ring"] for r in ranks], sharded=[r["sharded"] for r in ranks],
                partition=[r["partition"] for r in ranks], ring_want=want, part_want=part,
                oplib=[r["oplib"] for r in ranks], oplib_want=oplib)


# -- the ring across ranks ----------------------------------------------------------


@pytest.mark.parametrize("mesh_name", [m[0] for m in W.RING_MESHES])
@pytest.mark.parametrize("rank", range(4))
def test_tiled_ops_across_ranks_equal_one_process(four, mesh_name, rank):
    mesh, want = four["ring_want"][mesh_name]
    d = mesh.shape["data"]
    coord = rank // (4 // d)  # data-major: the data coordinate is outermost
    rows = slice(coord * 2 // d, (coord + 1) * 2 // d)
    got = four["ring"][rank][mesh_name]
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w[rows]), k


@pytest.mark.parametrize("mesh_name", [m[0] for m in W.PART_MESHES])
@pytest.mark.parametrize("rank", range(4))
def test_partitioned_forward_across_ranks_equals_one_process(four, mesh_name, rank):
    stacked, untiled = four["part_want"][mesh_name]
    got = four["partition"][rank][mesh_name]
    assert float(untiled["offset0"].abs().max()) > 0.5 * W.PART_FLOW_PX
    for k, w in stacked.items():
        scale = max(1.0, float(w.abs().max()))
        assert float((got[k] - w).abs().max()) <= 1e-5 * scale, k
        assert float((got[k] - untiled[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("rank", range(4))
def test_partitioned_memc_s_across_ranks_equals_one_process(four, rank):
    """MEMC_Net_s partitioned on (1, 4) across 4 ranks, SPyNet's second
    frame all-gathered whole at every level, against the same forward with
    the tiles stacked in one process and against the untiled forward."""
    stacked, untiled = four["part_want"]["MEMC_Net_s"]
    got = four["partition"][rank]["MEMC_Net_s"]
    assert float(untiled["offset0"].abs().max()) > 0.5 * W.PART_FLOW_PX
    for k, w in stacked.items():
        scale = max(1.0, float(w.abs().max()))
        assert float((got[k] - w).abs().max()) <= 1e-5 * scale, k
        assert float((got[k] - untiled[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", [c[0] for c in W.OPLIB_CALLS])
def test_oplib_across_ranks_equals_one_process(four, name):
    """Each rank's outputs against the tiles stacked in one process and the
    untiled op, within 1e-6 of their scale (the ranks sum their whole-frame
    buffers in another order); the ranks' input gradients, summed, within
    1e-5 of their largest of both."""
    stacked, untiled = four["oplib_want"]
    for rank in range(4):
        for got, w, u in zip(four["oplib"][rank][name], stacked[name], untiled[name]):
            scale = max(1.0, float(u.abs().max()))
            assert float((got - w).abs().max()) <= 1e-6 * scale
            assert float((got - u).abs().max()) <= 1e-6 * scale
    grads = [sum(r[name + "_grads"][i] for r in four["oplib"])
             for i in range(len(stacked[name + "_grads"]))]
    for got, w, u in zip(grads, stacked[name + "_grads"], untiled[name + "_grads"]):
        top = float(u.abs().max())
        assert float((got - w).abs().max()) <= 1e-5 * top
        assert float((got - u).abs().max()) <= 1e-5 * top


def test_sharded_star_step_mesh_and_loss(four):
    ranks = four["sharded"]
    for r in ranks:
        assert r["mesh"] == {"data": 1, "tile_h": 2, "tile": 2}
        np.testing.assert_allclose(float(r["loss"]), float(ranks[0]["ref_loss"]), rtol=1e-5)
        assert torch.equal(r["sums"], ranks[0]["sums"])
        assert r["state_numel"] < 0.26 * r["whole_numel"]  # ZeRO-1 over 4 ranks


def test_sharded_star_step_equals_one_process_step(four):
    """Rank 1 took the same sharded step in one process (its tiles stacked
    into the batch) after the 4-rank one and compared the parameters."""
    r = four["sharded"][1]
    assert_step_stats(r["close_share"], r["max_abs"], W.SHARDED_LR)


def test_sharded_star_step_gradients_match_the_whole_frame_step(four):
    """The 4-rank step's gradients (DDP's average over every rank, each
    rank's loss all-reduced over its tiles) against the untiled TrainStep's,
    per subnet within 1e-2 of the subnet's largest, the rule of
    tests/test_torch_train_models.py."""
    errs = four["sharded"][0]["grad_errs"]
    assert {"flownets", "rectifyNet", "initScaleNets_filter"} <= set(errs)
    for sub, (err, top) in errs.items():
        assert err <= 1e-2 * top, (sub, err, top)


# -- the HD720p demo's --multihost ---------------------------------------------------------


H, Wd, FRAMES, GOP_LEN = 64, 96, 8, 4  # 4 GOPs of one pair: 2 for each process


def _demo_args(src, out_dir, journal):
    return ["--yuv", str(src), "--height", str(H), "--width", str(Wd), "--frames", str(FRAMES),
            "--out-dir", str(out_dir), "--gop-len", str(GOP_LEN), "--net-name", "MEMC_Net",
            "--journal", str(journal), "--uid", "mh", "--device", "cpu"]


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    src = tmp / "in.yuv"
    rng = np.random.RandomState(0)
    wr = YUVWrite(str(src))
    for _ in range(FRAMES + 1):
        wr.write(rng.randint(0, 256, (H, Wd, 3)).astype(np.uint8))
    wr.close()
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "memcnet_tpu_torch.cli.demo_hd720p",
         *_demo_args(src, tmp / "mh", tmp / "mh.journal"), "--multihost"],
        env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r),
                 LOCAL_RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    with few_threads():  # the one-process run meanwhile
        demo_hd720p.main(_demo_args(src, tmp / "base", tmp / "base.journal"))
    outs = _wait(procs)
    return dict(tmp=tmp, outs=outs)


def test_multihost_demo_both_processes_work(multihost):
    errs = [err for _, _, err in multihost["outs"]]
    assert any("process 0/2" in e for e in errs) and any("process 1/2" in e for e in errs)
    gen = multihost["tmp"] / "mh" / "mh"
    parts = [gen / "in.yuv.part0", gen / "in.yuv.part1"]
    assert all(p.exists() and p.stat().st_size > 0 for p in parts)
    base = (multihost["tmp"] / "base" / "mh" / "in.yuv").read_bytes()
    assert sum(p.stat().st_size for p in parts) == len(base)


def test_multihost_demo_journal_holds_every_gop_once(multihost):
    gids = [int(x) for x in (multihost["tmp"] / "mh.journal").read_text().split()]
    assert sorted(gids) == [g.gop_id for g in split_gops(FRAMES + 1, GOP_LEN, 2)]


def test_multihost_demo_stitched_stream_is_the_one_process_stream(multihost):
    tmp = multihost["tmp"]
    gen = tmp / "mh" / "mh"
    stitched = stitch_parts([str(gen / "in.yuv.part0"), str(gen / "in.yuv.part1")],
                            str(gen / "stitched.yuv"), n_frames=FRAMES + 1, height=H, width=Wd,
                            gop_len=GOP_LEN)
    assert Path(stitched).read_bytes() == (tmp / "base" / "mh" / "in.yuv").read_bytes()
    psnr = sorted(float(x) for x in (gen / "in.yuv_psnr_Y.txt").read_text().split())
    base = sorted(float(x) for x in
                  (tmp / "base" / "mh" / "in.yuv_psnr_Y.txt").read_text().split())
    np.testing.assert_allclose(psnr, base, rtol=0, atol=1e-9)
