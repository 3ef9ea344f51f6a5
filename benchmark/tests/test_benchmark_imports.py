"""What the benchmark may import, and how a run fails without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "memcnet_tpu"}


def imports(path):
    """Top-level module names a source file imports (the part before the
    first dot, whole), including ``importlib.import_module`` of a literal."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(R.HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        found = imports(path) & FORBIDDEN
        assert not found, f"{path} imports {found}"
    # whole names: the port's name begins with the JAX package's
    assert "memcnet_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "memcnet_tpu_torch" not in imports(path), path


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "s_f32_720p_live", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for ln in stdout.splitlines():
        try:
            json.loads(ln)
            return True
        except ValueError:
            pass
    return False


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = _run(R.ROOT)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "CUDA device" in p.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(R.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "memcnet_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "s_f32_720p_live",
                        "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
                       cwd=R.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
