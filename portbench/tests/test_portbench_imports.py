"""Nothing the benchmark runs imports JAX, flax or the JAX package (top-level
names compared whole: ``heatnet_tpu_torch`` begins with ``heatnet_tpu``),
and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench_tiny import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "heatnet_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_forbidden_import_in_the_sources():
    bad = {p: n for p in _sources(BENCH) for n in _imports(p) if n in FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    names = {n for p in _sources(os.path.join(BENCH, "reference")) for n in _imports(p)}
    assert "heatnet_tpu_torch" not in names and not names & FORBIDDEN


def test_loaded_modules_after_a_run_in_a_fresh_process():
    code = ("import sys, time, torch; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            "from portbench_tiny import run_tiny; run_tiny('resnext50_early.serve_b8');"
            "from portbench.harness.cell import forbidden_modules;"
            "print(forbidden_modules(), sorted({m.split('.')[0] for m in sys.modules}"
            " & {'heatnet_tpu_torch'}))") % (ROOT, os.path.join(BENCH, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] ['heatnet_tpu_torch']"


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return  # on a card the run goes ahead; this checks the refusal only
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "resnext50_early.serve_b8", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "resnext50_early.serve_b8", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "cannot import the program" in out.stderr
