"""The port imports no JAX and nothing of the JAX package.

An AST scan of every file of ``heatnet_tpu_torch/`` and of ``chip_smoke.py``
(absolute imports and ``importlib.import_module``/``__import__`` calls with a
literal name), and a fresh interpreter that imports every port module and
then finds none of those packages loaded. Also: the import builds nothing
(neither the CUDA kernels nor the native C++ library).
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "heatnet_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "heatnet_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [(m, line) for m, line in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = sorted(
        "heatnet_tpu_torch." + os.path.relpath(os.path.join(d, n), PKG)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for d, _, names in os.walk(PKG) for n in names if n.endswith(".py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "from heatnet_tpu_torch.kernels import build\n"
            "assert build._lib is None, 'a kernel was built at import'\n"
            "from heatnet_tpu_torch.native import bindings\n"
            "assert bindings._LIB is None, 'the native library was loaded at import'\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
