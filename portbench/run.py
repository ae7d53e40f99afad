"""The benchmark of heatnet_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cell's cards. Reads
``BENCHMARK.json`` and the files it names under ``portbench/``, makes the
weights and the frames from the seed, warms up, measures for ``--seconds``,
checks the answers against the float32 reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``, the
metrics (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``; the
compared numbers with their limits come last there (``check``) and as the
last lines of standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), where the program cannot be imported, or where JAX,
flax or the JAX package was loaded in this process.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout (the kernels build into
    ``heatnet_tpu_torch/_build`` there)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    try:
        import torch
        import heatnet_tpu_torch  # noqa: F401
        from portbench.harness import cell as runner
        from portbench.harness.manifest import Cell, load
    except ImportError as e:
        print(f"portbench: cannot import the program or the harness: {e}", file=sys.stderr)
        return 2
    cell = Cell(load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS,
                        log=lambda s: print(s, flush=True))
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    for line in runner.check_lines(result["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
