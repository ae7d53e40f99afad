"""Readings that set a cell's limits: the program's, the control's, a fault's.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--what program|int8|fp8|half|bf16|bf16held ...] [--seconds 2]

One process reads every seed (set-up is paid once for the kernels):

- ``program``: the cell as the benchmark runs it, for ``--seconds``; its
  compared numbers (the lower reading of each limit is their largest);
- ``int8`` (serving): the program's own int8 path in its place;
- ``fp8``: the reference computed in fp8 in the program's place (serving:
  served for ``--seconds`` and judged like the program; training: its first
  steps judged against the float32 reference);
- ``half`` (training): the reference's first steps on half of each batch,
  the fault of a step that leaves half the batch out;
- ``bf16`` (training): the reference with its conv operands rounded to
  bfloat16, a witness of what the program's precision alone gives;
- ``bf16held`` (training): a closer witness, which also holds every batch
  norm's output, residual sum and critic activation, and the gradients
  that flow back through them, in bfloat16, as the program does.

Several training readings of the reference (``--what fp8 bf16 bf16held``)
share one float32 reference run per seed.

A step that returns its state unchanged reads 1 on ``change_gap`` and
``grad_gap`` by their definition and needs no run. Prints one JSON line per
seed; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["program"],
                   choices=("program", "int8", "fp8", "half", "bf16", "bf16held"))
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import common, serve, train
    from portbench.harness.manifest import Cell, load
    from portbench.reference.lowp import bf16, bf16_held, fp8

    cell = Cell(load(ROOT), args.workload, ROOT)
    device = torch.device("cuda")
    kind = cell.traffic["kind"]

    def emit(what, seed, readings, e2e, t0):
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "readings": readings, "end_to_end": e2e,
                          "seconds": time.time() - t0}), flush=True)

    for seed in args.seeds:
        for what in args.what:
            if what == "program" or kind == "serve_closed_loop":
                t0 = time.time()
                driver = serve.run if kind == "serve_closed_loop" else train.run
                out = driver(cell, seed, args.seconds, False, device,
                             "" if what == "program" else what)
                e2e = out["end_to_end"]
                if "first" in out:
                    e2e = dict(e2e, explain=train.explain(out["first"]["program"],
                                                          out["first"]["reference"]))
                common.free(device)
                emit(what, seed, out["readings"], e2e, t0)
        lows = [w for w in args.what if w != "program" and kind != "serve_closed_loop"]
        if not lows:
            continue
        t0 = time.time()
        cfg, tr = cell.config, cell.traffic
        pool = train.train_pool(tr, common.sub_seed(seed, 1), device)
        phases, _ = train.schedule(cfg, tr)
        first = [next(phases) for _ in range(train.FIRST_STEPS)]
        ref = train.reference_readings(cfg, tr, seed, pool, first, device)
        common.free(device)
        for what in lows:
            low = train.reference_readings(
                cfg, tr, seed, pool, first, device, half=what == "half",
                quant={"fp8": fp8, "bf16": bf16, "bf16held": bf16_held}.get(what))
            common.free(device)
            emit(what, seed, train.compare(low, ref), {"explain": train.explain(low, ref)}, t0)
            t0 = time.time()
    return 0


if __name__ == "__main__":
    sys.exit(main())
