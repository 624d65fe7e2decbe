#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place,
computed in bfloat16, the precision below the float32 the configurations
state.  The comparison must reject it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --batches N

For each seed it makes the cell's inputs as a run does, steps ``N``
batches one plan a batch (a run steps about one plan a batch, its derived
alerts riding in the next),
computes the float32 reference and the bfloat16 control over the sampled
devices, and prints one JSON line of the comparison's numbers for the
control, each beside its limit.  The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def control_numbers(cfg, mix, seed: int, n_batches: int, device):
    """The comparison's numbers for the bfloat16 control against the
    float32 reference (the plan-order and total numbers are the
    program's alone, and read 0 here)."""
    import numpy as np

    from benchmark.reference import compare, plain
    from benchmark.run import make_inputs

    _, world_host, sample, sampled, stream = make_inputs(cfg, mix, seed,
                                                         device)
    width = cfg["width"]
    rows = stream.rows_of(n_batches, sampled)
    plans = np.stack([np.arange(n_batches) * width,
                      np.arange(1, n_batches + 1) * width - 1], axis=1)
    exp, ambiguous = plain.outcome(
        world_host, rows, sample, plans, cfg["mtype_slots"], "float32",
        zone_device=device, ambiguity=cfg["limits"]["ewma_gap"])
    ctl, _ = plain.outcome(
        world_host, rows, sample, plans, cfg["mtype_slots"], "bfloat16",
        zone_device=device)
    numbers = compare.outcome_gaps(exp, ctl, ambiguous)
    numbers.update(rows_misplaced=0, stored_total_gap=0, enrich_wrong=0)
    return numbers


def main(argv=None, root: Path = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--batches", type=int, required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.reference import compare
    from benchmark.spec import Spec

    spec = Spec(root)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = control_numbers(cfg, mix, seed, args.batches, device)
        correct, checks, _ = compare.verdict(numbers, cfg["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "batches": args.batches, "device": str(device),
                          "control_correct": correct, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
