"""The readings that a cell's limits are set from: for each seed, the
numbers compared when the program runs soundly, when the control (the
reference in fp8, reference/precision.py) takes the program's place, and
when a fault is planted in the reference put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

One process, on the cell's card and at its size; no measured window (eval
and serving run ``--seconds`` of the cell's own load to have answers to
compare). Prints one JSON line per seed and a summary: for each number the
largest program reading (the lower reading) and the smallest control and
fault readings (the upper ones). Faults: training, half of each
microbatch left out with the mean over the rest (a state returned
unchanged reads 1 on param_change by definition); answers, one answer of
the sample altered where it is produced.
"""
import argparse
import gc
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, cell_name: str, seed: int, seconds: float, device) -> dict:
    """{"seed", "program", "control", <the cell's fault>}: the numbers that
    the cell's ``judge`` compares for each side."""
    import torch
    from portbench.harness import finetune, manifest
    from portbench.harness.runner import KINDS, new_run
    from portbench.reference.precision import FP8
    cell = manifest.cell(root, cell_name)
    kind = KINDS[cell.traffic["kind"]]
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = new_run(root, cell, seed, seconds, False, torch.device(device), tmp)
        st = kind.setup(run)
        if kind is not finetune:
            kind.window(run, st)
        kind.release(st)
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"seed": seed, "program": kind.judge(run, st),
                "control": kind.judge(run, st, prec=FP8),
                kind.FAULT: kind.judge(run, st, fault=kind.FAULT)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for s in args.seeds.split(","):
        r = readings(ROOT, args.workload, int(s), args.seconds, "cuda")
        print(json.dumps(r), flush=True)
        rows.append(r)
    summary = {}
    for side in rows[0]:
        if side == "seed":
            continue
        agg = max if side == "program" else min
        summary[side] = {k: agg(r[side][k] for r in rows) for k in rows[0][side]}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
