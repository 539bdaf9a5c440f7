#!/usr/bin/env python3
"""Readings that set a cell's correctness limits: the program's and the
control's, over many seeds, in one process.

From the root of a checkout, on the cards the cell asks for::

    python3 portbench/calibrate.py --workload keyed_tenants.cohorts --seeds 11,12,13 --seconds 3

For each seed it runs the cell (a short window, ``--trace 0``) and prints the
numbers its check compared (the lower readings), then puts the reference,
computed in bfloat16, in the program's place on the same inputs at the
cell's own size and prints what the same check reads of it (the upper
readings: the control has to come out not correct). One JSON line a seed.
The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402


def control_checks(cell, seed, device):
    """The check's readings of the bfloat16 reference in the program's place."""
    import torch

    builder, reference = cell.builder(), cell.reference()
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    cfg = cell.cfg
    batches = builder.inputs(torch, cfg, seed, dev)
    ids = torch.cat([b[0] for b in batches]).cpu().numpy()
    preds = torch.cat([b[1] for b in batches])
    target = torch.cat([b[2] for b in batches]).cpu().numpy()
    values, state = reference.control(torch, cfg, ids, preds, target, 1)
    return reference.check(torch, cfg, ids, preds, target, [values], state, 1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--no-program", action="store_true", help="read the control alone")
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    cell = common.find_cell(args.workload)
    common.require_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"seed": seed}
        if not args.no_program:
            rec = cell.driver().run(cell, seed=seed, seconds=args.seconds, trace=False, t_start=time.time(),
                                    device="cuda")
            line["program"] = {k: v[0] for k, v in rec.checks.items()}
            line["correct"] = rec.correct
            line["end_to_end"] = rec.end_to_end
        line["control"] = {k: v[0] for k, v in control_checks(cell, seed, "cuda").items()}
        print(json.dumps(line), flush=True)
    print(f"portbench: {common.card_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
