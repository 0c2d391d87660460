"""Readings for the output check's limits: each seed's run of a cell, then
the check twice on the same sample, once judging the program and once
judging the control (the reference computed in bfloat16 put in the
program's place), each held to the cell's limits as a run is.  Not part
of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 20

One JSON line per seed: {"seed", "correct", "program": {...},
"control_correct", "control": {...}}; the control has to come out not
correct.
"""
import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        r = harness.run_cell(a.workload, seed, a.seconds, False, control=True)
        run = harness.LAST_RUN
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "program": {k: v["value"] for k, v in r["checked"].items()},
                          "control_correct": run.control_correct,
                          "control": run.control}), flush=True)
        del run
        harness.LAST_RUN = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
