"""Readings that set a cell's correctness limits: its compared numbers on
many seeds, from the program as the configuration states it and from
the control, the program's own next-lower precision, which the
configuration names (``"control"``: ``int8``, the LSTM stacks' int8
recurrent weights), all in one process.

    python3 sharpbench/control.py --workload <name> --seconds <s> \\
        --seeds <n>... [--control-seeds <n>...]

Prints one JSON line a run: its seed, precision, ``correct`` and each
compared number beside its limit.  The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if Path(sys.path[0]).resolve() == ROOT / "sharpbench":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    from sharpbench import run

    control = run.cell_parts(ROOT, args.workload)[2]["control"]
    runs = ([(s, "fp32") for s in args.seeds]
            + [(s, control) for s in args.control_seeds])
    for seed, precision in runs:
        res = run.run_cell(ROOT, args.workload, seed, args.seconds, False,
                           precision=precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": precision, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
