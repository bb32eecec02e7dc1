"""CLI: replay a calibration grid into artifacts/measured_costs.json.

    python -m repro_torch.calib [--grid smoke|small] [--repeats N]
                                [--warmup N] [--out PATH] [--check TOL]
                                [--no-save] [--device cuda|cpu]

``--device`` (default ``cuda``) picks the backend: the hand-written
kernels on the card, entries tagged ``cuda(<device name>)``; ``cpu`` runs
their plain versions, tagged ``torch(cpu)``.  ``--check TOL`` re-replays
every calibrated signature once after the table is built and exits
nonzero if any fresh measurement disagrees with the stored median by more
than TOL x either way (a gross check: it catches unit and lowering errors,
not scheduler jitter; 0 disables).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.calib.candidates import SMOKE_GRID, sweep_grid
from repro_torch.calib.replay import calibrate, check_table
from repro_torch.calib.table import MEASURED_COSTS_PATH, current_backend

#: --grid small: the smoke axes widened one notch per dim
SMALL_GRID = dict(families=("lstm", "gru"), Hs=(64, 128), Gs=(1, 2, 3),
                  Bs=(1, 3, 8), block_ts=(1, 8), dtypes=("float32",),
                  chained_Ls=(2, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calib",
        description="compile-and-replay calibration -> measured cost table")
    ap.add_argument("--grid", choices=("smoke", "small"), default="smoke")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--out", default=MEASURED_COSTS_PATH)
    ap.add_argument("--check", type=float, default=0.0, metavar="TOL",
                    help="re-replay each signature and fail beyond TOLx "
                         "disagreement (0 = skip)")
    ap.add_argument("--no-save", action="store_true",
                    help="replay and report without touching --out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernels on the card (default); cpu: "
                         "their plain versions")
    args = ap.parse_args(argv)

    grid = SMOKE_GRID if args.grid == "smoke" else SMALL_GRID
    cands = sweep_grid(**grid)
    print(f"calibrating {len(cands)} candidate shapes "
          f"[{current_backend(args.device)}] ({args.grid} grid, "
          f"repeats={args.repeats})")
    table = calibrate(cands, device=args.device, repeats=args.repeats,
                      warmup=args.warmup, progress=print)
    if not args.no_save:
        path = table.save(args.out)
        print(f"saved -> {path}")
    if args.check > 0:
        print(f"verifying replay vs table (tolerance {args.check:g}x):")
        bad = check_table(table, device=args.device, tolerance=args.check,
                          progress=print)
        if bad:
            print(f"FAIL: {len(bad)} signature(s) disagree beyond "
                  f"{args.check:g}x: {', '.join(bad)}")
            return 1
        print("ok: replay and table agree within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
