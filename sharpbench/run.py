"""Run one cell of the benchmark once and print its result line.

    python3 sharpbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout.  Everything is found by name from
``BENCHMARK.json``: the cell's configuration in ``configs/<config>.json``,
its traffic mix in ``traffic/<traffic>.json`` (which names its loop,
``drivers/<driver>.py``), the limits of its correctness check in
``cells/<workload>.json``, and each metric's reader in
``metrics/<metric>.py``.  ``--trace 0`` reports the cell's end-to-end
metrics.  ``--trace 1`` reports its per-layer metrics from two windows:
one of ``--seconds`` without the profiler, which the readers of the
host's clock and of the program's counters read, then one of at most
``TRACE_SECONDS`` under ``torch.profiler``, which the device's readers
read.  A traced run checks what both windows produced.

The program is ``src/repro_torch`` of the same checkout; the run fails
where it is missing, where no CUDA device is present or fewer than the
cell asks for, and where the JAX package or JAX itself is loaded once
the window has closed.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__" and Path(sys.path[0]).resolve() == Path(
        __file__).resolve().parent:
    # run as a script: this folder's modules are imported as the
    # ``sharpbench`` package, never as top-level names
    sys.path.pop(0)
#: top-level module names no run may hold: JAX, and the JAX package this
#: program was ported from (compared whole: the program's own name,
#: ``repro_torch``, begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the longest window a traced run profiles: the profiler slows the host
#: and its trace takes seconds to read for every second traced
TRACE_SECONDS = 10.0


def _on_path(root: Path) -> None:
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_module(path: Path):
    """A reader or driver by file path (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "sharpbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(root: Path, workload: str):
    """The cell's entry, configuration, mix and limits, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; allowed: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    here = root / "sharpbench"
    cfg = json.loads((here / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((here / "cells" / f"{workload}.json").read_text())
    return bench, cell, cfg, mix, limits


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", precision: str = "fp32",
             t_start: float = _T0, parts=None) -> dict:
    """One run of one cell: set-up, the measured window (and in a traced
    run the profiled one after it), the metrics of the run's kind, the
    device's readings, then the correctness check with the program's
    state freed.  ``precision`` other than "fp32"
    switches on the program's own lower-precision path (the control);
    ``parts`` stands in for ``cell_parts`` (tests)."""
    _on_path(root)
    import torch

    import repro_torch
    from sharpbench.spans import Spans

    src = (root / "src").resolve()
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise ImportError(f"the program was imported from "
                          f"{repro_torch.__file__}, not from {src}")
    bench, cell, cfg, mix, limits = parts or cell_parts(root, workload)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans(cfg, trace, device)
    driver_mod = load_module(root / "sharpbench" / "drivers"
                             / f"{mix['driver']}.py")
    driver = driver_mod.Driver(cfg, mix, seed, device, spans,
                               precision=precision)
    gc.collect()
    gc.freeze()  # what set-up made stays out of the window's collections
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    records = [driver.run(seconds, spans)]
    if trace:
        spans.profiling = True
        records.append(driver.run(min(seconds, TRACE_SECONDS), spans))
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    record = records[0]
    run = SimpleNamespace(cfg=cfg, mix=mix, record=record,
                          trace=records[-1]["trace"], setup_s=setup_s)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[section]:
        if not applies(m, workload):
            continue
        value = load_module(root / "sharpbench" / "metrics"
                            / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = [driver.check(r, device) for r in records]
    checks = {name: {"value": _worst(r[name] for r in readings),
                     "limit": limit}
              for name, limit in limits["checks"].items()}
    attempted = sum(r["attempted"] for r in records)
    failed = sum(r["failed"] for r in records)
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    tr = run.trace
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def _worst(values):
    """The largest reading; NaN where any is NaN (no limit passes it)."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _, cell, _, _, _ = cell_parts(ROOT, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the run may hold "
              f"none of {', '.join(FORBIDDEN)})", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=str, allow_nan=False)
          if _finite(result) else json.dumps(_strict(result)), flush=True)
    return 0


def _finite(obj) -> bool:
    try:
        json.dumps(obj, allow_nan=False)
    except ValueError:
        return False
    return True


def _strict(obj):
    """The result with each NaN or infinity written as a string (strict
    JSON has none); a check that reads one has failed."""
    if isinstance(obj, dict):
        return {k: _strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


if __name__ == "__main__":
    sys.exit(main())
