"""Metric readers: ``metrics/<name>.py`` holds ``read(run)``, which
returns the metric of one run, or None where it finds nothing to read
(the harness then leaves the metric out of the line).  ``run`` has
``cfg``, ``mix``, ``setup_s``, ``record`` (the driver's tallies of the
measured window, never profiled) and ``trace`` (the reduced device trace
of a traced run's profiled window, or None).  The helpers below are the
arithmetic that readers of several cells share."""
from __future__ import annotations


def items_per_s(run):
    return run.record["items"] / run.record["window_s"]


def per_kitem(run, counter: str):
    """A program counter's count over the window per 1,000 items."""
    items = run.record["items"]
    return 1e3 * run.record["counters"][counter] / items if items else None


def roofline_share(run, kind: str):
    """The bound of the ``kind`` calls' work over the device time of
    every kernel launched inside them."""
    k = (run.trace or {}).get("kinds", {}).get(kind)
    if not k or k["device_s"] <= 0 or k["bound_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]


def idle_share(run):
    """Share of the traced window in which no kernel, copy or fill runs
    on the device."""
    tr = run.trace
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None

