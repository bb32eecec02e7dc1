"""Model FLOPs of every item the measured window finished, over its
seconds on the host's clock, as a share of the dense peak of the
weights' precision.  A traced run reads it from its window that runs
without the profiler.  A family other than the LSTM stacks counts an
item's FLOPs itself (``families/<family>.py``)."""
from sharpbench import families, roofline


def read(run):
    items = run.record["items"]
    if not items:
        return None
    cfg = run.cfg
    per_item = (roofline.flops_per_item(cfg) if cfg["family"] == "lstm"
                else families.module(cfg["family"]).flops_per_item(cfg))
    peak = roofline.PEAK_FLOPS[cfg["weight_dtype"]]
    return 100.0 * items * per_item / run.record["window_s"] / peak
