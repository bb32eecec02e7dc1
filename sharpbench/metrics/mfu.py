"""Model FLOPs of every item the measured window finished, over its
seconds on the host's clock, as a share of the dense peak of the
weights' precision.  A traced run reads it from its window that runs
without the profiler."""
from sharpbench import roofline


def read(run):
    items = run.record["items"]
    if not items:
        return None
    peak = roofline.PEAK_FLOPS[run.cfg["weight_dtype"]]
    return (100.0 * items * roofline.flops_per_item(run.cfg)
            / run.record["window_s"] / peak)
