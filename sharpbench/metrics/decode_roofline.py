"""The bound of the decode ticks' work (``roofline.call_work``) over the
device time of every kernel launched inside them."""
from sharpbench.metrics import roofline_share


def read(run):
    return roofline_share(run, "decode")
