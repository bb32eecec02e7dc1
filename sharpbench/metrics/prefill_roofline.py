"""The bound of the prefill calls' work (admission waves, offline
batches; ``roofline.call_work``) over the device time of every kernel
launched inside them."""
from sharpbench.metrics import roofline_share


def read(run):
    return roofline_share(run, "prefill")
