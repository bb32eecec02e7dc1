"""The bound of the token engine's batched ticks' work (the family's
``call_work``: weights read once, the SSM and conv state read and
written, the live keys and values read) over the device time of every
kernel launched inside them."""
from sharpbench.metrics import roofline_share


def read(run):
    return roofline_share(run, "decode")
