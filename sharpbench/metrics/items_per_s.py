"""Every item the window finished (prompt items whose outputs came back,
plus generated frames), over the window's seconds on the host's clock."""
from sharpbench.metrics import items_per_s as read  # noqa: F401
