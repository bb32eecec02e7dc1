"""Share of the traced window in which no kernel, copy or fill runs."""
from sharpbench.metrics import idle_share as read  # noqa: F401
