"""95th percentile, over every generated frame in the window, of the time
since its stream's previous output, as a client sees them when the
engine's step returns.  A stream's first frame comes back in the step
that returns its prompt's outputs, so its gap is 0."""
import numpy as np


def read(run):
    gaps = run.record.get("gaps_ms")
    return float(np.percentile(gaps, 95)) if gaps else None
