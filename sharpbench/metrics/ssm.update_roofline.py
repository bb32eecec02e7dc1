"""The ``ssm_update`` kernel's share of its bytes bound in the profiled
window: the bound (the family's ``ssm_update_bytes`` over the HBM
bandwidth) of one launch a Mamba-2 layer for every batched tick (at
``max_batch`` rows) and every remainder step (at 1 row) the trace's
``kinds`` counted, over the device time of the kernel by name in the
trace's ``device_ops``.  None where the trace holds no such kernel."""
from sharpbench import families, roofline

NAME = "ssm_update_kernel"


def read(run):
    tr = run.trace
    if not tr:
        return None
    device_s = sum(s for name, s in tr["device_ops"] if NAME in name)
    fam = families.module(run.cfg["family"])
    layers = fam.mamba_layers(run.cfg)
    nbytes = sum(tr["kinds"].get(kind, {}).get("calls", 0) * layers
                 * fam.ssm_update_bytes(run.cfg, rows)
                 for kind, rows in (("decode", run.mix["max_batch"]),
                                    ("remainder", 1)))
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / roofline.PEAK_BYTES_PER_S / device_s
