"""Plans built (plan-cache misses, each verified once; decode plans
too) per 1,000 items: the compiled stack's ``stats.plans_built``."""
from sharpbench.metrics import per_kitem


def read(run):
    return per_kitem(run, "plans_built")
