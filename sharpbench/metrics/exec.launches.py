"""CUDA launches counted by the program's kernel entry points per
1,000 items."""
from sharpbench.metrics import per_kitem


def read(run):
    return per_kitem(run, "kernel_launches")
