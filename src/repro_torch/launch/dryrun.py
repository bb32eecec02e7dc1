"""Multi-pod dry run: every (arch x shape x mesh) cell's step laid out on
a production mesh, with no device — the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape decode_32k --mesh both
    REPRO_DRYRUN_SMALL=1 ...    # 16-rank meshes (4x4, 2x2x4), as the tests

For each cell this proves, on a mesh described by its axis names and
sizes alone (``sharding.MeshShape``: 16x16 = 256 ranks, or 2x16x16 = 512),
that the partition rules lay out every argument of the step, and reports
per device:

* ``memory``: the exact bytes of the step's arguments and outputs on one
  device, from their specs (a sharded dim's bytes split over its axes),
  and of the outputs that alias a donated argument.
  ``peak_bytes_per_device_lower_bound`` is arguments + outputs - aliases:
  a lower bound, since no compiler is asked for the step's temporaries.
  ``lower_bound_exceeds_hbm``: that bound alone is past one H100's HBM
  (``configs.H100.hbm_bytes``), so the cell cannot run on such a mesh
  of H100s; False proves no fit.
* ``cost_analysis``: ``flops_global``, the FLOPs of the whole (unsharded)
  step as ``torch.utils.flop_counter.FlopCounterMode`` counts them over
  the step traced on the ``meta`` device (matrix products and
  attention; no elementwise work), and ``flops_per_device_even_split``,
  that divided evenly over the ranks.

The skip rule is the reference's: long_500k needs sub-quadratic
attention.  Each cell's JSON lands in ``--out`` (artifacts/dryrun/).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tr
from repro_torch.configs import (H100, SHAPES, get_config, list_archs,
                                 supports_shape)
from repro_torch.launch.steps import (TrainSettings, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.sharding.partition import (MeshShape, axis_sizes,
                                            batch_spec, cache_specs,
                                            param_specs)

_SMALL = bool(os.environ.get("REPRO_DRYRUN_SMALL"))  # test mode: 16 ranks


def mesh_for(multi_pod: bool) -> MeshShape:
    if _SMALL:
        return (MeshShape((2, 2, 4), ("pod", "data", "model")) if multi_pod
                else MeshShape((4, 4), ("data", "model")))
    return (MeshShape((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else MeshShape((16, 16), ("data", "model")))


def settings_for(cfg, shape) -> TrainSettings:
    if shape.mode != "train":
        return TrainSettings()
    # bound activation memory: <= ~64k global tokens per microbatch
    tokens = shape.global_batch * shape.seq_len
    micro = max(1, tokens // 65536)
    while shape.global_batch % micro:
        micro -= 1
    return TrainSettings(microbatches=micro)


def specs_for(cfg, shape, mesh, specs):
    """(argument specs, output specs, donated argument indices) of the
    cell's step, as the reference's ``shardings_for`` lays them out: decode
    keeps weights stationary (TP only) unless the model is too big to be
    16-way resident; prefill and train keep FSDP."""
    tp_only = shape.mode == "decode" and cfg.num_params() <= 70e9
    p_spec = param_specs(specs["params"], mesh, multi_pod_fsdp=True,
                         fsdp=not tp_only)
    if shape.mode == "train":
        o_spec = param_specs(specs["opt_state"], mesh)
        b_spec = batch_spec(mesh, specs["batch"])
        return (p_spec, o_spec, b_spec), (p_spec, o_spec, None), (0, 1)
    if shape.mode == "prefill":
        b_spec = batch_spec(mesh, specs["batch"])
        return (p_spec, b_spec), (None, "cache"), ()
    c_spec = cache_specs(specs["cache"], mesh)
    b_spec = batch_spec(mesh, specs["batch"])
    return (p_spec, c_spec, b_spec), (None, c_spec), (1,)


def local_bytes(leaf, spec, mesh) -> int:
    """Bytes of ``leaf`` on one device under ``spec`` (None: replicated)."""
    n = leaf.numel() * leaf.element_size()
    if spec is None:
        return n
    sizes = axis_sizes(mesh)
    for entry in spec:
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            n //= sizes[a]
    return n


def tree_bytes(tree, spec_tree, mesh) -> int:
    leaves = tr.leaves(tree)
    specs = ([None] * len(leaves) if spec_tree is None
             else tr.leaves(spec_tree))
    return sum(local_bytes(x, s, mesh) for x, s in zip(leaves, specs))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}"
    if not supports_shape(cfg, shape):
        return {"cell": cell, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention"}

    t0 = time.time()
    mesh = mesh_for(multi_pod)
    settings = settings_for(cfg, shape)
    specs = input_specs(cfg, shape, settings)
    in_specs, out_specs, donate = specs_for(cfg, shape, mesh, specs)
    if shape.mode == "train":
        step = make_train_step(cfg, settings)
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.mode == "prefill":
        step = make_prefill_step(cfg, shape.seq_len)
        args = (specs["params"], specs["batch"])
    else:
        step = make_serve_step(cfg)
        args = (specs["params"], specs["cache"], specs["batch"])
    counter = FlopCounterMode(display=False)
    with counter:
        outs = step(*args)
    if shape.mode == "prefill":  # its cache is laid out by cache_specs
        out_specs = (None, cache_specs(outs[1], mesh))

    arg_bytes = sum(tree_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    out_bytes = sum(tree_bytes(o, s, mesh) for o, s in zip(outs, out_specs))
    alias = sum(tree_bytes(args[i], in_specs[i], mesh) for i in donate)
    n_dev = mesh.size
    flops = int(counter.get_total_flops())
    peak_lb = arg_bytes + out_bytes - alias
    result = {
        "cell": cell,
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_shape": list(mesh.shape),
        "n_devices": n_dev,
        "mode": shape.mode,
        "microbatches": settings.microbatches,
        "trace_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "alias_bytes_per_device": alias,
            "peak_bytes_per_device_lower_bound": peak_lb,
            "hbm_bytes_per_device": H100.hbm_bytes,
            "lower_bound_exceeds_hbm": peak_lb > H100.hbm_bytes,
        },
        "cost_analysis": {
            "flops_global": flops,
            "flops_per_device_even_split": math.ceil(flops / n_dev),
        },
    }
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{cell}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-hlo", action="store_true",
                    help="exists only for parity with the reference's CLI "
                         "and changes nothing: no HLO is made here")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    with torch.no_grad():
                        r = run_cell(arch, shape, mp, args.out)
                except Exception as e:  # a failing cell is a bug: surface it
                    mesh_name = "2x16x16" if mp else "16x16"
                    r = {"cell": f"{arch}__{shape}__{mesh_name}",
                         "status": "FAILED",
                         "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(args.out, r["cell"] + ".json"),
                              "w") as f:
                        json.dump(r, f, indent=1)
                results.append(r)
                status = r["status"]
                extra = ""
                if status == "ok":
                    gb = (r["memory"]["peak_bytes_per_device_lower_bound"]
                          / 2**30)
                    over = ("  > HBM" if r["memory"]["lower_bound_exceeds_hbm"]
                            else "")
                    extra = (f"peak >= {gb:6.2f} GiB/dev{over}  "
                             f"{r['trace_s']}s")
                elif status == "FAILED":
                    extra = r["error"][:120]
                print(f"[{status:7s}] {r['cell']:55s} {extra}", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
