"""Multi-pod dry run: every (arch x shape x mesh) cell's step laid out on
a production mesh and priced per device, with no device — the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape decode_32k --mesh both
    REPRO_DRYRUN_SMALL=1 ...    # 16-rank meshes (4x4, 2x2x4), as the tests

For each cell this proves, on rank 0 of a fake process group of the
mesh's size (``torch.distributed``'s ``"fake"`` backend: 256 ranks for
16x16, 512 for 2x16x16, 16 under ``REPRO_DRYRUN_SMALL``) and under
``FakeTensorMode`` (shapes, no storage), that the partition rules lay out
every argument of the step (``sharding.partition``'s ``param_shardings``,
``cache_shardings``, ``batch_spec`` on a ``DeviceMesh``) and that the
step runs on them: DTensor inserts its collectives, the kernels run on
the local shards (``sharding.local``).  The step is traced through
``calib.hlo`` (one line per operation this rank dispatches), and each
cell reports per device what the reference's reports:

* ``memory``: the reference's ``memory_analysis`` names — arguments,
  outputs, temporaries (the high-water mark of the storages the step
  makes, less its new outputs), aliases (outputs written into an
  argument in place: the decode step's rings, the train step's params
  and moments) and the peak, arguments + outputs + temporaries -
  aliases; and whether that peak exceeds one H100's HBM
  (``configs.H100.hbm_bytes``);
* ``cost_analysis``: ``flops``, ``bytes accessed`` and
  ``transcendentals`` of this rank's step (``calib.hlo.analyze``: the
  kernels priced by their ``Cost``);
* ``collectives``: bytes by kind, with the reference's conventions;
* ``hlo``: the path of the saved trace (``<cell>.hlo.gz``, which
  ``python -m repro_torch.calib.hlo`` reads); ``--no-hlo`` skips it.

The mesh is a ``"cpu"`` mesh (DTensor's indexing on a fake ``"cuda"``
mesh makes real CUDA tensors, which a build without CUDA cannot), and the
step is traced as the card runs it: the card's path of the products with
fp32 results (``kernels.common.card_path``: bf16 operands as they are,
no fp32 copies), the kernels priced by their ``Cost``, and DTensor's
all-gather and chunk that stand in for an all-to-all on a ``"cpu"`` mesh
recorded as the all-to-all a ``"cuda"`` mesh issues.  The skip rule is
the reference's: long_500k needs sub-quadratic attention.  Each cell's
JSON lands in ``--out`` (artifacts/dryrun/).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback

import torch

from repro_torch.calib import hlo
from repro_torch.configs import (H100, SHAPES, get_config, list_archs,
                                 supports_shape)
from repro_torch.launch.steps import (TrainSettings, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.models.layers.common import sharding_ctx
from repro_torch.sharding.partition import (MeshShape, NamedSharding,
                                            batch_spec, cache_shardings,
                                            distribute, param_shardings)
from repro_torch import tree as tr

_SMALL = bool(os.environ.get("REPRO_DRYRUN_SMALL"))  # test mode: 16 ranks


def mesh_for(multi_pod: bool) -> MeshShape:
    if _SMALL:
        return (MeshShape((2, 2, 4), ("pod", "data", "model")) if multi_pod
                else MeshShape((4, 4), ("data", "model")))
    return (MeshShape((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else MeshShape((16, 16), ("data", "model")))


def fake_mesh(shape: MeshShape, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` seen from rank 0 of a fake process
    group of its size (formed here; a group of another size is taken
    down first).  Its collectives move nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized() and (dist.get_world_size() != shape.size
                                  or dist.get_backend() != "fake"):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=shape.size)
    return init_device_mesh(device_type, shape.shape,
                            mesh_dim_names=shape.axis_names)


def settings_for(cfg, shape) -> TrainSettings:
    if shape.mode != "train":
        return TrainSettings()
    # bound activation memory: <= ~64k global tokens per microbatch
    tokens = shape.global_batch * shape.seq_len
    micro = max(1, tokens // 65536)
    while shape.global_batch % micro:
        micro -= 1
    return TrainSettings(microbatches=micro)


def shardings_for(cfg, shape, mesh, specs, settings):
    """(argument shardings, output shardings, donated argument indices) of
    the cell's step, the reference's rules: decode keeps weights
    stationary (TP only) unless the model is too big to be 16-way
    resident; prefill and train keep FSDP."""
    def ns(spec_tree):
        return tr.tree_map(lambda s: NamedSharding(mesh, s), spec_tree)

    tp_only = shape.mode == "decode" and cfg.num_params() <= 70e9
    p_sh = param_shardings(specs["params"], mesh, multi_pod_fsdp=True,
                           fsdp=not tp_only)
    if shape.mode == "train":
        o_sh = param_shardings(specs["opt_state"], mesh)
        b_sh = ns(batch_spec(mesh, specs["batch"]))
        return (p_sh, o_sh, b_sh), (p_sh, o_sh, None), (0, 1)
    if shape.mode == "prefill":
        b_sh = ns(batch_spec(mesh, specs["batch"]))
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device="meta")
        return (p_sh, b_sh), (None, cache_shardings(cache, mesh)), ()
    c_sh = cache_shardings(specs["cache"], mesh)
    b_sh = ns(batch_spec(mesh, specs["batch"]))
    return (p_sh, c_sh, b_sh), (None, c_sh), (1,)


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             save_hlo: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}"
    if not supports_shape(cfg, shape):
        return {"cell": cell, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention"}

    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    mshape = mesh_for(multi_pod)
    mesh = fake_mesh(mshape)
    settings = settings_for(cfg, shape)
    specs = input_specs(cfg, shape, settings)
    in_sh, _, _ = shardings_for(cfg, shape, mesh, specs, settings)
    if shape.mode == "train":
        step = make_train_step(cfg, settings)
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.mode == "prefill":
        step = make_prefill_step(cfg, shape.seq_len)
        args = (specs["params"], specs["batch"])
    else:
        step = make_serve_step(cfg)
        args = (specs["params"], specs["cache"], specs["batch"])
    fake = FakeTensorMode(allow_non_fake_inputs=True)  # the mesh's ranks
    args = hlo.fake_args(args, fake, device="cpu")
    with fake:
        args = tuple(distribute(a, s) for a, s in zip(args, in_sh))
    with sharding_ctx(mesh), torch.set_grad_enabled(shape.mode == "train"):
        trace, _ = hlo.run(step, *args, rank=0, world=mshape.size,
                           label=cell, card=True)
    text = trace.text()
    cost = hlo.analyze(text)
    mem = trace.memory
    n_dev = mshape.size
    result = {
        "cell": cell,
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_shape": list(mshape.shape),
        "n_devices": n_dev,
        "mode": shape.mode,
        "microbatches": settings.microbatches,
        "trace_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes_per_device": mem.argument_bytes,
            "output_bytes_per_device": mem.output_bytes,
            "temp_bytes_per_device": mem.temp_bytes,
            "alias_bytes_per_device": mem.alias_bytes,
            "peak_bytes_per_device": mem.peak_bytes,
            "hbm_bytes_per_device": H100.hbm_bytes,
            "peak_exceeds_hbm": mem.peak_bytes > H100.hbm_bytes,
        },
        "cost_analysis": {
            "flops": cost["flops"],
            "bytes accessed": cost["bytes"],
            "transcendentals": cost["transcendental_elems"],
        },
        "collectives": cost["collectives"],
        "collective_bytes": cost["collective_bytes"],
        "kernel_ops": dict(trace.kernels),
    }
    os.makedirs(outdir, exist_ok=True)
    if save_hlo:
        path = os.path.join(outdir, f"{cell}.hlo.gz")
        with gzip.open(path, "wt") as f:
            f.write(text)
        result["hlo"] = path
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
                    help="do not save each cell's trace")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    t_all = time.time()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    r = run_cell(arch, shape, mp, args.out,
                                 save_hlo=not args.no_hlo)
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
                    gb = r["memory"]["peak_bytes_per_device"] / 2**30
                    over = ("  > HBM" if r["memory"]["peak_exceeds_hbm"]
                            else "")
                    tf_ = r["cost_analysis"]["flops"] / 1e12
                    extra = (f"peak {gb:6.2f} GiB/dev{over}  "
                             f"{tf_:9.3f} TFLOP/dev  traced in "
                             f"{r['trace_s']}s")
                elif status == "FAILED":
                    extra = r["error"][:120]
                print(f"[{status:7s}] {r['cell']:55s} {extra}", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED in {time.time() - t_all:.1f}s ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
