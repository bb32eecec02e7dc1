#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA
GPU and check it.

    python3 chip_smoke.py [--out DIR] [--profile] [--only PHASE,...]

Phases, one line (or a few) of output each:

  1 card     the card's name and power limit (nvidia-smi), torch and CUDA
  2 build    nvcc builds both kernels from src/repro_torch/csrc (sm_90a)
  3 kernels  each CUDA kernel against its plain PyTorch version on the
             card, at the main path's shapes; median times (CUDA events)
             of the kernel, the plain version and one cuDNN nn.LSTM call
  4 serve    RecurrentServingEngine serves the paper's BYSDNE LSTM (L=5,
             H=X=340, bf16 weights from a seeded torch.Generator): 6
             requests in two admission waves, then decode ticks; every
             launch must be a kernel launch, one lstm_decode per tick, no
             degraded launch; outputs held against a device="cpu" engine
  5 forward  rnn.compile(EESEN).forward (bidirectional, L=5, H=340, fp32)
             at B=4, T=300; launches == plan.launches; output held against
             the CPU path; then, outside the counted run, the guarded
             ladder on the card: an injected fused fault recovers through
             per-step kernel launches, one past per-step raises
  6 summary  one JSON line {"kernels": [...]} with each kernel's launches,
             max error, times and bound

The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before it.  The script imports nothing of JAX and nothing of the
JAX package; it needs a CUDA card and the CUDA toolkit (nvcc).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PHASES = ("card", "build", "kernels", "serve", "forward", "summary")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit): the
# kernels compute in fp32 on the CUDA cores, so fp32 is their rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# max |kernel - plain| on identical inputs.  fp32 activations: the kernel
# and cuBLAS/PyTorch sum the 340 h.U products in different orders, and the
# difference compounds over the recurrence; bf16 activations: one bf16
# rounding of |h| < 1 is up to 2^-8 and can flip between the two.
TOL_FP32 = 1e-4
TOL_BF16 = 2e-2
# end to end against the CPU path (different GEMM libraries as well, over
# up to 300 steps x 5 layers)
TOL_E2E = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps: int, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events on the current stream (after a warm-up
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def max_err(outs, refs) -> float:
    return max(float((o.float() - r.float()).abs().max())
               for o, r in zip(outs, refs))


def profile_breakdown(fn, label: str) -> None:
    """Run ``fn`` once more under torch.profiler and print the device's
    busy share of the wall time and its time by kernel (the run's
    breakdown for PERF.md; ``--profile`` only)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print(f"{label}: profile: the profiler saw no device time")
        return
    top = "; ".join(f"{name[:48]} {us / 1e3:.2f} ms"
                    for name, us in by_name.most_common(5))
    print(f"{label}: profile: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 - 100 * busy / wall_us:.1f}%; by kernel: {top}")


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------


def phase_card(ctx):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    ctx["card"] = line
    print(line)
    print(f"card: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")


def phase_build(ctx):
    from repro_torch.kernels.lstm_cell import kernel

    t0 = time.perf_counter()
    secs = kernel.build()
    wall = time.perf_counter() - t0
    ctx["build_s"] = secs
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" (parallel, {wall:.1f} s wall) into {kernel.BUILD_DIR}")
    for name in secs:
        log = kernel.build_log(name)
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not ln.strip().startswith(
                             "0 bytes stack frame, 0 bytes spill")})
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"  {name}: {len(regs)} kernel instances; registers: "
              f"{sorted(set(r.split(',')[0] for r in regs))}; "
              f"non-zero spills: {spills or 'none'}")
        if ctx["out"]:
            with open(os.path.join(ctx["out"], f"{name}.ptxas.log"),
                      "w") as f:
                f.write(log)


def _seq_case(G, B, T, H, u_dtype, act_dtype, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    U4 = (torch.randn((G, H, 4, H), generator=g) * H ** -0.5).to(u_dtype)
    xw = torch.randn((G, B, T, 4, H), generator=g).to(act_dtype)
    h0 = (torch.randn((G, B, H), generator=g) * 0.5).to(act_dtype)
    c0 = torch.randn((G, B, H), generator=g) * 0.5
    return [t.to(dev) for t in (U4, xw, h0, c0)]


def _decode_case(L, B, H, w_dtype, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    Ws = (torch.randn((L, H, 4, H), generator=g) * s).to(w_dtype)
    Ws[0] = float("nan")  # the kernel never reads layer 0's W
    bs = (torch.randn((L, 4, H), generator=g) * 0.1).to(w_dtype)
    Us = (torch.randn((L, H, 4, H), generator=g) * s).to(w_dtype)
    xw0 = torch.randn((B, 4, H), generator=g)
    h0 = torch.randn((L, B, H), generator=g) * 0.5
    c0 = torch.randn((L, B, H), generator=g) * 0.5
    return [t.to(dev) for t in (xw0, Ws, bs, Us, h0, c0)]


def phase_kernels(ctx):
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.lstm_cell import ops

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    H = 340
    seq_err, dec_err = 0.0, 0.0
    # the main path's lstm_seq shapes: EESEN's fwd+bwd slots (G=2, B=4,
    # bt=8, fp32), BYSDNE's admission-wave slots (bf16 U, fp32 xw/h, G up
    # to 5, ragged B, remainder chunks of 5), and bf16 activations
    cases = [(2, 4, 8, f32, f32, None), (5, 4, 8, bf16, f32, [4, 3, 4, 1, 1]),
             (1, 1, 5, bf16, f32, None), (2, 2, 30, f32, f32, [2, 1]),
             (3, 4, 8, bf16, bf16, [4, 2, 1])]
    for i, (G, B, T, ud, ad, b_valid) in enumerate(cases):
        U4, xw, h0, c0 = _seq_case(G, B, T, H, ud, ad, seed=i, dev=dev)
        mask = None if b_valid is None else ragged_b_mask(G, B, b_valid, dev)
        ref = ops.lstm_seq_plain(U4, xw, h0, c0, mask)
        out = ops.lstm_seq(U4, xw, h0, c0, b_valid=b_valid)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = TOL_FP32 if ad == f32 else TOL_BF16
        print(f"kernels: lstm_seq G={G} B={B} T={T} H={H} U={ud} act={ad} "
              f"b_valid={b_valid}: max_abs_err {err:.3e} (tol {tol:g})")
        check(err <= tol, f"lstm_seq disagrees with its plain version: "
                          f"{err:.3e} > {tol:g}")
        if ad == f32:
            seq_err = max(seq_err, err)
    # a remainder walk: chunks 8+8+8+5 chained through h_T/c_T against the
    # plain version over the whole T=29
    U4, xw, h0, c0 = _seq_case(2, 4, 29, H, f32, f32, seed=7, dev=dev)
    ref = ops.lstm_seq_plain(U4, xw, h0, c0)
    outs, h, c = [], h0, c0
    for t0 in range(0, 29, 8):
        o, h, c = ops.lstm_seq(U4, xw[:, :, t0:t0 + 8], h, c, block_t=8)
        outs.append(o)
    err = max_err((torch.cat(outs, 2), h, c), ref)
    print(f"kernels: lstm_seq chunked 8+8+8+5 vs one plain walk T=29: "
          f"max_abs_err {err:.3e} (tol {TOL_FP32:g})")
    check(err <= TOL_FP32, "chunked lstm_seq walk disagrees")
    seq_err = max(seq_err, err)

    for B in (1, 4):
        for wd in (bf16, f32):
            args = _decode_case(5, B, H, wd, seed=B, dev=dev)
            ref = ops.lstm_decode_plain(*args)
            out = ops.lstm_decode(*args)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"kernels: lstm_decode L=5 B={B} H={H} W={wd} act=fp32: "
                  f"max_abs_err {err:.3e} (tol {TOL_FP32:g})")
            check(err <= TOL_FP32, f"lstm_decode disagrees with its plain "
                                   f"version: {err:.3e}")
            dec_err = max(dec_err, err)

    # ---- times at the main path's most frequent shapes -------------------
    torch.backends.cudnn.allow_tf32 = False  # cuDNN LSTM in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    G, B, T = 2, 4, 8  # EESEN forward slot: one bidirectional layer chunk
    U4, xw, h0, c0 = _seq_case(G, B, T, H, f32, f32, seed=11, dev=dev)
    k_ms = median_ms(lambda: ops.lstm_seq(U4, xw, h0, c0), reps=20)
    p_ms = median_ms(lambda: ops.lstm_seq_plain(U4, xw, h0, c0), reps=20)
    lstm = torch.nn.LSTM(H, H, num_layers=1, batch_first=True,
                         bidirectional=True).to(dev)
    x = torch.randn((B, T, H), device=dev)
    with torch.no_grad():
        l_ms = median_ms(lambda: lstm(x), reps=20)
    nbytes = 4 * (G * H * 4 * H + G * B * T * 4 * H + 2 * G * B * H
                  + G * B * T * H + 2 * G * B * H)
    flops = G * B * T * (8 * H * H + 4 * H + 10 * H)
    b_ms, b_by = bound(nbytes, flops)
    ctx["seq"] = dict(max_abs_err=seq_err, ms=k_ms, plain_ms=p_ms,
                      library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                      shape=f"G={G} B={B} T={T} H={H} fp32")
    print(f"kernels: lstm_seq at G={G} B={B} T={T} H={H} fp32: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, nn.LSTM (cuDNN, "
          f"bidirectional, input GEMM included) {l_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")

    L, B = 5, 4  # a BYSDNE decode tick: bf16 weights, fp32 state
    args = _decode_case(L, B, H, bf16, seed=12, dev=dev)
    k_ms = median_ms(lambda: ops.lstm_decode(*args), reps=50)
    p_ms = median_ms(lambda: ops.lstm_decode_plain(*args), reps=50)
    lstm = torch.nn.LSTM(H, H, num_layers=L, batch_first=True).to(dev)
    x = torch.randn((B, 1, H), device=dev)
    st = (torch.randn((L, B, H), device=dev), torch.randn((L, B, H),
                                                          device=dev))
    with torch.no_grad():
        l_ms = median_ms(lambda: lstm(x, st), reps=50)
    # W[0] and b[0] are never needed: layer 0's input half arrives hoisted
    nbytes = (2 * ((2 * L - 1) * H * 4 * H + (L - 1) * 4 * H)
              + 4 * (B * 4 * H + 4 * L * B * H))
    flops = B * ((2 * L - 1) * 8 * H * H + L * 14 * H)
    b_ms, b_by = bound(nbytes, flops)
    ctx["decode"] = dict(max_abs_err=dec_err, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"L={L} B={B} H={H} bf16 weights")
    print(f"kernels: lstm_decode at L={L} B={B} H={H} bf16 weights: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, nn.LSTM (cuDNN, fp32, "
          f"T=1, layer-0 input GEMM included) {l_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")


REQUESTS = (30, 30, 17, 45, 8, 30)


def _serve(device, params, frames):
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    eng = RecurrentServingEngine(BYSDNE, params, max_batch=4, device=device)
    for uid, fr in enumerate(frames):
        eng.submit(RecurrentRequest(uid=uid, frames=fr, max_new_frames=8))
    return eng, sorted(eng.run_to_completion(), key=lambda c: c.uid)


def phase_serve(ctx):
    import numpy as np
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq
    from repro_torch.models.layers.lstm import init_lstm_stack

    params = init_lstm_stack(torch.Generator().manual_seed(0), BYSDNE,
                             torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = [(rng.standard_normal((t, BYSDNE.lstm_input)) * 0.5)
              .astype(np.float32) for t in REQUESTS]

    reset_counts(lstm_seq, lstm_decode)
    eng, done = _serve("cuda", params, frames)
    torch.cuda.synchronize()
    seq_n, dec_n = lstm_seq.kernel_launches, lstm_decode.kernel_launches
    seq_calls, dec_calls = lstm_seq.calls, lstm_decode.calls
    st = eng.compiled.stats
    print(f"serve: {len(done)} requests, statuses "
          f"{[c.status for c in done]}, {eng.prefill_waves} waves "
          f"({eng.packed_launches} planned launches), {eng.decode_ticks} "
          f"ticks ({eng.decode_launches} planned launches); kernel "
          f"launches lstm_seq {seq_n}, lstm_decode {dec_n}; degraded "
          f"{st.degraded_launches}, fallback level {st.fallback_level}")
    check(all(c.status == "ok" for c in done), "a request did not finish ok")
    check(eng.prefill_waves == 2, "expected two admission waves")
    check(seq_n + dec_n == eng.packed_launches + eng.decode_launches,
          "kernel launches != the plans' launches")
    check(seq_n == eng.packed_launches and dec_n == eng.decode_ticks
          and eng.decode_launches == eng.decode_ticks,
          "a decode tick did not take exactly one lstm_decode launch")
    check((seq_calls, dec_calls) == (seq_n, dec_n),
          "an entry point ran without launching its kernel")
    check(st.degraded_launches == 0 and st.fallback_level == 0,
          "a launch degraded down the guarded ladder")
    ctx["launches"]["lstm_seq"] += seq_n
    ctx["launches"]["lstm_decode"] += dec_n

    _, cpu_done = _serve("cpu", params, frames)
    err = max(max(float(np.abs(g.outputs - c.outputs).max()),
                  float(np.abs(g.generated - c.generated).max()))
              for g, c in zip(done, cpu_done))
    shapes_ok = all(g.outputs.shape == (t, BYSDNE.lstm_hidden)
                    and g.generated.shape == (8, BYSDNE.lstm_hidden)
                    and np.isfinite(g.outputs).all()
                    and np.isfinite(g.generated).all()
                    for g, t in zip(done, REQUESTS))
    print(f"serve: outputs and generated frames vs the device=\"cpu\" "
          f"engine: max_abs_err {err:.3e} (tol {TOL_E2E:g}); shapes and "
          f"finiteness {'ok' if shapes_ok else 'WRONG'}")
    check(shapes_ok, "served outputs have the wrong shape or are not finite")
    check(err <= TOL_E2E, "served outputs disagree with the CPU path")

    t0 = time.perf_counter()
    eng2, _ = _serve("cuda", params, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames_out = sum(t + 8 for t in REQUESTS)
    ctx["serve_s"] = wall
    print(f"serve: warm rerun {wall * 1e3:.1f} ms wall for "
          f"{len(REQUESTS)} requests ({frames_out} prompt + generated "
          f"frames, {eng2.packed_launches + eng2.decode_launches} launches)")
    if ctx["profile"]:
        profile_breakdown(lambda: _serve("cuda", params, frames), "serve")


def phase_forward(ctx):
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import eesen_demo
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    cfg = eesen_demo()
    xs = (np.random.default_rng(1).standard_normal((4, 300, 340)) * 0.5
          ).astype(np.float32)
    cs = rnn.compile(cfg, device="cuda", seed=0)
    reset_counts(lstm_seq, lstm_decode)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = lstm_seq.kernel_launches, cs.plan.launches
    print(f"forward: EESEN B=4 T=300 -> {tuple(ys.shape)}; lstm_seq kernel "
          f"launches {n}, plan.launches {p}, lstm_decode "
          f"{lstm_decode.kernel_launches}; degraded "
          f"{cs.stats.degraded_launches}")
    check(tuple(ys.shape) == (4, 300, 680), "wrong forward output shape")
    check(bool(torch.isfinite(ys).all()), "forward output not finite")
    check(n == p == lstm_seq.calls and lstm_decode.kernel_launches == 0,
          "forward launches != plan.launches")
    check(cs.stats.degraded_launches == 0 and cs.stats.fallback_level == 0,
          "a forward launch degraded down the guarded ladder")
    ctx["launches"]["lstm_seq"] += n

    ref = rnn.compile(cfg, device="cpu", seed=0).forward(xs)
    err = float((ys.cpu() - ref).abs().max())
    print(f"forward: vs the CPU path max_abs_err {err:.3e} (tol "
          f"{TOL_E2E:g})")
    check(err <= TOL_E2E, "forward output disagrees with the CPU path")
    _check_ladder_on_card(cfg, xs, ys)

    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["forward_s"] = time.perf_counter() - t0
    print(f"forward: warm rerun {ctx['forward_s'] * 1e3:.1f} ms wall "
          f"({p} launches)")
    if ctx["profile"]:
        profile_breakdown(lambda: cs.forward(xs), "forward")


def _check_ladder_on_card(cfg, xs, healthy):
    """The guarded ladder on CUDA tensors holds kernel rungs only: a fault
    injected at the fused launch of slot 0 recovers through the per-step
    kernel launches, and one injected past per-step is raised instead of
    being computed in plain PyTorch.  Runs after the counted main path."""
    import torch

    from repro_torch import rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    from repro_torch.runtime.errors import LaunchError

    cs = rnn.compile(cfg, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cuda", seed=0)
    cs.fault.arm([0], through_level=0)
    reset_counts(lstm_seq)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    err = float((ys - healthy).abs().max())
    launched = lstm_seq.kernel_launches == lstm_seq.calls
    cs.fault.arm([0], through_level=1)
    try:
        cs.forward(xs)
        raised = None
    except LaunchError as fault:
        raised = fault.level
    print(f"forward: guarded ladder on the card: a fused fault recovers "
          f"through per-step kernel launches (degraded "
          f"{cs.stats.degraded_launches}, level {cs.stats.fallback_level}, "
          f"max_abs_err {err:.3e} vs the healthy run, every call launched "
          f"{launched}); a fault past per-step raises at level {raised!r}")
    check(cs.stats.degraded_launches == 1 and cs.stats.fallback_level == 1
          and launched and err <= TOL_FP32,
          "the per-step rung did not recover a fused fault with kernels")
    check(raised == "per_step",
          "a fault past per-step did not raise on the card")


def phase_summary(ctx):
    rows = []
    for name, key, line in (("lstm_seq", "seq", 205), ("lstm_decode",
                                                       "decode", 337)):
        m = ctx.get(key, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/lstm_cell/kernel.py:{line}",
            "launches": ctx["launches"][name],
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms"),
        })
    ctx["kernels"] = rows
    print("kernels:")
    print(json.dumps({"kernels": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="directory for nvcc's -Xptxas -v logs and a JSON "
                         "record of this run (none by default)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed reruns, run serve and forward "
                         "once more under torch.profiler and print the "
                         "device's busy share and time by kernel")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}; allowed: {', '.join(PHASES)}")

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs the CUDA kernels and needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    ctx = {"out": args.out, "profile": args.profile,
           "launches": {"lstm_seq": 0, "lstm_decode": 0}}
    t0 = time.perf_counter()
    try:
        for name in phases:
            globals()[f"phase_{name}"](ctx)
    except SmokeFailure as err:
        print(f"FAILED: {err}", flush=True)
        return 1
    total = time.perf_counter() - t0
    print(f"done: phases {','.join(phases)} in {total:.1f} s")
    if args.out:
        record = {k: v for k, v in ctx.items()
                  if k not in ("out", "profile")}
        record["seconds"] = total
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
