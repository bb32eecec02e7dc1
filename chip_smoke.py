#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA
GPU and check it.

    python3 chip_smoke.py [--out DIR] [--profile] [--only PHASE,...]

Phases, one line (or a few) of output each:

  1 card       the card's name and power limit (nvidia-smi), torch and
               CUDA
  2 build      nvcc builds all eight kernels from src/repro_torch/csrc
               (sm_90a), one process per source, all started together
  3 kernels    each CUDA kernel against its plain PyTorch version on the
               card, at the main path's shapes; median times (CUDA events)
               of the kernel, the plain version and one PyTorch library
               call (cuDNN nn.LSTM / nn.GRU / nn.LSTMCell, torch.matmul,
               F.scaled_dot_product_attention) as a yardstick;
               lstm_decode and gru_decode (one cluster of up to 16 CTAs
               per batch row) at L=5 H=340, L=10 H=1024 and L=3 H=50 (plain
               loads), B = 1, 4, 5, 8, bf16 and fp32 W, fp32 U under bf16
               W and bf16 state: every call one launch, bit-equal run to
               run, across B and between a graph replay and the eager
               call, the kernel's cluster size equal to decode_splits',
               its occupancy; then timed as the serving tick runs them (a
               CUDA graph of chained ticks: BYSDNE's weights from L2,
               H = 1024's alternating between two stacks from HBM; B = 4
               and 1) beside the plain version and cuDNN (fp32 and bf16
               weights) in the same graphs; lstm_seq and
               gru_seq (one cluster of up to 16 CTAs per recurrence and
               group of 4 rows, U in shared memory) also with int8 U, with
               row-compacted U and with both, at a BYSDNE int8 wavefront
               slot, and at H = 1024 (fp32, bf16, int8 U: U streamed) and
               2048, each case printing its S, rows a cluster, U resident
               or streamed and the clusters the card holds; bit for bit
               run to run, rows of B=4 against B=1 calls, G=5 against G=1,
               packed rows against solo calls, a graph replay against the
               eager call and a walk chunked 8+8+8+5 against one launch;
               timed eager and in CUDA graphs of 20 launches (the
               serving slot and each weight branch), and at
               DeepBench's (1024, 25) slot beside cuDNN; lstm_cell (a
               CTA per 8 hidden units over the whole card) at H = 50, 340,
               1024 and 4096, B = 1, 4, 5, fp32 and bf16 U and
               activations, bit-equal run to run, across B, between a
               graph replay and the eager call and across the TPU tile,
               its split equal to cell_split's, then timed warm and eager
               and as the per_step chain runs it (150 launches in one CUDA
               graph: BYSDNE's 5 U's at H = 340, 8 U's from HBM at H =
               1024) beside the plain version and nn.LSTMCell (input
               width 1; fp32 and bf16 weights) in the same graphs;
               rglru_scan (a CTA per strip of 8-32 channels walking T in
               tiles) at the rglru phase's shape, at ragged W = 33, 100,
               513 and at T = 1 and each strip width's tile edges,
               bit-equal run to run, across
               B and between one call and T split over two calls, then
               timed at B = 4 (eager) and at B = 1, T = 256, 1024, 2048
               (CUDA graphs of repeated launches); mvm (one
               thread-block cluster per 64-column stripe, X split across
               its CTAs) at the RecurrentGemma-2B decode projections (bf16,
               B = 1..4) and at ragged shapes that reach the split's edges
               (fp32 and bf16, with and without bias), bit-equal run to run
               and across B, its clusters' occupancy, then timed warm per
               projection (B = 4 and 1), and cold over the decode step's
               156 projections on distinct weights (4.0 GB, one CUDA
               graph; also per shape) beside torch.matmul and the 1.20 ms
               bound; decode_attention (one cluster of 16 CTAs per row
               and kv head, taking the ring's 32-slot tiles in turn) at
               its attention layers' decode (bf16, B = 4, T = 2048, 10
               query heads on 1 kv head of 256, mixed valid, a full ring,
               and the edge valid counts of its tiles at B = 4 and B = 1),
               an fp32 GQA shape and the scalar-load D = 20, bit-equal run
               to run, across B and between a graph replay and the eager
               call, then timed cold in CUDA graphs on distinct rings from
               HBM (kernel, plain version and SDPA alike; B = 4 and 1;
               full, mixed and ~70-slot rings) and warm and eager
  4 serve      RecurrentServingEngine serves the paper's BYSDNE LSTM (L=5,
               H=X=340, bf16 weights from a seeded torch.Generator): 6
               requests in two admission waves, then decode ticks; every
               launch must be a kernel launch, one lstm_decode per tick,
               no degraded launch; outputs held against a device="cpu"
               engine
  5 forward    rnn.compile(EESEN).forward (bidirectional, L=5, H=340,
               fp32) at B=4, T=300 (200 lstm_seq launches); launches ==
               plan.launches; output held
               against the CPU path; then, outside the counted run, the
               guarded ladder on the card: an injected fused fault
               recovers through per-step kernel launches, one past
               per-step raises
  6 serve_gru  the same 6 requests through BYSDNE as a GRU
               (rnn_family="gru", bf16 weights): gru_seq + gru_decode
               launches == the plans' launches, one gru_decode per tick,
               no degraded launch; outputs held against the CPU engine
  7 offpath    off the packed timeline: the per_step BYSDNE LSTM forward
               (B=4, T=30: 150 lstm_cell launches == plan.launches); a
               mixed lstm/gru/lstm/gru stack at H=340 (forward, then one
               decode tick resumed from its prefill state: 4 launches);
               the "unfolded" research schedule (plain PyTorch, zero
               kernel launches); each held against the CPU path
  8 rglru      one RG-LRU layer of RecurrentGemma-2B at full width (W =
               2560, B = 4, T = 2048, random weights from a seeded
               torch.Generator): gate_inputs, then dispatch.execute of an
               L=1 rglru item — one rglru_scan launch == plan.launches;
               held against the device="cpu" path; the model's L=18 item
               stays plan-only; a mixed plan of one BYSDNE LSTM item and
               one rglru item runs in one execute
  9 precision  BYSDNE as an LSTM and as a GRU (bf16 weights, layer l's U
               with every 8-row tile t, t % (l + 2) == 0, zeroed) under
               ExecutionPolicy(precision="int8", sparsity="block") at B=4,
               T=30: forward, prefill, then decode ticks resumed from the
               prefill state; then int8 alone and bf16 + block sparsity,
               forward; launches == the plans' launches in every run, each
               output held against the CPU path
 10 serve_lm   serving.ServingEngine serves RecurrentGemma-2B at full width
               (26 layers, d_model 2560, vocab 256000, bf16 weights drawn
               on the card from a seeded torch.Generator; max_batch 4,
               max_seq 4096: 2048-slot rings) 6 requests of 5, 37, 300,
               1100, 2100 and 64 prompt tokens, 16 new tokens each: every
               decode step launches 156 mvm and 8 decode_attention
               kernels, every prefill 18 rglru_scan, and no plain version
               runs; the decode step is a CUDA graph per batch size (the
               batched tick, the batch-1 remainder step), captured after
               its first eager step and replayed for every later one, and
               each replay counts the launches it holds; the logits of
               every generated token held against a teacher-forced forward
               on the card; two requests served again with a fault planted
               in each decode kernel's call (mvm loses a k-tile,
               decode_attention the newest slot), which that check must
               see; decode_attention on a clone of the engine's own cache
               at its first batched tick on a wrapped ring (8 layers, rows
               of mixed valid) against its plain version; each attention
               layer of the decode step against the teacher-forced forward
               on the same input (F3: the block's output within TOL_LAYER
               at every decoded position of every request), which must
               also catch both planted faults; the first three layers
               served on the card and by a device="cpu" engine; then a
               warm run: the first replay at
               each batch size held bit for bit against the step run
               eagerly, each step's host wall and device span (CUDA
               events), whose ratio gives the host-overhead share; then one
               more replay at each batch size under torch.profiler, whose
               kernels, counted on the device by name, must equal the
               launches the replay counted, and whose device time over
               the median span gives the device's busy share; with
               --profile, also 8 batched ticks and the 64- and 2048-token
               prefills under torch.profiler, each prefill's rglru_scan
               device ms and launches (18, one a rglru layer)
 11 summary    one JSON line {"kernels": [...]} with each kernel's (and
               each lstm_seq / gru_seq weight branch's) launches, max
               error, times and bound

With --profile, the serve, forward, serve_gru and precision phases also
print their lstm_seq / gru_seq device ms, and offpath its per_step
forward's lstm_cell device ms, and each checks the profiled launches
against the counted run's.

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
PHASES = ("card", "build", "kernels", "serve", "forward", "serve_gru",
          "offpath", "rglru", "precision", "serve_lm", "summary")
#: kernel entry point -> the TPU kernel it replaces
KERNELS = {
    "lstm_seq": "src/repro/kernels/lstm_cell/kernel.py:205",
    "lstm_decode": "src/repro/kernels/lstm_cell/kernel.py:337",
    "lstm_cell": "src/repro/kernels/lstm_cell/kernel.py:76",
    "gru_seq": "src/repro/kernels/gru_cell/kernel.py:111",
    "gru_decode": "src/repro/kernels/gru_cell/kernel.py:217",
    "rglru_scan": "src/repro/kernels/rglru/kernel.py:40",
    "mvm": "src/repro/kernels/mvm_tile/kernel.py:49",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:63",
}
#: entry points whose source file (csrc/<name>.cu) has another name
SOURCES = {"mvm": "mvm_tile"}
#: the sequence kernels' weight branches (kernels.common.seq_variant): a
#: summary row each, "lstm_seq" for dense U, "lstm_seq[int8]" and so on
VARIANTS = ("dense", "int8", "compact", "int8+compact")
SEQ_KERNELS = ("lstm_seq", "gru_seq")


def row_name(kernel: str, variant: str = "dense") -> str:
    return kernel if variant == "dense" else f"{kernel}[{variant}]"


#: summary rows: (row name — also the ctx key of its measurements —,
#: kernel source)
ROWS = tuple((row_name(k, v), k) for k in KERNELS
             for v in (VARIANTS if k in SEQ_KERNELS else ("dense",)))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit): the
# recurrent kernels' operands are fp32 (or upcast to it), so fp32 is their
# rate; the bf16 rate bounds the operations on bf16 operands (mvm,
# decode_attention on the RecurrentGemma path)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# max |kernel - plain| on identical inputs.  fp32 activations: the kernel
# and cuBLAS/PyTorch sum the 340 h.U products in different orders, and the
# difference compounds over the recurrence; bf16 activations: one bf16
# rounding of |h| < 1 is up to 2^-8 and can flip between the two.
TOL_FP32 = 1e-4
TOL_BF16 = 2e-2
# bf16 outputs of a kernel and its plain version that sum the same fp32
# products in other orders: one bf16 ulp of the largest output (2^-7
# relative), since a sum near a rounding midpoint may round either way.
# decode_attention takes it per (row, query head), of that head's largest
# output: its heads' outputs differ in scale by orders of magnitude (a
# head with one live slot returns v itself)
ULP_BF16 = 2.0 ** -7
# end to end against the CPU path (different GEMM libraries as well, over
# up to 300 steps x 5 layers)
TOL_E2E = 1e-3
# serve_lm, fp32 logits of the bf16 RecurrentGemma-2B (|logit| up to ~5
# at this init).  Against the teacher-forced forward (26 layers): the
# decode step and the forward round to bf16 at other points (mvm and
# cuBLAS sum in other orders, so an output can round to the neighbouring
# bf16 value, 2^-8 relative; the decode kernel keeps p in fp32 where the
# prefill paths round it to bf16), and such one-ulp differences enter at
# each of the 26 residual adds and travel to the logits: a few percent of
# their range, 0.25.  The JAX package's own bf16 decode differs from its
# own forward for the same reasons.  Depth 3, the card against the CPU
# engine: the same code with other summation orders and exp
# implementations, over 3 residual layers: 0.1.
TOL_LM = 0.25
TOL_LM_DEPTH3 = 0.1
# serve_lm, each attention layer of the decode step against the
# teacher-forced forward on the same input (_attn_layers_vs_forward): the
# attention block's bf16 output at a decoded position, within 2^-6 of
# that position's largest |output|, four bf16 ulps: q, k and v (mvm
# against cuBLAS) may each round to the neighbouring bf16 value, the
# forward rounds p to bf16 where the kernel keeps it in fp32 (2^-9), and
# the core and w_o's output round once more; each of those four is at
# most one ulp (2^-8) of the values it feeds, which a projection carries
# to its output at the same relative size.  A dropped slot among ~70 live
# ones moves the core by ~1/sqrt(70), ~12%, of its size.
TOL_LAYER = 2.0 ** -6
# serve_lm, a graph replay of the decode step against the same step run
# eagerly on the same inputs: the same kernels in the same order, so bit
# for bit (_replay_vs_eager)
TOL_REPLAY = 0.0


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


def graph_ms(fn, trials: int = 5) -> float:
    """Median over ``trials`` of one replay of ``fn`` captured in a CUDA
    graph, timed with CUDA events around the replay (after a warm-up
    call): the device's time for the work, without the host's time to
    enqueue it, as the decode step runs it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    del graph
    return statistics.median(out)


def max_err(outs, refs) -> float:
    return max(float((o.float() - r.float()).abs().max())
               for o, r in zip(outs, refs))


def device_events(fn):
    """Run ``fn`` under torch.profiler: (host wall in us, device time in us
    by kernel name, device events by kernel name)."""
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
    count = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
    return wall_us, by_name, count


def profile_breakdown(fn, label: str):
    """Run ``fn`` once more under torch.profiler and print the device's
    busy share of the wall time and its time by kernel (the run's
    breakdown for PERF.md; ``--profile`` only).  Returns the device time
    and events by kernel name."""
    wall_us, by_name, count = device_events(fn)
    busy = sum(by_name.values())
    if not busy:
        print(f"{label}: profile: the profiler saw no device time")
        return by_name, count
    top = "; ".join(f"{name[:48]} {us / 1e3:.2f} ms ({count[name]})"
                    for name, us in by_name.most_common(8))
    ours = []
    for kernel in DEVICE_NAMES:
        ms, k = device_share(by_name, count, kernel)
        ours.append(f"{kernel} {ms:.3f} ms ({k}"
                    + (f", {ms / k:.4f} ms each)" if k else ")"))
    print(f"{label}: profile: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 - 100 * busy / wall_us:.1f}%; {sum(count.values())} device "
          f"events; by kernel (events): {top}; the port's cluster and scan "
          f"kernels: {'; '.join(ours)}")
    return by_name, count


def _profiled_launches(label, kernel, by_name, count, launches):
    """A profiled rerun's ``kernel`` events on the device against the
    launches the counted run made (the same plan)."""
    ms, n = device_share(by_name, count, kernel)
    print(f"{label}: profile: {kernel} {ms:.3f} ms of device in {n} "
          f"launches (the counted run launched {launches})")
    check(n == launches, f"{label}: the profiler saw {n} {kernel} kernels "
                         f"for {launches} launches")


def device_share(by_name, count, kernel):
    """(device ms, events) of the port's ``kernel`` in a profile."""
    return (sum(us for n, us in by_name.items() if is_kernel(kernel, n))
            / 1e3, sum(c for n, c in count.items() if is_kernel(kernel, n)))


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entries():
    """Every kernel entry point of the port (each carries its counters)."""
    from repro_torch import kernels

    return (kernels.lstm_seq, kernels.lstm_decode, kernels.lstm_cell,
            kernels.gru_seq, kernels.gru_decode, kernels.rglru_scan,
            kernels.mvm, kernels.decode_attention)


def tally(ctx, *fns) -> None:
    """Add the kernel launches ``fns`` counted since their last reset to
    the summary's rows (the sequence kernels by weight branch)."""
    for fn in fns:
        if fn.__name__ in SEQ_KERNELS:
            check(sum(fn.variant_launches.values()) == fn.kernel_launches,
                  f"{fn.__name__}: branch counts disagree with its launches")
            for variant, n in fn.variant_launches.items():
                ctx["launches"][row_name(fn.__name__, variant)] += n
        else:
            ctx["launches"][fn.__name__] += fn.kernel_launches


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
    from repro_torch.kernels import build as kernel

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


def _seq_case(G, B, T, H, u_dtype, act_dtype, seed, dev, gates=4):
    """(U, xw, h0, c0) of a sequence kernel; the GRU's takes the first
    three (gates=3)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    U = (torch.randn((G, H, gates, H), generator=g) * H ** -0.5
         ).to(u_dtype)
    xw = torch.randn((G, B, T, gates, H), generator=g).to(act_dtype)
    h0 = (torch.randn((G, B, H), generator=g) * 0.5).to(act_dtype)
    c0 = torch.randn((G, B, H), generator=g) * 0.5
    return [t.to(dev) for t in (U, xw, h0, c0)]


def _decode_case(L, B, H, w_dtype, seed, dev, gates=4, u_dtype=None,
                 h_dtype=None):
    """(xw0, Ws, bs, Us, h0, c0) of a decode kernel, drawn on the card from
    a seeded generator; the GRU's takes the first five (gates=3).  U in
    W's type unless ``u_dtype``; xw0 and h0 fp32 unless ``h_dtype``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    s = H ** -0.5
    hd = h_dtype or torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    Ws = (randn(L, H, gates, H) * s).to(w_dtype)
    Ws[0] = float("nan")  # the kernel never reads layer 0's W
    bs = (randn(L, gates, H) * 0.1).to(w_dtype)
    Us = (randn(L, H, gates, H) * s).to(u_dtype or w_dtype)
    xw0 = randn(B, gates, H).to(hd)
    h0 = (randn(L, B, H) * 0.5).to(hd)
    c0 = randn(L, B, H) * 0.5
    return [xw0, Ws, bs, Us, h0, c0]


def phase_kernels(ctx):
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.lstm_cell import ops

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    H = 340
    seq_err = 0.0
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
              f"b_valid={b_valid}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"{_seq_shape('lstm', B, H, U4)}")
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
    ctx["lstm_seq"] = dict(max_abs_err=seq_err, ms=k_ms, plain_ms=p_ms,
                           library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                           shape=f"G={G} B={B} T={T} H={H} fp32")
    print(f"kernels: lstm_seq at G={G} B={B} T={T} H={H} fp32: kernel "
          f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
          f"{p_ms:.4f} ms, nn.LSTM (cuDNN, bidirectional, input "
          f"GEMM included) {l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; a "
          f"chain of {T} steps, so latency, not bytes, is the floor)")

    _kernels_decode(ctx, dev, "lstm")
    _kernels_gru(ctx, dev)
    _kernels_cell(ctx, dev)
    _kernels_seq_variants(ctx, dev)
    for family in ("lstm", "gru"):
        _seq_bits(dev, family)
        _seq_wide(ctx, dev, family)
        _seq_times(ctx, dev, family)
    _kernels_rglru(ctx, dev)
    _kernels_mvm(ctx, dev)
    _kernels_decode_attention(ctx, dev)


def _kernels_gru(ctx, dev):
    """gru_seq against its plain version, then timed; then gru_decode
    (``_kernels_decode``)."""
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.gru_cell import ops

    f32, bf16 = torch.float32, torch.bfloat16
    seq_err = 0.0
    # the GRU serve's gru_seq shapes at H=340 (bf16 U, fp32 xw/h, G up to
    # 5, ragged B, remainder chunks), fp32 U, bf16 activations, and H=50:
    # 3H = 150 is not a multiple of four, so the scalar instantiation runs
    cases = [(1, 1, 5, 340, bf16, f32, None),
             (5, 4, 8, 340, bf16, f32, [4, 3, 4, 1, 1]),
             (5, 2, 4, 340, f32, f32, [2, 2, 1, 2, 1]),
             (2, 4, 8, 340, f32, f32, None),
             (3, 4, 8, 340, bf16, bf16, [4, 2, 1]),
             (2, 3, 9, 50, f32, f32, [3, 1]),
             (1, 4, 6, 50, bf16, bf16, None)]
    for i, (G, B, T, H, ud, ad, b_valid) in enumerate(cases):
        U3, xw, h0, _ = _seq_case(G, B, T, H, ud, ad, seed=20 + i, dev=dev,
                                  gates=3)
        mask = None if b_valid is None else ragged_b_mask(G, B, b_valid, dev)
        ref = ops.gru_seq_plain(U3, xw, h0, mask)
        out = ops.gru_seq(U3, xw, h0, b_valid=b_valid)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = TOL_FP32 if ad == f32 else TOL_BF16
        print(f"kernels: gru_seq G={G} B={B} T={T} H={H} U={ud} act={ad} "
              f"b_valid={b_valid}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"{_seq_shape('gru', B, H, U3)}")
        check(err <= tol, f"gru_seq disagrees with its plain version: "
                          f"{err:.3e} > {tol:g}")
        if ad == f32:
            seq_err = max(seq_err, err)
    # a remainder walk: chunks 8+8+8+5 chained through h_T against the
    # plain version over the whole T=29
    U3, xw, h0, _ = _seq_case(2, 4, 29, 340, bf16, f32, seed=30, dev=dev,
                              gates=3)
    ref = ops.gru_seq_plain(U3, xw, h0)
    outs, h = [], h0
    for t0 in range(0, 29, 8):
        o, h = ops.gru_seq(U3, xw[:, :, t0:t0 + 8], h, block_t=8)
        outs.append(o)
    err = max_err((torch.cat(outs, 2), h), ref)
    print(f"kernels: gru_seq chunked 8+8+8+5 vs one plain walk T=29: "
          f"max_abs_err {err:.3e} (tol {TOL_FP32:g})")
    check(err <= TOL_FP32, "chunked gru_seq walk disagrees")
    seq_err = max(seq_err, err)

    # ---- times: a GRU serve slot (two recurrences, bf16 U) -------------
    H = 340
    G, B, T = 2, 4, 8
    U3, xw, h0, _ = _seq_case(G, B, T, H, bf16, f32, seed=31, dev=dev,
                              gates=3)
    k_ms = median_ms(lambda: ops.gru_seq(U3, xw, h0), reps=20)
    p_ms = median_ms(lambda: ops.gru_seq_plain(U3, xw, h0), reps=20)
    gru = torch.nn.GRU(H, H, num_layers=1, batch_first=True,
                       bidirectional=True).to(dev)
    x = torch.randn((B, T, H), device=dev)
    with torch.no_grad():
        l_ms = median_ms(lambda: gru(x), reps=20)
    nbytes = (2 * G * H * 3 * H
              + 4 * (G * B * T * 3 * H + G * B * H + G * B * T * H
                     + G * B * H))
    flops = G * B * T * (6 * H * H + 12 * H)
    b_ms, b_by = bound(nbytes, flops)
    ctx["gru_seq"] = dict(max_abs_err=seq_err, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                          shape=f"G={G} B={B} T={T} H={H} bf16 U, fp32 "
                                f"xw/h")
    print(f"kernels: gru_seq at G={G} B={B} T={T} H={H} bf16 U: kernel "
          f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
          f"{p_ms:.4f} ms, nn.GRU (cuDNN, fp32, bidirectional, "
          f"input GEMM included) {l_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}; a chain of {T} steps, so latency is the floor)")

    _kernels_decode(ctx, dev, "gru")


#: the decode kernels' widths (L, H): BYSDNE's, RLDRADSPR's (L = 10, H =
#: 1024) and H = 50, whose slices take plain loads (H % 4 != 0); the
#: batches each is held against its plain version at; the operand forms
#: (W, U, h and xw0 dtypes; None: U in W's type), the last two at B = 4
DECODE_WIDTHS = ((5, 340), (10, 1024), (3, 50))
DECODE_BATCHES = (1, 4, 5, 8)
DECODE_FORMS = (("bf16 W", "bfloat16", None, "float32"),
                ("fp32 W", "float32", None, "float32"),
                ("bf16 W, fp32 U", "bfloat16", "float32", "float32"),
                ("bf16 W, bf16 h", "bfloat16", None, "bfloat16"))
#: chained ticks in one timed CUDA graph: on one stack at BYSDNE's width
#: (its 8.5 MB stay in L2, as between serving ticks), and alternating
#: between two stacks at H = 1024 (160 MB each, so every tick reads its
#: weights from HBM)
DECODE_TICKS = {340: (20, 1), 1024: (4, 2)}


def _decode_family(family):
    """(entry point, plain version, gates) of the ``family`` decode
    kernel."""
    if family == "lstm":
        from repro_torch.kernels.lstm_cell import ops
        return ops.lstm_decode, ops.lstm_decode_plain, 4
    from repro_torch.kernels.gru_cell import ops
    return ops.gru_decode, ops.gru_decode_plain, 3


def _decode_outs(out):
    return out if isinstance(out, tuple) else (out,)


def _decode_row(args, r):
    """A decode call's operands cut to batch row r (B = 1)."""
    xw0, Ws, bs, Us, *state = args
    return [xw0[r:r + 1], Ws, bs, Us] + [t[:, r:r + 1] for t in state]


def _decode_bound(gates, L, B, H):
    """The least time of one tick with bf16 weights and fp32 state: W_1..
    W_(L-1), U_0..U_(L-1) and b_1..b_(L-1) read once, xw0, h0 (and c0)
    read and h_n (and c_n) written once; 2 gates H^2 FMAs per row and
    matrix."""
    state = 4 if gates == 4 else 2
    nbytes = (2 * ((2 * L - 1) * H * gates * H + (L - 1) * gates * H)
              + 4 * (B * gates * H + state * L * B * H))
    flops = B * ((2 * L - 1) * 2 * gates * H * H + L * 14 * H)
    return bound(nbytes, flops)


def _chained(fn, xw0, stacks, state, n):
    """n decode ticks, tick t on stacks[t % len(stacks)], the state of
    each tick feeding the next."""
    for t in range(n):
        Ws, bs, Us = stacks[t % len(stacks)]
        state = _decode_outs(fn(xw0, Ws, bs, Us, *state))
    return state


def _cudnn_ms(mods, x, state, n):
    """cuDNN's multi-layer nn.LSTM / nn.GRU at T = 1, the state chained
    over n calls (module t % len(mods)): (ms a call, method) — a CUDA
    graph of the n calls, or, where cuDNN's RNN cannot be captured, CUDA
    events around the n calls run back to back; (None, reason) where the
    module refuses the inputs."""
    import torch

    def run():
        st = state
        for t in range(n):
            _, st = mods[t % len(mods)](x, st)

    with torch.no_grad():
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as err:
            return None, f"refused: {str(err).splitlines()[0][:80]}"
        try:
            return graph_ms(run) / n, "graph"
        except RuntimeError as err:
            torch.cuda.synchronize()
            why = str(err).splitlines()[0][:80]
            return median_ms(run, reps=1) / n, f"events (no capture: {why})"


def _kernels_decode(ctx, dev, family):
    """``family``'s decode kernel against its plain version at
    DECODE_WIDTHS x DECODE_BATCHES in DECODE_FORMS; every call one launch,
    bit-equal run to run, each row of a batch bit-equal to its B = 1 call,
    a graph replay bit-equal to the eager call; its clusters' occupancy;
    then timed (``_decode_times``)."""
    import torch

    from repro_torch.kernels.common import (decode_clusters, decode_splits,
                                            reset_counts)

    fn, plain, gates = _decode_family(family)
    name = fn.__name__
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    err_max, seed = 0.0, 200 if family == "lstm" else 300
    for L, H in DECODE_WIDTHS:
        for B in DECODE_BATCHES:
            for form, wd, ud, hd in DECODE_FORMS:
                if form in ("bf16 W, fp32 U", "bf16 W, bf16 h") and B != 4:
                    continue
                seed += 1
                args = _decode_case(L, B, H, dts[wd], seed, dev, gates,
                                    u_dtype=dts.get(ud), h_dtype=dts[hd])
                args = args if family == "lstm" else args[:5]
                ref = _decode_outs(plain(*args))
                reset_counts(fn)
                out = _decode_outs(fn(*args))
                again = _decode_outs(fn(*args))
                rows = [_decode_outs(fn(*_decode_row(args, r)))
                        for r in range(B)] if B > 1 else []
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if hd == "float32" else TOL_BF16
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                batch = all(torch.equal(o[:, r], x[:, 0])
                            for r, row in enumerate(rows)
                            for o, x in zip(out, row))
                n = fn.kernel_launches
                print(f"kernels: {name} L={L} B={B} H={H} {form}, "
                      f"{'bf16' if hd == 'bfloat16' else 'fp32'} state (S="
                      f"{decode_splits(H, gates)}): max_abs_err {err:.3e} "
                      f"(tol {tol:g}); two runs bit-equal {same}; rows == "
                      f"their B=1 calls {batch if B > 1 else 'n/a'}; "
                      f"launches {n}")
                check(err <= tol, f"{name} disagrees with its plain version "
                                  f"({form}, B={B}, H={H}): {err:.3e}")
                check(same and batch, f"{name} L={L} B={B} H={H} {form}: not "
                                      "bit-equal run to run or across B")
                check(n == 2 + len(rows), f"{name}: {n} launches for "
                                          f"{2 + len(rows)} calls")
                if hd == "float32":
                    err_max = max(err_max, err)
        # a CUDA graph's replay is the eager call
        args = _decode_case(L, 4, H, torch.bfloat16, seed, dev, gates)
        args = args if family == "lstm" else args[:5]
        eager = _decode_outs(fn(*args))
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            replayed = _decode_outs(fn(*args))
        graph.replay()
        torch.cuda.synchronize()
        replay = all(torch.equal(a, b) for a, b in zip(replayed, eager))
        del graph
        print(f"kernels: {name} L={L} B=4 H={H} bf16 W: a CUDA graph's "
              f"replay == the eager call {replay}")
        check(replay, f"{name} H={H}: a graph replay differs from the "
                      "eager call")
        for B in (1, 4):
            S, n_cl = decode_clusters(family, B, H)
            print(f"kernels: {name} H={H} B={B}: clusters of S={S} CTAs "
                  f"(decode_splits {decode_splits(H, gates)}), one a row; "
                  f"cudaOccupancyMaxActiveClusters {n_cl}")
            check(S == decode_splits(H, gates) and n_cl > 0,
                  f"{name} H={H}: the kernel's cluster size {S} is not "
                  f"decode_splits', or its cluster does not fit ({n_cl})")
    ctx[name] = dict(max_abs_err=err_max)
    _decode_times(ctx, dev, family)


def _decode_times(ctx, dev, family):
    """``family``'s decode kernel timed as the serving tick runs it: a CUDA
    graph of chained ticks (DECODE_TICKS) at BYSDNE's width (L = 5, H =
    340) and RLDRADSPR's (L = 10, H = 1024), bf16 weights and fp32 state,
    B = 4 and 1; the plain version and cuDNN's nn.LSTM / nn.GRU (fp32
    weights, and bf16 where cuDNN takes them; layer 0's input GEMM
    included) alike; then warm and eager at BYSDNE's B = 4, as the earlier
    eager timings did.  The bound is the HBM bound of a cold tick at both
    widths, while BYSDNE's chained ticks read their weights from L2."""
    import torch

    fn, plain, gates = _decode_family(family)
    name = fn.__name__
    f32, bf16 = torch.float32, torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's RNN in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    rnn = torch.nn.LSTM if family == "lstm" else torch.nn.GRU
    times = ctx.setdefault(f"{name}_times", {})
    for L, H in DECODE_WIDTHS[:2]:
        n, n_stacks = DECODE_TICKS[H]
        cases = [_decode_case(L, 4, H, bf16, 400 + i, dev, gates)
                 for i in range(n_stacks)]
        stacks = [tuple(c[1:4]) for c in cases]
        mods = {dt: [rnn(H, H, num_layers=L, batch_first=True).to(dev, dt)
                     for _ in range(n_stacks)] for dt in (f32, bf16)}
        for B in (4, 1):
            xw0, h0, c0 = (cases[0][0][:B].contiguous(),
                           cases[0][4][:, :B].contiguous(),
                           cases[0][5][:, :B].contiguous())
            state = (h0, c0) if family == "lstm" else (h0,)

            def ticks(f):
                return lambda: _chained(f, xw0, stacks, state, n)

            k_ms = graph_ms(ticks(fn)) / n
            p_ms = graph_ms(ticks(plain), trials=3) / n
            lib = {}
            for dt in (f32, bf16):
                x = torch.randn((B, 1, H), device=dev, dtype=dt)
                st = tuple(t.to(dt) for t in state)
                lib[dt] = _cudnn_ms(mods[dt], x,
                                    st if family == "lstm" else st[0], n)
            bd_ms, bd_by = _decode_bound(gates, L, B, H)
            times[f"B{B} L{L} H{H}"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib[f32][0],
                library_method=lib[f32][1], library_bf16_ms=lib[bf16][0],
                library_bf16_method=lib[bf16][1], bound_ms=bd_ms,
                bound_by=bd_by)
            cu = ", ".join(
                f"{t} " + (f"{ms:.4f} ({how})" if ms is not None else how)
                for t, (ms, how) in (("fp32 W", lib[f32]),
                                     ("bf16 W", lib[bf16])))
            print(f"kernels: {name} tick at L={L} B={B} H={H} bf16 W, fp32 "
                  f"state, one CUDA graph of {n} chained ticks on "
                  f"{n_stacks} stack(s), ms a tick: kernel {k_ms:.4f}, plain "
                  f"{p_ms:.4f}; {rnn.__name__} (cuDNN, layer-0 input GEMM included) "
                  f"{cu}; bound {bd_ms:.6f} ({bd_by}); kernel / bound "
                  f"{k_ms / bd_ms:.2f}")
        del cases, stacks, mods
        torch.cuda.empty_cache()
    # warm and eager at BYSDNE's B = 4 (the earlier eager condition)
    L, H = DECODE_WIDTHS[0]
    args = _decode_case(L, 4, H, bf16, 420, dev, gates)
    args = args if family == "lstm" else args[:5]
    w_ms = median_ms(lambda: fn(*args), reps=50)
    print(f"kernels: {name} warm and eager at L={L} B=4 H={H} bf16 W: "
          f"kernel {w_ms:.4f} ms")
    row = times[f"B4 L{L} H{H}"]
    ctx[name].update(
        ms=row["ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], warm_ms=w_ms,
        condition=f"L={L} B=4 H={H} bf16 W, fp32 state; ms, plain_ms and "
                  f"library_ms (cuDNN fp32, {row['library_method']}) a tick "
                  f"of {DECODE_TICKS[H][0]} chained ticks in one CUDA graph "
                  "with the weights warm in L2, warm_ms warm and eager; "
                  "bound_ms the HBM bound of a cold tick")


#: lstm_cell's widths, each taken apart differently by its split: H = 50
#: (plain loads; the last CTA holds 2 of its 8 units), BYSDNE's 340 (8-byte
#: bf16 vectors; the last CTA 4 units), RLDRADSPR's 1024 and 4096 (16-byte
#: bf16 vectors; 4096 lies past the sequence kernels' limit); its operand
#: forms (U, then xw and h dtypes), each at B = 1, 4 and 5
CELL_WIDTHS = (50, 340, 1024, 4096)
CELL_FORMS = (("float32", "float32"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16"))
#: the per_step schedule's chain of launches as one CUDA graph: (distinct
#: U's, launches on one before the next) -- BYSDNE's 5 layers of 30 steps,
#: layer after layer (each U warm in L2 after its first step); at H = 1024
#: the launches cycle through 8 U's (67 MB, past the 50 MB L2), so each
#: launch reads its U from HBM
CELL_CHAINS = {340: (5, 30), 1024: (8, 1)}
CELL_CHAIN_LAUNCHES = 150


def _cell_case(B, H, u_dtype, act_dtype, seed, dev):
    """(U4, xw_t, h_prev, c_prev) of lstm_cell, drawn on the card from a
    seeded generator: U scaled by H^-1/2, c_prev fp32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return [(randn(H, 4, H) * H ** -0.5).to(u_dtype),
            randn(B, 4, H).to(act_dtype), (randn(B, H) * 0.5).to(act_dtype),
            randn(B, H) * 0.5]


def _cell_bound(B, H, u_bytes):
    """The least time of one step: U read once, xw, h and c read and h, c
    written once (fp32), 8 H^2 + 14 H operations a row at the fp32 rate."""
    nbytes = u_bytes * H * 4 * H + 4 * (B * 4 * H + 4 * B * H)
    return bound(nbytes, B * (8 * H * H + 14 * H))


def cell_chain_ms(fn, Us, xws, h, c, order) -> float:
    """ms a launch of ``fn(U, xw_t, h, c) -> (h, c)`` chained over
    ``order`` (the index into ``Us`` of each launch; launch i takes
    ``xws[i]``, and h and c feed forward), the chain captured in one CUDA
    graph, as the per_step schedule runs it (``graph_ms``)."""

    def run():
        hh, cc = h, c
        for i, l in enumerate(order):
            hh, cc = fn(Us[l], xws[i], hh, cc)

    return graph_ms(run) / len(order)


def _cell_chains(dev):
    """lstm_cell as the per_step schedule runs it (CELL_CHAINS): one CUDA
    graph of CELL_CHAIN_LAUNCHES launches at B = 4, bf16 U and fp32 xw, h,
    c, at H = 340 and 1024; then the plain version and nn.LSTMCell (fp32
    and bf16 weights) in the same kind of graph.  nn.LSTMCell takes an
    input of width 1, so its input GEMM reads 4H weights and it moves the
    kernel's bytes: one U-sized recurrent matrix a step.  Returns {H:
    {label: ms a launch, "bound": ms}}."""
    import torch

    from repro_torch.kernels.lstm_cell import ops

    B, n = 4, CELL_CHAIN_LAUNCHES
    out = {}
    for H, (n_u, run) in CELL_CHAINS.items():
        Us = [_cell_case(1, H, torch.bfloat16, torch.float32, 600 + i,
                         dev)[0] for i in range(n_u)]
        order = [i // run % n_u for i in range(n)]
        g = torch.Generator(device=dev).manual_seed(700 + H)
        xws = torch.randn((n, B, 4, H), generator=g, device=dev)
        h = torch.randn((B, H), generator=g, device=dev) * 0.5
        c = torch.randn((B, H), generator=g, device=dev) * 0.5
        times = {"kernel": cell_chain_ms(ops.lstm_cell, Us, xws, h, c,
                                         order),
                 "plain": cell_chain_ms(ops.lstm_cell_plain, Us, xws, h, c,
                                        order)}
        x = torch.randn((n, B, 1), generator=g, device=dev)
        for dt, label in ((torch.float32, "nn.LSTMCell fp32"),
                          (torch.bfloat16, "nn.LSTMCell bf16")):
            mods = [torch.nn.LSTMCell(1, H).to(dev, dt) for _ in range(n_u)]
            with torch.no_grad():
                times[label] = cell_chain_ms(
                    lambda m, x_t, hh, cc: m(x_t, (hh, cc)), mods, x.to(dt),
                    h.to(dt), c.to(dt), order)
            del mods
        b_ms, b_by = _cell_bound(B, H, 2)
        times["bound"] = b_ms
        out[H] = times
        print(f"kernels: lstm_cell per_step chain at B={B} H={H} bf16 U, "
              f"fp32 xw/h/c, one CUDA graph of {n} launches on {n_u} U's "
              f"({run} in a row), ms a launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                          if k != "bound")
              + f"; bound {b_ms:.6f} ({b_by})")
        del Us, xws
        torch.cuda.empty_cache()
    return out


def _kernels_cell(ctx, dev):
    """lstm_cell (a CTA per 8 hidden units over the whole card) against its
    plain version at CELL_WIDTHS x CELL_FORMS x B = 1, 4, 5; bit-equal run
    to run, across B, between a graph replay and the eager call and across
    the TPU tile (block_h, block_k); one launch a call; the C side's split
    equal to cell_split's; then timed warm and eager at the per_step
    BYSDNE step and in the per_step chain's CUDA graphs."""
    import torch

    from repro_torch.kernels.common import (cell_shape, cell_smem,
                                            cell_split, reset_counts)
    from repro_torch.kernels.lstm_cell import ops

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cell_err, seed = 0.0, 50
    for H in CELL_WIDTHS:
        for ud, ad in CELL_FORMS:
            u_dtype, a_dtype = dts[ud], dts[ad]
            sp = cell_split(H, u_dtype.itemsize)
            for B in (1, 4, 5):
                seed += 1
                args = _cell_case(B, H, u_dtype, a_dtype, seed, dev)
                ref = ops.lstm_cell_plain(*args)
                reset_counts(ops.lstm_cell)
                out = ops.lstm_cell(*args)
                again = ops.lstm_cell(*args)
                rows = [ops.lstm_cell(args[0], *(t[r:r + 1]
                                                 for t in args[1:]))
                        for r in range(B)] if B > 1 else []
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if ad == "float32" else TOL_BF16
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                batch = all(torch.equal(o[r:r + 1], x)
                            for r, row in enumerate(rows)
                            for o, x in zip(out, row))
                n = ops.lstm_cell.kernel_launches
                shape = cell_shape(B, H, u_dtype)
                want = dict(ctas_x=sp["ctas"], ctas_y=-(-B // 4),
                            V=sp["V"], KG=sp["KG"],
                            smem=cell_smem(H, u_dtype.itemsize, B))
                print(f"kernels: lstm_cell B={B} H={H} U={ud} act={ad}: "
                      f"grid {shape['ctas_x']}x{shape['ctas_y']} CTAs, V="
                      f"{shape['V']}, KG={shape['KG']}, smem "
                      f"{shape['smem']} B; max_abs_err {err:.3e} (tol "
                      f"{tol:g}); two runs bit-equal {same}; rows == their "
                      f"B=1 calls {batch if B > 1 else 'n/a'}; launches {n}")
                check(err <= tol, f"lstm_cell disagrees with its plain "
                                  f"version (B={B} H={H} U={ud} act={ad}): "
                                  f"{err:.3e} > {tol:g}")
                check(same and batch, f"lstm_cell B={B} H={H}: not bit-equal "
                                      "run to run or across B")
                check(n == 2 + len(rows), f"lstm_cell: {n} launches for "
                                          f"{2 + len(rows)} calls")
                check(shape == want, f"lstm_cell B={B} H={H}: the kernel's "
                                     f"split {shape} is not cell_split's "
                                     f"{want}")
                if ad == "float32":
                    cell_err = max(cell_err, err)
    # the per_step BYSDNE step: a graph's replay, the TPU tile
    args = _cell_case(4, 340, torch.bfloat16, torch.float32, 55, dev)
    eager = ops.lstm_cell(*args)
    tiles = all(torch.equal(a, b) for bh, bk in ((128, 8), (8, 5), (340, 24))
                for a, b in zip(ops.lstm_cell(*args, block_h=bh,
                                              block_k=bk), eager))
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        replayed = ops.lstm_cell(*args)
    graph.replay()
    torch.cuda.synchronize()
    replay = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    del graph
    ctas = cell_split(340, 2)["ctas"]
    print(f"kernels: lstm_cell B=4 H=340 bf16 U: {ctas} CTAs; a CUDA "
          f"graph's replay == the eager call {replay}; block_h / block_k "
          f"change no bit {tiles}")
    check(replay and tiles and ctas >= 32,
          "lstm_cell: a graph replay or another TPU tile changed the "
          "output, or the split has fewer than 32 CTAs at H = 340")

    # warm and eager at the per_step BYSDNE step (the earlier condition)
    B, H = 4, 340
    U4, xw, h, c = args
    w_ms = median_ms(lambda: ops.lstm_cell(U4, xw, h, c), reps=100)
    wp_ms = median_ms(lambda: ops.lstm_cell_plain(U4, xw, h, c), reps=100)
    cell = torch.nn.LSTMCell(1, H).to(dev)
    x = torch.randn((B, 1), device=dev)
    with torch.no_grad():
        wl_ms = median_ms(lambda: cell(x, (h, c)), reps=100)
    print(f"kernels: lstm_cell warm and eager at B={B} H={H} bf16 U: kernel "
          f"{w_ms:.4f} ms, plain {wp_ms:.4f} ms, nn.LSTMCell (fp32, input "
          f"width 1) {wl_ms:.4f} ms")
    chains = _cell_chains(dev)
    b_ms, b_by = _cell_bound(B, H, 2)
    t, wide = chains[340], chains[1024]
    ctx["lstm_cell"] = dict(
        max_abs_err=cell_err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["nn.LSTMCell fp32"], bound_ms=b_ms, bound_by=b_by,
        warm_ms=w_ms, wide_ms=wide["kernel"], wide_bound_ms=wide["bound"],
        chains=chains,
        condition=f"B={B} H={H} bf16 U, fp32 xw/h/c; ms, plain_ms and "
                  f"library_ms (nn.LSTMCell(1, H), fp32 weights) a launch "
                  f"of the per_step chain's {CELL_CHAIN_LAUNCHES} launches "
                  "in one CUDA graph, on 5 U's 30 launches each, so 29 of "
                  "30 launches read U from L2, while bound_ms is a cold "
                  "step's HBM bound; warm_ms warm and eager; wide_ms the "
                  "same chain at H=1024 cycling 8 U's, each launch's U from "
                  "HBM, against wide_bound_ms")


def _weight_branch(U, variant: str, first_layer: int = 0):
    """(U, u_scales, u_rows) of one sequence-kernel weight branch for the
    G cells of U (G, H, gates, H): cell g stands for layer first_layer + g
    of the precision phase's stack, whose 8-row tiles t with
    t % (layer + 2) == 0 are zeroed (so the cells keep different row
    counts and a compacted launch pads them to one Ha); then U is
    quantized per gate ("int8") and/or row-compacted ("compact")."""
    import torch

    from repro_torch.kernels import quant

    G, H = U.shape[0], U.shape[1]
    U = U.float().clone()
    maps = []
    for g in range(G):
        keep = tuple(int(t % (first_layer + g + 2) != 0)
                     for t in range(-(-H // 8)))
        for t, bit in enumerate(keep):
            if not bit:
                U[g, t * 8:(t + 1) * 8] = 0.0
        maps.append(keep)
    scales = rows = None
    if "int8" in variant:
        q = [quant.quantize_per_gate(U[g]) for g in range(G)]
        U = torch.stack([u for u, _ in q])
        scales = torch.stack([sc for _, sc in q])
    if "compact" in variant:
        Ha = max(len(quant.active_row_indices(m, H)) for m in maps)
        c = [quant.compact_rows(U[g], maps[g], pad_to=Ha) for g in range(G)]
        U = torch.stack([u for u, _ in c])
        rows = torch.stack([r for _, r in c])
    return U, scales, rows


def _seq_bound(family, G, B, T, H, U, scales, rows, act_bytes=4):
    """Least time of one sequence-kernel launch: bytes (U in its stored
    type, its scales and row index, xw, state in and out, hs) or FLOPs
    (the h·U products over the rows U holds, and the cell's pointwise
    work), whichever is larger."""
    gates = 4 if family == "lstm" else 3
    Hr = U.shape[1]
    nbytes = (U.numel() * U.element_size()
              + (0 if scales is None else 4 * scales.numel())
              + (0 if rows is None else 4 * rows.numel())
              + act_bytes * (G * B * T * gates * H + G * B * T * H
                             + 2 * G * B * H))
    if family == "lstm":
        nbytes += 4 * 2 * G * B * H  # c0 in, c_T out
        flops = G * B * T * (8 * Hr * H + 4 * H + 10 * H)
    else:
        flops = G * B * T * (6 * Hr * H + 12 * H)
    if scales is not None:
        flops += G * B * T * gates * H
    return bound(nbytes, flops)


def _seq_family(family):
    """(gates, entry point, plain version) of the ``family`` sequence
    kernel."""
    if family == "lstm":
        from repro_torch.kernels.lstm_cell import ops
        return 4, ops.lstm_seq, ops.lstm_seq_plain
    from repro_torch.kernels.gru_cell import ops
    return 3, ops.gru_seq, ops.gru_seq_plain


def _seq_shape(family, B, H, U) -> str:
    """What the C side takes for a ``family`` sequence launch at (B, H,
    U's rows and type): S, rows a cluster, U resident or streamed, shared
    memory a CTA and clusters the card holds at once (at least one); S and
    the shared memory held against kernels.common.seq_splits / seq_smem."""
    from repro_torch.kernels.common import seq_shape, seq_smem, seq_splits

    gates = 4 if family == "lstm" else 3
    args = (H, gates, U.element_size(), U.shape[1])
    sh = seq_shape(family, B, H, U.shape[1], U.dtype)
    check((sh["S"], sh["smem"]) == (seq_splits(*args), seq_smem(*args))
          and sh["clusters"] >= 1,
          f"{family}_seq H={H} B={B}: the kernel's launch {sh} is not "
          f"seq_splits' / seq_smem's, or the card holds none of its "
          f"clusters")
    where = ("resident" if not sh["ring"] else
             f"streamed through a {sh['ring']} B ring")
    return (f"S={sh['S']} R={sh['R']}, U {where}, {sh['smem']} B shared a "
            f"CTA, {sh['clusters']} clusters at once")


def _graph_ms_each(fn, n=20) -> float:
    """ms a call of ``fn`` in one CUDA graph of ``n`` calls, so that
    launch latency does not hide the kernel."""
    return graph_ms(lambda: [fn() for _ in range(n)]) / n


#: the bit-for-bit checks' cases: (H, U dtype, weight branch), each at
#: G = 5, B = 4, T = 29 with fp32 activations
SEQ_BIT_CASES = ((340, "float32", "dense"), (340, "bfloat16", "dense"),
                 (340, "float32", "int8+compact"), (1024, "float32", "dense"),
                 (1024, "bfloat16", "dense"), (50, "float32", "dense"))


def _seq_bits(dev, family):
    """The sequence kernel's fixed sum order, bit for bit at each
    SEQ_BIT_CASES case: two runs; each row of a B=4 call against its B=1
    call; each recurrence of a G=5 call against its G=1 call; a packed
    call (b_valid) whose valid rows equal the full call's and whose masked
    rows keep h0 (and c0); a CUDA graph's replay against the eager call;
    and the walk chunked 8+8+8+5 through h_T (and c_T) against one launch
    over T=29."""
    import torch

    gates, seq, _ = _seq_family(family)
    name = f"{family}_seq"
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    G, B, T = 5, 4, 29

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for i, (H, ud, variant) in enumerate(SEQ_BIT_CASES):
        U, xw, h0, c0 = _seq_case(G, B, T, H, dts[ud], torch.float32,
                                  seed=500 + i, dev=dev, gates=gates)
        sc = rows = None
        if variant != "dense":
            U, sc, rows = _weight_branch(U, variant, first_layer=0)
        st = [h0, c0] if family == "lstm" else [h0]

        def run(u, x, state, **kw):
            return seq(u, x, *state, u_scales=kw.pop("sc", sc),
                       u_rows=kw.pop("rows", rows), **kw)

        full = run(U, xw, st)
        ok = {"run to run": same(full, run(U, xw, st))}
        ok["rows of B=4 == B=1 calls"] = all(
            same([o[:, b:b + 1] for o in full],
                 run(U, xw[:, b:b + 1], [t[:, b:b + 1] for t in st]))
            for b in range(B))
        ok["G=5 == G=1 calls"] = all(
            same([o[g:g + 1] for o in full],
                 run(U[g:g + 1], xw[g:g + 1], [t[g:g + 1] for t in st],
                     sc=None if sc is None else sc[g:g + 1],
                     rows=None if rows is None else rows[g:g + 1]))
            for g in range(G))
        b_valid = [4, 3, 2, 1, 4]
        packed = run(U, xw, st, b_valid=b_valid)
        ok["packed rows == solo"] = all(
            torch.equal(p[g, :n], f[g, :n])
            for p, f in zip(packed, full) for g, n in enumerate(b_valid))
        ok["masked rows keep the state"] = all(
            torch.equal(packed[0][g, b], h0[g, b][None].expand(T, H))
            and all(torch.equal(p[g, b], s[g, b])
                    for p, s in zip(packed[1:], st))
            for g, n in enumerate(b_valid) for b in range(n, B))
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            replayed = run(U, xw, st)
        graph.replay()
        torch.cuda.synchronize()
        ok["graph replay == eager"] = same(replayed, full)
        del graph
        outs, state = [], st
        for t0 in range(0, T, 8):
            o, *state = run(U, xw[:, :, t0:t0 + 8], state, block_t=8)
            outs.append(o)
        ok["8+8+8+5 == one launch"] = same([torch.cat(outs, 2)] + state,
                                           full)
        torch.cuda.synchronize()
        print(f"kernels: {name} bits at G={G} B={B} T={T} H={H} U={ud} "
              f"{variant}: " + "; ".join(f"{k} {v}" for k, v in ok.items())
              + f" ({_seq_shape(family, B, H, U)})")
        check(all(ok.values()), f"{name} H={H} U={ud} {variant}: not bit "
                                f"for bit: {ok}")


#: the sequence kernels' widest cases, held against the plain version:
#: (G, B, T, H, U dtype, weight branch) -- DeepBench's (1024, 25) slot of
#: the paper's sweep in three U types, its widest H, and a launch of 10
#: clusters at H = 340, more than the card holds at once (waves)
SEQ_WIDE = ((1, 4, 25, 1024, "float32", "dense"),
            (1, 4, 25, 1024, "bfloat16", "dense"),
            (1, 4, 25, 1024, "float32", "int8"),
            (1, 4, 8, 2048, "bfloat16", "dense"),
            (5, 8, 8, 340, "float32", "dense"))


def _seq_wide(ctx, dev, family):
    """SEQ_WIDE against the plain version (fp32 activations, TOL_FP32);
    the errors join their summary rows' max_abs_err."""
    import torch

    gates, seq, plain = _seq_family(family)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, (G, B, T, H, ud, variant) in enumerate(SEQ_WIDE):
        U, xw, h0, c0 = _seq_case(G, B, T, H, dts[ud], torch.float32,
                                  seed=520 + i, dev=dev, gates=gates)
        sc = rows = None
        if variant != "dense":
            U, sc, rows = _weight_branch(U, variant, first_layer=0)
        st = (h0, c0) if family == "lstm" else (h0,)
        ref = plain(U, xw, *st, None, sc, rows)
        out = seq(U, xw, *st, u_scales=sc, u_rows=rows)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        key = row_name(f"{family}_seq", variant)
        print(f"kernels: {key} G={G} B={B} T={T} H={H} U={U.dtype}: "
              f"max_abs_err {err:.3e} (tol {TOL_FP32:g}); "
              f"{_seq_shape(family, B, H, U)}, {G * -(-B // 4)} clusters "
              f"a launch")
        check(err <= TOL_FP32, f"{key} H={H} disagrees with its plain "
                               f"version: {err:.3e}")
        ctx[key]["max_abs_err"] = max(ctx[key]["max_abs_err"], err)


def _seq_times(ctx, dev, family):
    """The sequence kernel timed at DeepBench's (1024, 25) slot (G=1, B=4,
    T=25, fp32 and bf16 U: U streamed from L2 each step), beside the
    plain version and cuDNN's nn.LSTM /
    nn.GRU (fp32, one layer, input GEMM included); and at the serving slot
    (G=2 B=4 T=8 H=340) in a CUDA graph of 20 launches, so that launch
    latency does not hide the kernel."""
    import torch

    gates, seq, plain = _seq_family(family)
    name = f"{family}_seq"
    times = ctx.setdefault(f"{name}_times", {})
    rnn = torch.nn.LSTM if family == "lstm" else torch.nn.GRU
    for ud in (torch.float32, torch.bfloat16):
        G, B, T, H = 1, 4, 25, 1024
        U, xw, h0, c0 = _seq_case(G, B, T, H, ud, torch.float32, seed=540,
                                  dev=dev, gates=gates)
        st = (h0, c0) if family == "lstm" else (h0,)
        k_ms = median_ms(lambda: seq(U, xw, *st), reps=5)
        p_ms = median_ms(lambda: plain(U, xw, *st), reps=2, trials=3)
        mod = rnn(H, H, batch_first=True).to(dev)
        x = torch.randn((B, T, H), device=dev)
        with torch.no_grad():
            l_ms = median_ms(lambda: mod(x), reps=5)
        b_ms, b_by = _seq_bound(family, G, B, T, H, U, None, None)
        times[f"G{G} B{B} T{T} H{H} {ud}"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
            bound_by=b_by)
        print(f"kernels: {name} at G={G} B={B} T={T} H={H} U={ud}: kernel "
              f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
              f"{p_ms:.4f}, {rnn.__name__} (cuDNN, fp32, "
              f"input GEMM included) {l_ms:.4f}, bound {b_ms:.6f} ({b_by})")
        del U, xw, mod
    G, B, T, H = 2, 4, 8, 340
    ud = torch.float32 if family == "lstm" else torch.bfloat16
    U, xw, h0, c0 = _seq_case(G, B, T, H, ud, torch.float32, seed=541,
                              dev=dev, gates=gates)
    st = (h0, c0) if family == "lstm" else (h0,)
    g_ms = _graph_ms_each(lambda: seq(U, xw, *st))
    times[f"G{G} B{B} T{T} H{H} {ud}, graph of 20"] = dict(ms=g_ms)
    ctx[name]["graph_ms"] = g_ms
    print(f"kernels: {name} at G={G} B={B} T={T} H={H} U={ud} in a CUDA "
          f"graph of 20 launches: kernel {g_ms:.4f} ms a launch "
          f"({1e3 * g_ms / T:.2f} us a step)")


def _kernels_seq_variants(ctx, dev):
    """lstm_seq and gru_seq with int8 U, with row-compacted U and with
    both, against their plain versions on the same operands, then timed at
    a BYSDNE int8 wavefront slot (G=2 cells of layers 1 and 2, B=4, 15
    steps, H=340)."""
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.gru_cell import ops as gops
    from repro_torch.kernels.lstm_cell import ops as lops

    f32, bf16 = torch.float32, torch.bfloat16
    fams = {"lstm": (4, lops.lstm_seq, lops.lstm_seq_plain),
            "gru": (3, gops.gru_seq, gops.gru_seq_plain)}
    # wavefront slots at H=340 (ragged B, remainder chunks, bf16
    # activations) and H=50, whose last 8-row tile is 2 rows and whose 3H
    # takes the GRU kernel's scalar path
    cases = [(2, 4, 15, 340, f32, None, 1), (5, 4, 8, 340, f32,
                                             [4, 3, 4, 1, 1], 0),
             (3, 4, 8, 340, bf16, [4, 2, 1], 2), (2, 3, 9, 50, f32, [3, 1], 0)]
    for family, (gates, seq, plain) in fams.items():
        for variant in VARIANTS[1:]:
            err_max = 0.0
            for i, (G, B, T, H, ad, b_valid, l0) in enumerate(cases):
                U, xw, h0, c0 = _seq_case(G, B, T, H, f32, ad, seed=60 + i,
                                          dev=dev, gates=gates)
                U, sc, rows = _weight_branch(U, variant, first_layer=l0)
                mask = (None if b_valid is None
                        else ragged_b_mask(G, B, b_valid, dev))
                st = (h0, c0) if family == "lstm" else (h0,)
                ref = plain(U, xw, *st, mask, sc, rows)
                out = seq(U, xw, *st, b_valid=b_valid, u_scales=sc,
                          u_rows=rows)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if ad == f32 else TOL_BF16
                print(f"kernels: {family}_seq[{variant}] G={G} B={B} T={T} "
                      f"H={H} Hr={U.shape[1]} act={ad} b_valid={b_valid}: "
                      f"max_abs_err {err:.3e} (tol {tol:g}); "
                      f"{_seq_shape(family, B, H, U)}")
                check(err <= tol, f"{family}_seq[{variant}] disagrees with "
                                  f"its plain version: {err:.3e} > {tol:g}")
                if ad == f32:
                    err_max = max(err_max, err)
            # a remainder walk: chunks 8+8+8+5 chained through the state
            # against one plain walk over T=29
            U, xw, h0, c0 = _seq_case(2, 4, 29, 340, f32, f32, seed=70,
                                      dev=dev, gates=gates)
            U, sc, rows = _weight_branch(U, variant, first_layer=3)
            st = [h0, c0] if family == "lstm" else [h0]
            ref = plain(U, xw, *st, None, sc, rows)
            outs = []
            for t0 in range(0, 29, 8):
                o, *st = seq(U, xw[:, :, t0:t0 + 8], *st, u_scales=sc,
                             u_rows=rows, block_t=8)
                outs.append(o)
            err = max_err([torch.cat(outs, 2)] + st, ref)
            print(f"kernels: {family}_seq[{variant}] chunked 8+8+8+5 vs one "
                  f"plain walk T=29: max_abs_err {err:.3e} (tol "
                  f"{TOL_FP32:g})")
            check(err <= TOL_FP32, f"chunked {family}_seq[{variant}] walk "
                                   "disagrees")
            err_max = max(err_max, err)

            G, B, T, H = 2, 4, 15, 340
            U, xw, h0, c0 = _seq_case(G, B, T, H, f32, f32, seed=71,
                                      dev=dev, gates=gates)
            U, sc, rows = _weight_branch(U, variant, first_layer=1)
            st = (h0, c0) if family == "lstm" else (h0,)
            def call():
                return seq(U, xw, *st, u_scales=sc, u_rows=rows)

            k_ms = median_ms(call, reps=20)
            g_ms = _graph_ms_each(call)
            p_ms = median_ms(lambda: plain(U, xw, *st, None, sc, rows),
                             reps=20)
            b_ms, b_by = _seq_bound(family, G, B, T, H, U, sc, rows)
            key = row_name(f"{family}_seq", variant)
            ctx[key] = dict(max_abs_err=err_max, ms=k_ms, plain_ms=p_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by,
                            graph_ms=g_ms,
                            shape=f"G={G} B={B} T={T} H={H} Hr={U.shape[1]} "
                                  f"{U.dtype} U, fp32 xw/h")
            print(f"kernels: {key} at G={G} B={B} T={T} H={H} "
                  f"Hr={U.shape[1]} U={U.dtype}: kernel {k_ms:.4f} ms "
                  f"eager, {g_ms:.4f} ms a launch in a CUDA graph of 20 "
                  f"({1e3 * g_ms / T:.2f} us a step), plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
                  f"no library call takes this weight form")


def _rglru_case(B, T, W, seed, dev):
    """(log_a, gx, h0) of the scan: log_a = -|N|·0.3, gx and h0 N(0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    log_a = -torch.randn((B, T, W), generator=g).abs() * 0.3
    gx = torch.randn((B, T, W), generator=g)
    h0 = torch.randn((B, W), generator=g)
    return [t.to(dev) for t in (log_a, gx, h0)]


#: rglru_scan's bytes an element: log_a and gx read, hs written (fp32)
RGLRU_BYTES = 12
#: rglru_scan's fp32 operations an element (an fma counted as two): two of
#: XLA's exps of 26 each (clamp 2, range reduction 5, polynomial 14, the
#: final add, 2^n 2, product 1), 2 la, 1 - a2, max, sqrt, s g and the
#: step's fma
RGLRU_OPS = 59
#: B = 1 (serve_lm's prefills) timed at these T, in a CUDA graph of
#: RGLRU_GRAPH_LAUNCHES launches
RGLRU_B1_T = (256, 1024, 2048)
RGLRU_GRAPH_LAUNCHES = 20


def _rglru_bound(B, T, W):
    return bound(RGLRU_BYTES * B * T * W + 8 * B * W,
                 RGLRU_OPS * B * T * W)


def _rglru_same(a, b) -> bool:
    """Every tensor of ``a`` bit-equal to its twin in ``b``."""
    import torch

    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def _kernels_rglru(ctx, dev):
    """rglru_scan against its plain version at the rglru phase's shape, at
    ragged widths and at the edges of each strip width's tiles; bit for
    bit run to run, across B (a row of a B = 4 call against the B = 1 call
    on that row, which takes other strips) and between one call and the
    same T split over two calls (the second from the first's h_T); then
    timed at the rglru phase's shape (eager, as the phase runs it) and at
    B = 1 at serve_lm's prefill buckets (CUDA graphs of repeated
    launches)."""
    import torch

    from repro_torch.kernels.rglru import ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scan = ops.rglru_scan
    err_max = 0.0

    def held(args, label):
        nonlocal err_max
        ref = ops.rglru_scan_plain(*args)
        out = scan(*args)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        exact = bool(torch.equal(out[0][:, -1], out[1]))
        again = _rglru_same(scan(*args), out)
        B, T, W = args[0].shape
        C, steps = ops.scan_tile(B, W, sms)
        print(f"kernels: rglru_scan {label}B={B} T={T} W={W} (strips of "
              f"{C}, tiles of {steps} steps): max_abs_err {err:.3e} (tol "
              f"{TOL_FP32:g}); hs[:, -1] == h_T {exact}; bit-equal run to "
              f"run {again}")
        check(err <= TOL_FP32 and exact and again,
              f"rglru_scan disagrees with its plain version or itself at "
              f"B={B} T={T} W={W}: {err:.3e}")
        err_max = max(err_max, err)

    cases = {}
    for i, (B, T, W) in enumerate(((4, 2048, 2560), (1, 64, 513),
                                   (3, 13, 100), (2, 1, 33))):
        cases[(B, T, W)] = args = _rglru_case(B, T, W, seed=80 + i, dev=dev)
        held(args, "")
    # the tiles' edges: T = 1 and a tile's steps -1, 0, +1 for each strip
    # width (B picks it at W = 2560), and the ragged widths
    edges = []
    for B in (4, 2, 1):
        _, steps = ops.scan_tile(B, 2560, sms)
        edges += [(B, T, 2560) for T in (1, steps - 1, steps, steps + 1)]
    _, steps = ops.scan_tile(1, 513, sms)
    edges += [(B, T, W) for B in (1, 4) for W in (33, 513)
              for T in (1, steps - 1, steps + 1)]
    for i, (B, T, W) in enumerate(edges):
        held(_rglru_case(B, T, W, seed=100 + i, dev=dev), "edge ")

    # across B: each row of the B = 4 call against the B = 1 call on it
    la, gx, h0 = cases[(4, 2048, 2560)]
    full = scan(la, gx, h0)
    rows = all(_rglru_same(scan(la[b:b + 1], gx[b:b + 1], h0[b:b + 1]),
                           (full[0][b:b + 1], full[1][b:b + 1]))
               for b in range(4))
    # one call against the same T split over two calls
    split = []
    for (B, T, W), cut in (((4, 2048, 2560), 1000), ((1, 64, 513), 37)):
        la, gx, h0 = cases[(B, T, W)]
        whole = scan(la, gx, h0)
        hs1, h1 = scan(la[:, :cut].contiguous(), gx[:, :cut].contiguous(), h0)
        hs2, h2 = scan(la[:, cut:].contiguous(), gx[:, cut:].contiguous(), h1)
        split.append(_rglru_same((torch.cat([hs1, hs2], 1), h2), whole))
    torch.cuda.synchronize()
    print(f"kernels: rglru_scan bit for bit: rows of B=4 T=2048 W=2560 == "
          f"the B=1 calls {rows}; one call == two calls split at T=1000 "
          f"(B=4 T=2048 W=2560) {split[0]}, at T=37 (B=1 T=64 W=513) "
          f"{split[1]}")
    check(rows and all(split), "rglru_scan is not bit-equal across B or "
                               "across a split of T")

    B, T, W = 4, 2048, 2560
    args = _rglru_case(B, T, W, seed=90, dev=dev)
    k_ms = median_ms(lambda: scan(*args), reps=20)
    p_ms = median_ms(lambda: ops.rglru_scan_plain(*args), reps=1, trials=3)
    b_ms, b_by = _rglru_bound(B, T, W)
    nbytes = RGLRU_BYTES * B * T * W
    print(f"kernels: rglru_scan at B={B} T={T} W={W} (eager): kernel "
          f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s, "
          f"{k_ms / b_ms:.2f}x the bound), plain {p_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); no single PyTorch call computes a gated "
          f"linear recurrence")
    ctx["rglru_scan"] = dict(max_abs_err=err_max, ms=k_ms, plain_ms=p_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"B={B} T={T} W={W} fp32")
    n = RGLRU_GRAPH_LAUNCHES
    for T in RGLRU_B1_T:
        args = _rglru_case(1, T, W, seed=91, dev=dev)
        ms = graph_ms(lambda: [scan(*args) for _ in range(n)]) / n
        b_ms, b_by = _rglru_bound(1, T, W)
        print(f"kernels: rglru_scan at B=1 T={T} W={W} (one CUDA graph of "
              f"{n} launches): kernel {ms:.4f} ms a launch "
              f"({RGLRU_BYTES * T * W / ms / 1e6:.1f} GB/s, "
              f"{ms / b_ms:.2f}x the bound), bound {b_ms:.6f} ms ({b_by})")
        if T == 2048:
            ctx["rglru_scan"].update(b1_ms=ms, b1_bound_ms=b_ms)


#: the decode step's projections of RecurrentGemma-2B (X, N): the MLP's
#: w_gate / w_up, its w_down, the RG-LRU block's w_in / w_gate / w_out and
#: the attention block's w_q / w_o, and its w_kv
MVM_SHAPES = ((2560, 7680), (7680, 2560), (2560, 2560), (2560, 512))
#: ragged shapes that reach the cluster split's edges: X = 5 < S (CTAs
#: with empty X-slices), X = 2561 (a ragged last slice), N = 129 (the
#: scalar-load instance and a ragged stripe), N = 520 (a ragged stripe)
MVM_EDGES = ((5, 129), (2561, 520), (2561, 129), (5, 520))


def _mvm_step_mix(n_layers, kinds):
    """The (X, N) of the decode step's projections, in its order: per
    rglru layer w_gate, w_in, w_out (2560 x 2560), per attn layer w_q
    (2560 x 2560), w_kv (2560 x 512), w_o (2560 x 2560), then every
    layer's MLP w_gate, w_up (2560 x 7680) and w_down (7680 x 2560)."""
    d, ff, kv = 2560, 7680, 512
    mix = []
    for kind in kinds[:n_layers]:
        mix += [(d, d), (d, kv), (d, d)] if kind == "attn" else [(d, d)] * 3
        mix += [(d, ff), (d, ff), (ff, d)]
    return mix


def _kernels_mvm(ctx, dev):
    """mvm against its plain version at the decode step's projections (B =
    1..4) and at ragged shapes that reach the cluster split's edges (fp32
    and bf16, with and without bias); two runs bit-equal and a row of a B
    = 4 call bit-equal to the same row at B = 1; then timed warm at each
    projection (B = 4 and 1) and cold over the decode step's 156
    projections on distinct weights."""
    import torch

    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.kernels.mvm_tile import ops

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator().manual_seed(100)
    err_max = 0.0
    cases = [(B, X, N, bf16, False) for X, N in MVM_SHAPES
             for B in (1, 2, 3, 4)]
    cases += [(3, X, N, dt, with_b) for X, N in MVM_EDGES
              for dt in (f32, bf16) for with_b in (False, True)]
    cases += [(1, 2560, 7680, bf16, True)]
    inputs = {}
    for B, X, N, dt, with_b in cases:
        x = torch.randn((B, X), generator=g).to(dev, dt)
        W = (torch.randn((X, N), generator=g) * X ** -0.5).to(dev, dt)
        b = torch.randn((N,), generator=g).to(dev) if with_b else None
        ref = ops.mvm_plain(x, W, b)
        out = ops.mvm(x, W, b)
        again = ops.mvm(x, W, b)
        row0 = ops.mvm(x[:1].contiguous(), W, b)
        torch.cuda.synchronize()
        err = max_err((out,), (ref,))
        tol = (TOL_FP32 if dt == f32
               else ULP_BF16 * float(ref.float().abs().max()))
        same = bool(torch.equal(out, again))
        batch = bool(torch.equal(out[:1], row0))
        print(f"kernels: mvm B={B} X={X} N={N} {dt} bias={with_b} "
              f"(S={ops.splits(X, N)}): max_abs_err {err:.3e} (tol "
              f"{tol:g}); two runs bit-equal {same}; row 0 == its B=1 call "
              f"{batch}")
        check(err <= tol and out.dtype == dt,
              f"mvm disagrees with its plain version: {err:.3e} > {tol:g}")
        check(same and batch, f"mvm B={B} X={X} N={N}: not bit-equal run "
                              "to run, or a row differs from its B=1 call")
        err_max = max(err_max, err)
        if not with_b and (X, N) in MVM_SHAPES and B in (1, 4):
            inputs[(B, X, N)] = (x, W)

    for X, N in MVM_SHAPES:
        S = ops.splits(X, N)
        ctas = -(-N // ops.STRIPE) * S
        n_cl = [ops.max_clusters(B, X, N) for B in (1, 4)]
        print(f"kernels: mvm X={X} N={N}: clusters of S={S} CTAs, {ctas} "
              f"CTAs a launch per 4 rows; cudaOccupancyMaxActiveClusters "
              f"{n_cl[0]} (B=1), {n_cl[1]} (B=4): one wave "
              f"{n_cl[1] * S >= ctas}")
        check(min(n_cl) > 0, f"mvm: a cluster of {S} CTAs does not fit")

    # warm: 5 x 50 back-to-back launches on one W.  A 2560 x 7680 bf16 W
    # (39.3 MB) fits in the 50 MB L2, so these launches reread W from L2
    # and can beat the HBM bound; the step mix below cannot.
    for B in (4, 1):
        for X, N in MVM_SHAPES:
            x, W = inputs[(B, X, N)]
            k_ms = median_ms(lambda: ops.mvm(x, W), reps=50)
            p_ms = median_ms(lambda: ops.mvm_plain(x, W), reps=50)
            l_ms = median_ms(lambda: torch.matmul(x, W), reps=50)
            nbytes = 2 * (X * N + B * X + B * N)
            b_ms, b_by = bound(nbytes, 2 * B * X * N, PEAK_BF16_FLOPS)
            print(f"kernels: mvm warm (W from L2) at B={B} X={X} N={N} "
                  f"bf16: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} "
                  f"GB/s), plain {p_ms:.4f} ms, torch.matmul (cuBLAS) "
                  f"{l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
            ctx.setdefault("mvm_shapes", {})[f"B{B} {X}x{N}"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by)

    # cold: the decode step's 156 projections in its order, each on its own
    # weight (4.0 GB of bf16, so nothing is reread from L2), captured in a
    # CUDA graph as the decode step runs them, and timed with CUDA events
    # around the whole sequence's replay
    cfg = recurrentgemma_2b.config()
    mix = _mvm_step_mix(cfg.n_layers, cfg.layer_kinds())
    gen = torch.Generator(device=dev).manual_seed(101)
    Ws = [torch.randn((X, N), generator=gen, device=dev, dtype=bf16)
          for X, N in mix]
    for B in (1, 4):
        xs = {X: torch.randn((B, X), generator=gen, device=dev, dtype=bf16)
              for X in {X for X, _ in mix}}
        k_ms = graph_ms(lambda: [ops.mvm(xs[W.shape[0]], W) for W in Ws])
        l_ms = graph_ms(lambda: [torch.matmul(xs[W.shape[0]], W)
                                 for W in Ws])
        nbytes = sum(2 * (X * N + B * X + B * N) for X, N in mix)
        flops = sum(2 * B * X * N for X, N in mix)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        print(f"kernels: mvm step mix ({len(mix)} projections on distinct "
              f"weights, {nbytes / 1e9:.3f} GB) at B={B}: kernel {k_ms:.4f} "
              f"ms ({nbytes / k_ms / 1e6:.1f} GB/s), torch.matmul (cuBLAS) "
              f"{l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); kernel / "
              f"bound {k_ms / b_ms:.2f}, kernel / matmul {k_ms / l_ms:.2f}")
        ctx.setdefault("mvm_step_mix", {})[f"B{B}"] = dict(
            ms=k_ms, library_ms=l_ms, bound_ms=b_ms, gb=nbytes / 1e9)
        # the mix by shape: each shape's distinct weights in one graph, per
        # launch, kernel beside torch.matmul (and, for the summary's row,
        # the plain version) under the same condition
        for X, N in MVM_SHAPES:
            sub = [W for W in Ws if tuple(W.shape) == (X, N)]
            x = xs[X]
            k_ms = graph_ms(lambda: [ops.mvm(x, W) for W in sub]) / len(sub)
            l_ms = graph_ms(lambda: [torch.matmul(x, W)
                                     for W in sub]) / len(sub)
            cold = dict(ms=k_ms, library_ms=l_ms)
            if B == 4 and (X, N) == MVM_SHAPES[0]:
                cold["plain_ms"] = graph_ms(
                    lambda: [ops.mvm_plain(x, W) for W in sub]) / len(sub)
            print(f"kernels: mvm step mix by shape at B={B} X={X} N={N} "
                  f"({len(sub)} distinct weights, one graph, S="
                  f"{ops.splits(X, N)}), ms a launch: kernel {k_ms:.4f}, "
                  f"torch.matmul (cuBLAS) {l_ms:.4f}"
                  + (f", plain {cold['plain_ms']:.4f}"
                     if "plain_ms" in cold else ""))
            ctx.setdefault("mvm_cold", {})[f"B{B} {X}x{N}"] = cold
    # the summary's row: the widest projection at B = 4 as the decode step
    # runs it, cold in a graph, the kernel, its plain version and
    # torch.matmul alike; the warm eager time (PR 14's row) beside it
    X, N = MVM_SHAPES[0]
    warm = ctx["mvm_shapes"][f"B4 {X}x{N}"]
    cold = ctx["mvm_cold"][f"B4 {X}x{N}"]
    ctx["mvm"] = dict(max_abs_err=err_max, ms=cold["ms"],
                      plain_ms=cold["plain_ms"], library_ms=cold["library_ms"],
                      bound_ms=warm["bound_ms"], bound_by=warm["bound_by"],
                      warm_ms=warm["ms"],
                      condition=f"B=4 X={X} N={N} bf16; ms, plain_ms and "
                                "library_ms cold in a CUDA graph, warm_ms "
                                "warm and eager")
    del Ws
    torch.cuda.empty_cache()


def _attn_case(B, T, Hq, Hk, D, dt, valid, seed, dev):
    """(q, k_cache, v_cache, valid) of the decode attention kernel."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g).to(dev, dt)
    k = torch.randn((B, T, Hk, D), generator=g).to(dev, dt)
    v = torch.randn((B, T, Hk, D), generator=g).to(dev, dt)
    return q, k, v, torch.tensor(valid, dtype=torch.int32, device=dev)


def _attn_share(out, ref) -> float:
    """The worst |kernel - plain| over its limit (<= 1 passes): fp32
    within TOL_FP32; bf16 per (row, query head), one bf16 ulp of that
    head's largest output (ULP_BF16)."""
    import torch

    diff = (out.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        return float(diff.max()) / TOL_FP32
    limit = ULP_BF16 * ref.float().abs().amax(-1)
    return float((diff.amax(-1) / limit).max())


#: the RecurrentGemma-2B attention layers' decode shape (B, T, Hq, Hk, D)
ATTN_SHAPE = (4, 2048, 10, 1, 256)
#: decode_attention's timed rings: a full ring, the kernels phase's mixed
#: valid, and rings like serve_lm's (~70 live slots for most steps), at
#: B = 4 and B = 1
ATTN_RINGS = {4: {"full": [2048] * 4, "mixed": [1, 700, 1537, 2048],
                  "serve": [65, 70, 72, 75]},
              1: {"full": [2048], "mixed": [1537], "serve": [70]}}
#: distinct ring pairs in one timed graph: at least the decode step's 8
#: attention layers, and together more than the 50 MB L2 (x 1.25), so
#: every launch reads its rings from HBM
L2_BYTES = 50e6


def _kernels_decode_attention(ctx, dev):
    """decode_attention against its plain version at the attention layers'
    decode (mixed valid, a full ring, the edge valid counts of the kernel's
    tiles at B = 4 and B = 1), an fp32 GQA shape and a head dim that
    takes the scalar loads; bit-equal run to run, across B and between a
    graph replay and the eager call; its clusters' occupancy; then timed
    cold in CUDA graphs (ATTN_RINGS; the kernel, its plain version and
    F.scaled_dot_product_attention alike, each launch on its own rings)
    and warm and eager on a full ring, as PRs 14 and 16 timed it."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, T, Hq, Hk, D = ATTN_SHAPE
    G = Hq // Hk
    mixed = ATTN_RINGS[4]["mixed"]
    # the edge valid counts of the kernel's tiles: 0 (every slot masked),
    # 1, 2, the first tile boundary, the end of the cluster's first round
    # of tiles (R slots), each +- 1, T - 1, T and past T
    tile, R = ops.TILE, ops.splits(T) * ops.TILE
    edges = [0, 1, 2, tile - 1, tile, tile + 1, R - 1, R, R + 1, T - 1, T,
             T + 5]
    err_max = 0.0
    cases = [
        (_attn_case(B, T, Hq, Hk, D, bf16, mixed, 110, dev),
         f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid={mixed}"),
        (_attn_case(B, T, Hq, Hk, D, bf16, [T] * B, 111, dev),
         f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid=T"),
        (_attn_case(2, 256, 8, 2, 64, f32, [3, 256], 112, dev),
         "B=2 T=256 Hq=8 Hk=2 D=64 fp32 valid=[3, 256]"),
        # D = 20: the scalar-load instance (not a multiple of 8 bf16)
        (_attn_case(2, 128, 6, 3, 20, bf16, [50, 128], 114, dev),
         "B=2 T=128 Hq=6 Hk=3 D=20 bf16 valid=[50, 128]")]
    # three calls of four rows and one call per row
    q, k, v, vl = _attn_case(len(edges), T, Hq, Hk, D, bf16, edges, 115, dev)
    for lo in range(0, len(edges), B):
        rows = slice(lo, lo + B)
        cases.append(((q[rows], k[rows], v[rows], vl[rows]),
                      f"B={B} T={T} bf16 valid={edges[rows]}"))
    for r in range(len(edges)):
        cases.append(((q[r:r + 1], k[r:r + 1], v[r:r + 1], vl[r:r + 1]),
                      f"B=1 T={T} bf16 valid={edges[r]}"))
    for args, label in cases:
        bt = ops.default_block_t(args[1].shape[1])
        ref = ops.decode_attention_plain(*args, block_t=bt)
        out = ops.decode_attention(*args)
        again = ops.decode_attention(*args)
        torch.cuda.synchronize()
        share = _attn_share(out, ref)
        same = bool(torch.equal(out, again))
        print(f"kernels: decode_attention {label} (S="
              f"{ops.splits(args[1].shape[1])}): max_abs_err "
              f"{max_err((out,), (ref,)):.3e} (worst head at {share:.3f} of "
              f"its limit); two runs bit-equal {same}")
        check(share <= 1.0, f"decode_attention disagrees with its plain "
                            f"version ({label}): {share:.3f} of the limit")
        check(same, f"decode_attention {label}: two runs differ")
        err_max = max(err_max, max_err((out,), (ref,)))
    # a row is bit-equal at B = 4 and B = 1, and a graph replay is the eager
    # call
    rows4 = ops.decode_attention(q[:B], k[:B], v[:B], vl[:B])
    alone = [ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                  vl[r:r + 1]) for r in range(B)]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        replayed = ops.decode_attention(q[:B], k[:B], v[:B], vl[:B])
    graph.replay()
    torch.cuda.synchronize()
    batch = all(torch.equal(rows4[r], alone[r][0]) for r in range(B))
    replay = bool(torch.equal(replayed, rows4))
    del graph
    print(f"kernels: decode_attention rows of a B={B} call == their B=1 "
          f"calls {batch}; a CUDA graph's replay == the eager call {replay}")
    check(batch and replay, "decode_attention: a row differs between B=4 "
                            "and B=1, or a replay from the eager call")
    n_cl = [ops.max_clusters(b, T, Hk, G, D) for b in (1, B)]
    print(f"kernels: decode_attention T={T}: clusters of S={ops.splits(T)} "
          f"CTAs ({ops.splits(T) * Hk} CTAs a row); "
          f"cudaOccupancyMaxActiveClusters {n_cl[0]} (B=1), {n_cl[1]} "
          f"(B={B}): one wave {n_cl[1] >= B * Hk}")
    check(min(n_cl) > 0, "decode_attention: a cluster does not fit")

    # cold: each ring case as a CUDA graph of n launches on n distinct ring
    # pairs (n >= 8, the decode step's attention layers, and more than L2
    # holds), per launch; the kernel, the plain version and SDPA alike
    gen = torch.Generator(device=dev).manual_seed(116)
    for b, rings in ATTN_RINGS.items():
        ring_bytes = 2 * b * T * Hk * D * 2
        n = max(8, math.ceil(1.25 * L2_BYTES / ring_bytes))
        sets = [[torch.randn(shape, generator=gen, device=dev, dtype=bf16)
                 for shape in ((b, Hq, D), (b, T, Hk, D), (b, T, Hk, D))]
                for _ in range(n)]
        # SDPA's layout (B, H, T, D), made outside the timed graph
        sdpa = [(qq[:, :, None], kk.transpose(1, 2).contiguous(),
                 vv.transpose(1, 2).contiguous()) for qq, kk, vv in sets]
        for name, valid in rings.items():
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            mask = (torch.arange(T, device=dev)[None, :] < vl[:, None])[
                :, None, None, :]
            k_ms = graph_ms(lambda: [ops.decode_attention(qq, kk, vv, vl)
                                     for qq, kk, vv in sets]) / n
            p_ms = graph_ms(lambda: [ops.decode_attention_plain(
                qq, kk, vv, vl, block_t=ops.default_block_t(T))
                for qq, kk, vv in sets], trials=3) / n
            l_ms = graph_ms(lambda: [F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
                for qs, ks, vs in sdpa]) / n
            # this run's data: the live slots' keys and values are read
            # once, and each needs 4 Hq D operations (q.k and p.v)
            live = sum(min(x, T) if x >= 1 else T for x in valid)
            nbytes = 2 * (2 * live * Hk * D + 2 * b * Hq * D) + 4 * b
            b_ms, b_by = bound(nbytes, 4 * live * Hq * D, PEAK_BF16_FLOPS)
            print(f"kernels: decode_attention cold in a graph at B={b} "
                  f"T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid={valid} ({n} "
                  f"distinct ring pairs, {n * ring_bytes / 1e6:.1f} MB), ms "
                  f"a launch: kernel {k_ms:.4f} ({nbytes / k_ms / 1e6:.1f} "
                  f"GB/s), plain {p_ms:.4f}, F.scaled_dot_product_attention "
                  f"(mask, GQA) {l_ms:.4f}, bound {b_ms:.6f} ({b_by}); "
                  f"kernel / SDPA {k_ms / l_ms:.2f}, kernel / bound "
                  f"{k_ms / b_ms:.2f}; the decode step's 8 launches "
                  f"{8 * k_ms:.4f} ms")
            ctx.setdefault("decode_attention_cold", {})[f"B{b} {name}"] = \
                dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                     bound_by=b_by, valid=valid, rings=n)
        del sets, sdpa
    # warm and eager on one full ring (PR 14 and 16's condition: host
    # launch costs inside, rings from L2)
    q, k, v, vl = _attn_case(B, T, Hq, Hk, D, bf16, [T] * B, 113, dev)
    w_ms = median_ms(lambda: ops.decode_attention(q, k, v, vl), reps=50)
    qs, ks, vs = (q[:, :, None], k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())
    mask = (torch.arange(T, device=dev)[None, :] < vl[:, None])[
        :, None, None, :]
    wl_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), reps=50)
    print(f"kernels: decode_attention warm and eager at B={B} T={T} bf16 "
          f"valid=T (one ring, from L2): kernel {w_ms:.4f} ms, "
          f"F.scaled_dot_product_attention {wl_ms:.4f} ms")
    cold = ctx["decode_attention_cold"][f"B{B} full"]
    ctx["decode_attention"] = dict(
        max_abs_err=err_max, ms=cold["ms"],
        plain_ms=cold["plain_ms"], library_ms=cold["library_ms"],
        bound_ms=cold["bound_ms"], bound_by=cold["bound_by"], warm_ms=w_ms,
        condition=f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16, full ring; ms, "
                  "plain_ms and library_ms cold in a CUDA graph (distinct "
                  "rings, from HBM), warm_ms warm and eager")


REQUESTS = (30, 30, 17, 45, 8, 30)


def _serve(device, params, frames, family="lstm"):
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    eng = RecurrentServingEngine(BYSDNE, params, max_batch=4,
                                 rnn_family=family, device=device)
    for uid, fr in enumerate(frames):
        eng.submit(RecurrentRequest(uid=uid, frames=fr, max_new_frames=8))
    return eng, sorted(eng.run_to_completion(), key=lambda c: c.uid)


def _serve_and_check(ctx, label, family, params, seq_k, dec_k):
    """Serve the 6 BYSDNE requests on the card through ``family``'s
    kernels (``seq_k`` per admission slot, ``dec_k`` per tick), check the
    launches and statuses, hold the outputs against a device="cpu"
    engine, and time a warm rerun."""
    import numpy as np
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts

    rng = np.random.default_rng(0)
    frames = [(rng.standard_normal((t, BYSDNE.lstm_input)) * 0.5)
              .astype(np.float32) for t in REQUESTS]
    everything = entries()
    reset_counts(*everything)
    eng, done = _serve("cuda", params, frames, family)
    torch.cuda.synchronize()
    seq_n, dec_n = seq_k.kernel_launches, dec_k.kernel_launches
    others = sum(f.calls for f in everything if f not in (seq_k, dec_k))
    st = eng.compiled.stats
    print(f"{label}: {len(done)} requests, statuses "
          f"{[c.status for c in done]}, {eng.prefill_waves} waves "
          f"({eng.packed_launches} planned launches), {eng.decode_ticks} "
          f"ticks ({eng.decode_launches} planned launches); kernel "
          f"launches {seq_k.__name__} {seq_n}, {dec_k.__name__} {dec_n}; "
          f"degraded {st.degraded_launches}, fallback level "
          f"{st.fallback_level}")
    check(all(c.status == "ok" for c in done), "a request did not finish ok")
    check(eng.prefill_waves == 2, "expected two admission waves")
    check(seq_n + dec_n == eng.packed_launches + eng.decode_launches,
          "kernel launches != the plans' launches")
    check(seq_n == eng.packed_launches and dec_n == eng.decode_ticks
          and eng.decode_launches == eng.decode_ticks,
          f"a decode tick did not take exactly one {dec_k.__name__} launch")
    check((seq_k.calls, dec_k.calls) == (seq_n, dec_n) and others == 0,
          "an entry point ran without launching its kernel, or another "
          "family's kernel was called")
    check(st.degraded_launches == 0 and st.fallback_level == 0,
          "a launch degraded down the guarded ladder")
    tally(ctx, seq_k, dec_k)

    _, cpu_done = _serve("cpu", params, frames, family)
    err = max(max(float(np.abs(g.outputs - c.outputs).max()),
                  float(np.abs(g.generated - c.generated).max()))
              for g, c in zip(done, cpu_done))
    shapes_ok = all(g.outputs.shape == (t, BYSDNE.lstm_hidden)
                    and g.generated.shape == (8, BYSDNE.lstm_hidden)
                    and np.isfinite(g.outputs).all()
                    and np.isfinite(g.generated).all()
                    for g, t in zip(done, REQUESTS))
    print(f"{label}: outputs and generated frames vs the device=\"cpu\" "
          f"engine: max_abs_err {err:.3e} (tol {TOL_E2E:g}); shapes and "
          f"finiteness {'ok' if shapes_ok else 'WRONG'}")
    check(shapes_ok, "served outputs have the wrong shape or are not finite")
    check(err <= TOL_E2E, "served outputs disagree with the CPU path")

    t0 = time.perf_counter()
    eng2, _ = _serve("cuda", params, frames, family)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames_out = sum(t + 8 for t in REQUESTS)
    ctx[f"{label}_s"] = wall
    print(f"{label}: warm rerun {wall * 1e3:.1f} ms wall for "
          f"{len(REQUESTS)} requests ({frames_out} prompt + generated "
          f"frames, {eng2.packed_launches + eng2.decode_launches} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(
            lambda: _serve("cuda", params, frames, family), label)
        _profiled_launches(label, seq_k.__name__, by_name, count, seq_n)


def phase_serve(ctx):
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq
    from repro_torch.models.layers.lstm import init_lstm_stack

    params = init_lstm_stack(torch.Generator().manual_seed(0), BYSDNE,
                             torch.bfloat16)
    _serve_and_check(ctx, "serve", "lstm", params, lstm_seq, lstm_decode)


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
    reset_counts(*entries())
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
    tally(ctx, lstm_seq)

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
        by_name, count = profile_breakdown(lambda: cs.forward(xs), "forward")
        _profiled_launches("forward", "lstm_seq", by_name, count, p)


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


def phase_serve_gru(ctx):
    """The serve phase's 6 requests through BYSDNE as a GRU."""
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.core.gru import init_gru_stack
    from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq

    params = init_gru_stack(torch.Generator().manual_seed(0),
                            BYSDNE.lstm_input, BYSDNE.lstm_hidden,
                            BYSDNE.n_layers, torch.bfloat16)
    _serve_and_check(ctx, "serve_gru", "gru", params, gru_seq, gru_decode)


def _mixed_stack(H: int, seed: int):
    """lstm/gru/lstm/gru at width H, bf16 weights from a seeded
    torch.Generator."""
    import torch

    from repro_torch.core.gru import init_gru_layer
    from repro_torch.models.layers.lstm import init_lstm_layer

    gen = torch.Generator().manual_seed(seed)
    return {"layers": [init(gen, H, H, torch.bfloat16) for init in (
        init_lstm_layer, init_gru_layer, init_lstm_layer, init_gru_layer)]}


def phase_offpath(ctx):
    """Off the packed timeline: per_step (lstm_cell), a mixed stack, and a
    research schedule, each held against the CPU path."""
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_seq

    everything = entries()
    xs = (np.random.default_rng(2).standard_normal((4, 30, 340)) * 0.5
          ).astype(np.float32)

    # (1) BYSDNE under per_step: one lstm_cell launch per (layer, step)
    pol = rnn.ExecutionPolicy(schedule="per_step")
    cs = rnn.compile(BYSDNE, pol, device="cuda", seed=0)
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = lstm_cell.kernel_launches, cs.plan.launches
    others = sum(f.calls for f in everything if f is not lstm_cell)
    print(f"offpath: per_step BYSDNE B=4 T=30 -> {tuple(ys.shape)}; "
          f"lstm_cell kernel launches {n}, calls {lstm_cell.calls}, "
          f"plan.launches {p}; other kernels called {others} times")
    check(n == p == lstm_cell.calls == 150 and others == 0,
          "per_step launches != plan.launches == 150")
    check(tuple(ys.shape) == (4, 30, 340) and bool(torch.isfinite(ys).all()),
          "per_step output has the wrong shape or is not finite")
    tally(ctx, lstm_cell)
    ref = rnn.compile(BYSDNE, pol, device="cpu", seed=0).forward(xs)
    err = float((ys.cpu() - ref).abs().max())
    print(f"offpath: per_step vs the CPU path max_abs_err {err:.3e} (tol "
          f"{TOL_E2E:g})")
    check(err <= TOL_E2E, "per_step output disagrees with the CPU path")
    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["per_step_s"] = time.perf_counter() - t0
    print(f"offpath: per_step warm rerun {ctx['per_step_s'] * 1e3:.1f} ms "
          f"wall ({p} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs),
                                           "offpath per_step")
        _profiled_launches("offpath per_step", "lstm_cell", by_name, count,
                           p)

    # (2) a mixed lstm/gru/lstm/gru stack at H=340: forward, then one
    # decode tick resumed from its prefill state (L=4 per-layer launches)
    params = _mixed_stack(340, seed=3)
    cs = rnn.compile(params, device="cuda")
    cpu = rnn.compile(params, device="cpu")
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    fwd_n = (lstm_seq.kernel_launches, gru_seq.kernel_launches)
    check(sum(fwd_n) == cs.plan.launches
          and sum(f.calls for f in everything) == cs.plan.launches,
          "mixed forward launches != plan.launches")
    tally(ctx, lstm_seq, gru_seq)
    err = float((ys.cpu() - cpu.forward(xs)).abs().max())
    (ys, st), (cys, cst) = cs.prefill(xs), cpu.prefill(xs)
    reset_counts(*everything)
    y, st = cs.decode(ys[:, -1:], st)
    torch.cuda.synchronize()
    dec_n = (lstm_seq.kernel_launches, gru_seq.kernel_launches)
    tally(ctx, lstm_seq, gru_seq)
    cy, cst = cpu.decode(cys[:, -1:], cst)
    dec_err = max(float((y.cpu() - cy).abs().max()),
                  max(float((st[k].cpu() - cst[k]).abs().max())
                      for k in ("h", "c")))
    print(f"offpath: mixed lstm/gru/lstm/gru H=340 forward B=4 T=30: "
          f"lstm_seq {fwd_n[0]} + gru_seq {fwd_n[1]} launches == "
          f"plan.launches {cs.plan.launches}, vs CPU max_abs_err {err:.3e}; "
          f"decode tick: lstm_seq {dec_n[0]} + gru_seq {dec_n[1]} launches "
          f"(plan {cs.last_decode_plan.launches}), vs CPU max_abs_err "
          f"{dec_err:.3e} (tol {TOL_E2E:g})")
    check(err <= TOL_E2E and dec_err <= TOL_E2E,
          "the mixed stack disagrees with the CPU path")
    check(sum(dec_n) == cs.last_decode_plan.launches == 4,
          "the mixed decode tick did not take its 4 per-layer launches")

    # (3) a research schedule: plain PyTorch on the card, zero launches
    pol = rnn.ExecutionPolicy(schedule="unfolded")
    cs = rnn.compile(BYSDNE, pol, device="cuda", seed=0)
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    calls = sum(f.calls for f in everything)
    err = float((ys.cpu() - rnn.compile(BYSDNE, pol, device="cpu", seed=0)
                 .forward(xs)).abs().max())
    print(f"offpath: unfolded BYSDNE B=4 T=30: {calls} kernel calls "
          f"(plan.launches {cs.plan.launches}), vs CPU max_abs_err "
          f"{err:.3e} (tol {TOL_E2E:g})")
    check(calls == 0 == cs.plan.launches,
          "the unfolded research schedule launched a kernel")
    check(err <= TOL_E2E, "unfolded output disagrees with the CPU path")


def _stack(family: str, seed: int):
    """BYSDNE (L=5, H=X=340) as ``family``, bf16 weights from a seeded
    torch.Generator, with layer l's U zeroed on every 8-row tile t with
    t % (l + 2) == 0 (H=340 has 43 tiles, the last one 4 rows)."""
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.core.gru import init_gru_stack
    from repro_torch.models.layers.lstm import init_lstm_stack

    gen = torch.Generator().manual_seed(seed)
    if family == "lstm":
        params = init_lstm_stack(gen, BYSDNE, torch.bfloat16)
    else:
        params = init_gru_stack(gen, BYSDNE.lstm_input, BYSDNE.lstm_hidden,
                                BYSDNE.n_layers, torch.bfloat16)
    H = BYSDNE.lstm_hidden
    for l, layer in enumerate(params["layers"]):
        for t in range(0, -(-H // 8), l + 2):
            layer["U"][t * 8:(t + 1) * 8] = 0
    return params


def phase_rglru(ctx):
    """RecurrentGemma-2B's RG-LRU layer at full width through the
    dispatcher: one rglru_scan launch per L=1 item."""
    import numpy as np
    import torch

    from repro_torch import dispatch, rnn
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.models.layers.lstm import init_lstm_stack
    from repro_torch.models.layers.rglru import gate_inputs, init_rglru

    dev = rnn.resolve_device("cuda")  # also keeps the gate GEMMs out of TF32
    everything = entries()
    cfg = recurrentgemma_2b.config()
    W, B, T = cfg.rglru_width, 4, cfg.window
    params = init_rglru(torch.Generator().manual_seed(0), W, cfg.dtype)
    x = (np.random.default_rng(4).standard_normal((B, T, W)) * 0.5
         ).astype(np.float32)
    with torch.no_grad():
        la, gx = gate_inputs({k: v.to(dev) for k, v in params.items()},
                             torch.from_numpy(x).to(dev))
        cla, cgx = gate_inputs(params, torch.from_numpy(x))
    item = dispatch.WorkItem(uid=0, family="rglru", B=B, T=T, H=W, X=W, L=1)
    p = dispatch.plan([item])
    reset_counts(*everything)
    hs = dispatch.execute(p, {}, {0: (la, gx)})[0]
    torch.cuda.synchronize()
    n = rglru_scan.kernel_launches
    others = sum(f.calls for f in everything if f is not rglru_scan)
    print(f"rglru: {cfg.name} RG-LRU layer W={W} B={B} T={T} -> "
          f"{tuple(hs.shape)}; rglru_scan kernel launches {n}, calls "
          f"{rglru_scan.calls}, plan.launches {p.launches}; other kernels "
          f"called {others} times")
    check(n == rglru_scan.calls == p.launches == 1 and others == 0,
          "the rglru item did not take exactly one rglru_scan launch")
    tally(ctx, rglru_scan)
    check(tuple(hs.shape) == (B, T, W) and bool(torch.isfinite(hs).all()),
          "rglru output has the wrong shape or is not finite")
    ref = dispatch.execute(p, {}, {0: (cla, cgx)})[0]
    err = float((hs.cpu() - ref).abs().max())
    print(f"rglru: vs the device=\"cpu\" path (gate GEMMs and scan) "
          f"max_abs_err {err:.3e} (tol {TOL_E2E:g})")
    check(err <= TOL_E2E, "rglru output disagrees with the CPU path")

    full = dispatch.WorkItem.from_config(cfg, T, B=B)
    try:
        dispatch.execute(dispatch.plan([full]), {}, {})
        refused = False
    except NotImplementedError:
        refused = True
    print(f"rglru: the whole model's item (L={full.L}) is plan-only: "
          f"execute refuses it {refused}")
    check(full.L == 18 and refused, "the L=18 rglru item was not refused")

    # one BYSDNE LSTM item and the rglru item in one plan and one execute
    lstm = init_lstm_stack(torch.Generator().manual_seed(0), BYSDNE,
                           torch.bfloat16)
    xl = (np.random.default_rng(5).standard_normal((B, 30, 340)) * 0.5
          ).astype(np.float32)
    mixed = dispatch.plan([
        dispatch.WorkItem(uid=0, family="lstm", B=B, T=30, H=340, X=340,
                          L=5),
        dispatch.WorkItem(uid=1, family="rglru", B=B, T=T, H=W, X=W, L=1)])
    dparams = {0: {"layers": [{k: v.to(dev) for k, v in layer.items()}
                              for layer in lstm["layers"]]}}
    reset_counts(*everything)
    outs = dispatch.execute(mixed, dparams,
                            {0: torch.from_numpy(xl).to(dev), 1: (la, gx)})
    torch.cuda.synchronize()
    ns = (lstm_seq.kernel_launches, rglru_scan.kernel_launches)
    calls = sum(f.calls for f in everything)
    tally(ctx, lstm_seq, rglru_scan)
    cpu = dispatch.execute(mixed, {0: lstm},
                           {0: torch.from_numpy(xl), 1: (cla, cgx)})
    err = max(float((outs[k].cpu() - cpu[k]).abs().max()) for k in (0, 1))
    same = bool(torch.equal(outs[1], hs))
    print(f"rglru: mixed plan (BYSDNE lstm item + rglru item): lstm_seq "
          f"{ns[0]} + rglru_scan {ns[1]} launches == plan.launches "
          f"{mixed.launches}; rglru output equal to the lone item's {same}; "
          f"vs CPU max_abs_err {err:.3e} (tol {TOL_E2E:g})")
    check(sum(ns) == calls == mixed.launches and ns[1] == 1,
          "mixed plan launches != plan.launches")
    check(same and err <= TOL_E2E, "the mixed plan disagrees")

    t0 = time.perf_counter()
    dispatch.execute(p, {}, {0: (la, gx)})
    torch.cuda.synchronize()
    ctx["rglru_s"] = time.perf_counter() - t0
    print(f"rglru: warm rerun {ctx['rglru_s'] * 1e3:.2f} ms wall "
          f"(1 launch)")
    if ctx["profile"]:
        profile_breakdown(lambda: dispatch.execute(p, {}, {0: (la, gx)}),
                          "rglru")


def _precision_run(ctx, label, cs, cpu, xs, seq_k, variant):
    """forward on the card and on the CPU: launches == plan.launches, all
    of them ``seq_k`` launches in ``variant``, output within TOL_E2E."""
    import torch

    from repro_torch.kernels.common import reset_counts

    everything = entries()
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = seq_k.kernel_launches, cs.plan.launches
    calls = sum(f.calls for f in everything)
    branches = dict(seq_k.variant_launches)
    tally(ctx, seq_k)
    err = float((ys.cpu() - cpu.forward(xs)).abs().max())
    print(f"precision: {label} forward B=4 T=30: {seq_k.__name__} "
          f"launches {n} {branches}, plan.launches {p}; vs CPU max_abs_err "
          f"{err:.3e} (tol {TOL_E2E:g})")
    check(n == p == calls and branches == {variant: n},
          f"{label}: forward launches != plan.launches in {variant}")
    check(bool(torch.isfinite(ys).all()) and err <= TOL_E2E,
          f"{label}: forward disagrees with the CPU path")


def phase_precision(ctx):
    """BYSDNE under int8 + block sparsity (forward, prefill, decode), int8
    alone and bf16 + block sparsity, as an LSTM and as a GRU."""
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    everything = entries()
    xs = (np.random.default_rng(6).standard_normal((4, 30, 340)) * 0.5
          ).astype(np.float32)
    kernels = {"lstm": (lstm_seq, lstm_decode), "gru": (gru_seq, gru_decode)}
    for family, (seq_k, dec_k) in kernels.items():
        params = _stack(family, seed=7)
        pol = rnn.ExecutionPolicy(precision="int8", sparsity="block")
        cs = rnn.compile(params, pol, device="cuda")
        cpu = rnn.compile(params, pol, device="cpu")
        label = f"{family} int8+block"
        _precision_run(ctx, label, cs, cpu, xs, seq_k, "int8+compact")

        reset_counts(*everything)
        ys, st = cs.prefill(xs)
        torch.cuda.synchronize()
        n, p = seq_k.kernel_launches, cs.plan.launches
        ok = (n == p == sum(f.calls for f in everything)
              and seq_k.variant_launches == {"int8+compact": n})
        tally(ctx, seq_k)
        cys, cst = cpu.prefill(xs)
        err = max([float((ys.cpu() - cys).abs().max())]
                  + [float((st[k].cpu() - cst[k]).abs().max()) for k in st])
        print(f"precision: {label} prefill: {seq_k.__name__} launches {n}, "
              f"plan.launches {p}; outputs and state vs CPU max_abs_err "
              f"{err:.3e} (tol {TOL_E2E:g})")
        check(ok, f"{label}: prefill launches != plan.launches")
        check(err <= TOL_E2E, f"{label}: prefill disagrees with the CPU path")

        y, cy = ys[:, -1:], cys[:, -1:]
        ticks, launched = 4, 0
        for _ in range(ticks):
            reset_counts(*everything)
            y, st = cs.decode(y, st)
            torch.cuda.synchronize()
            launched += dec_k.kernel_launches
            check(dec_k.kernel_launches == cs.last_decode_plan.launches == 1
                  and sum(f.calls for f in everything) == 1,
                  f"{label}: a decode tick did not take one "
                  f"{dec_k.__name__} launch")
            tally(ctx, dec_k)
            cy, cst = cpu.decode(cy, cst)
        err = max([float((y.cpu() - cy).abs().max())]
                  + [float((st[k].cpu() - cst[k]).abs().max()) for k in st])
        print(f"precision: {label} {ticks} decode ticks resumed from the "
              f"prefill state: {dec_k.__name__} launches {launched} (1 per "
              f"tick, the dense kernel on the fake-quantized U); last frame "
              f"and state vs CPU max_abs_err {err:.3e} (tol {TOL_E2E:g})")
        check(bool(torch.isfinite(y).all()) and err <= TOL_E2E,
              f"{label}: decode disagrees with the CPU path")

        for prec, sparsity, variant in (("int8", "none", "int8"),
                                        ("bf16", "block", "compact")):
            pol = rnn.ExecutionPolicy(precision=prec, sparsity=sparsity)
            _precision_run(ctx, f"{family} {prec}+{sparsity}",
                           rnn.compile(params, pol, device="cuda"),
                           rnn.compile(params, pol, device="cpu"), xs,
                           seq_k, variant)

    cs = rnn.compile(_stack("lstm", seed=7), rnn.ExecutionPolicy(
        precision="int8", sparsity="block"), device="cuda")
    cs.forward(xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["precision_s"] = time.perf_counter() - t0
    print(f"precision: lstm int8+block forward warm rerun "
          f"{ctx['precision_s'] * 1e3:.1f} ms wall ({cs.plan.launches} "
          f"launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs),
                                           "precision")
        _profiled_launches("precision", "lstm_seq", by_name, count,
                           cs.plan.launches)
        # a decode tick resumed from the prefill state: the dense decode
        # kernel on the fake-quantized U (fp32 U under bf16 W)
        ys, st = cs.prefill(xs)
        profile_breakdown(lambda: cs.decode(ys[:, -1:], st),
                          "precision decode tick")


#: serve_lm's prompt lengths: prefill buckets 4, 32, 256, 1024 (naive
#: attention), 2048 (blockwise) and 64, with 1 + 5 + 44 + 76 + 52 + 0
#: remainder tokens through batch-1 decode steps; the 2100-token prompt's
#: remainder and generation wrap its 2048-slot rings
LM_PROMPTS = (5, 37, 300, 1100, 2100, 64)
LM_NEW = 16


def _lm_prompts(vocab, lengths, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _keep_sampled_logits(eng):
    """Wrap ``eng``'s sampler: every logits row it samples a token from is
    kept, by request uid, in the order of that request's tokens."""
    kept, admitting = {}, []
    sample, admit = eng._sample, eng._prefill_admitted

    def prefill_admitted(pairs):
        for slot, req in pairs:
            admitting[:] = [req.uid]
            admit([(slot, req)])
        admitting.clear()

    def sample_and_keep(logits):
        uids = admitting or [None if r is None else r.uid for r in eng.slots]
        for uid, row in zip(uids, logits):
            if uid is not None:
                kept.setdefault(uid, []).append(row.clone())
        return sample(logits)

    eng._prefill_admitted, eng._sample = prefill_admitted, sample_and_keep
    return kept


def _lm_serve(cfg, params, prompts, max_new, device, max_batch=4,
              max_seq=4096, hook=None):
    """Serve ``prompts`` through a fresh ServingEngine; ``hook(kind, n,
    fn, graph=None, tokens=None)`` may wrap its decode steps (n = B; the
    step's DecodeGraph and tokens given) and prefills (n = tokens).
    Returns (engine, completions by uid, the sampled logits (tokens,
    vocab) by uid)."""
    import torch

    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                        device=device)
    kept = _keep_sampled_logits(eng)
    if hook is not None:
        dec, pre = eng._decode, eng._prefill
        eng._decode = lambda g, t: hook("decode", t.shape[0],
                                        lambda: dec(g, t), g, t)
        eng._prefill = lambda p, t: hook("prefill", t.shape[1],
                                         lambda: pre(p, t))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=max_new))
    done = {c.uid: c for c in eng.run_to_completion()}
    return eng, done, {uid: torch.stack(rows) for uid, rows in kept.items()}


def _teacher_forced(cfg, params, prompt, completion):
    """The logits a full-sequence forward on the card gives at the
    positions the engine sampled from (prompt + generated tokens but the
    last).  Causal: tokens appended after them change nothing, so a length
    in (1024, 2048], where the blockwise path needs whole chunks, is padded
    to 2048 (local attention pads itself above the window)."""
    import torch

    from repro_torch.models import transformer as tf

    seq = list(prompt) + completion.tokens[:-1]
    S, L = len(seq), len(prompt)
    if tf.NAIVE_ATTN_MAX_SEQ < S < cfg.window:
        seq = seq + [0] * (cfg.window - S)
    tokens = torch.tensor(seq, dtype=torch.long, device="cuda")[None]
    with torch.inference_mode():
        logits, _, _ = tf.forward(cfg, params, tokens=tokens)
    out = logits[0, L - 1:L - 1 + len(completion.tokens)].clone()
    del logits
    return out


def _margin(logits):
    """Top-1 minus top-2 logit of each row."""
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def phase_serve_lm(ctx):
    """RecurrentGemma-2B at full width through serving.ServingEngine: the
    decode steps on mvm + decode_attention, the prefills on rglru_scan."""
    import statistics as stats

    import torch

    from repro_torch import rnn
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine

    dev = rnn.resolve_device("cuda")
    # fp32 products in full fp32: the unembed's logits and the plain
    # versions (resolve_device sets the matmul flag; cuDNN's is stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = recurrentgemma_2b.config()
    kinds = cfg.layer_kinds()
    n_attn, n_rglru = kinds.count("attn"), kinds.count("rglru")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    ctx["serve_lm_init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve_lm: {cfg.name} L={cfg.n_layers} ({n_rglru} rglru, "
          f"{n_attn} attn) d_model={cfg.d_model} vocab={cfg.vocab_size} "
          f"{cfg.dtype}: {n_params:,} parameters drawn on the card in "
          f"{ctx['serve_lm_init_s']:.2f} s")

    prompts = _lm_prompts(cfg.vocab_size, LM_PROMPTS, seed=8)
    everything = entries()
    lm = (mvm, decode_attention, rglru_scan)
    calls = []  # (kind, rows or tokens, launches of mvm / dattn / scan)
    wrapped = []  # the first batched tick with a wrapped ring, before it

    def count_call(kind, n, fn, graph=None, tokens=None):
        if (kind == "decode" and n == 4 and not wrapped
                and int(graph.cache["idx"].max()) >= cfg.window):
            wrapped.append((graph, _clone_cache(graph.cache),
                            tokens.clone()))
        before = [f.kernel_launches for f in lm]
        out = fn()
        calls.append((kind, n, tuple(f.kernel_launches - b
                                     for f, b in zip(lm, before))))
        return out

    reset_counts(*everything)
    t0 = time.perf_counter()
    eng, done, logits = _lm_serve(cfg, params, prompts, LM_NEW, "cuda",
                                  hook=count_call)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ticks = [c for c in calls if c[0] == "decode" and c[1] == 4]
    rem = [c for c in calls if c[0] == "decode" and c[1] == 1]
    pre = [c for c in calls if c[0] == "prefill"]
    others = sum(f.calls for f in everything if f not in lm)
    print(f"serve_lm: {len(done)} requests in {first_s:.2f} s (first run); "
          f"{len(pre)} prefills (buckets {sorted(eng.prefill_lengths)}), "
          f"{len(rem)} batch-1 remainder decode steps, {len(ticks)} batched "
          f"ticks; kernel launches mvm {mvm.kernel_launches}, "
          f"decode_attention {decode_attention.kernel_launches}, rglru_scan "
          f"{rglru_scan.kernel_launches}; other kernels called {others} "
          f"times")
    check(sorted(done) == list(range(len(prompts)))
          and all(len(c.tokens) == LM_NEW for c in done.values()),
          "serve_lm: a request did not complete with all its tokens")
    check(all(c[2] == (6 * cfg.n_layers, n_attn, 0)
              for c in ticks + rem),
          f"serve_lm: a decode step did not launch {6 * cfg.n_layers} mvm "
          f"and {n_attn} decode_attention kernels (and no scan): "
          f"{sorted(set(c[2] for c in ticks + rem))}")
    check(all(c[2] == (0, 0, n_rglru) for c in pre),
          f"serve_lm: a prefill did not launch exactly {n_rglru} rglru_scan "
          f"kernels: {sorted(set(c[2] for c in pre))}")
    check(all(f.calls == f.kernel_launches for f in lm) and others == 0,
          "serve_lm: an entry point ran its plain version on the card, or "
          "another family's kernel was called")
    check(len(pre) == len(prompts) and len(rem) == sum(
        n - (1 << (n.bit_length() - 1)) for n in LM_PROMPTS),
        "serve_lm: prefill buckets or remainder steps differ from the "
        "engine's rule")
    replays = (eng.tick_graph.replays, eng.single_graph.replays)
    print(f"serve_lm: graph replays {replays[0]} of {len(ticks)} batched "
          f"ticks and {replays[1]} of {len(rem)} batch-1 steps (the first "
          f"step at each batch size eager, then captured); launches a "
          f"replay adds: "
          + "; ".join(f"{name} " + ", ".join(
              f"{fn.__name__} {launches}"
              for fn, (_, launches) in graph.captured.items())
              for name, graph in (("tick", eng.tick_graph),
                                  ("batch-1", eng.single_graph))))
    check(replays == (len(ticks) - 1, len(rem) - 1),
          "serve_lm: a decode step after the first at its batch size was "
          "not a graph replay")
    tally(ctx, *lm)
    check(len(wrapped) == 1, "serve_lm: no batched tick ran on a wrapped "
                             "ring")
    ctx["serve_lm_engine_rings_share"] = _attn_on_engine_rings(
        cfg, *wrapped[0])
    del wrapped[:]

    # every generated token's logits against a teacher-forced forward on
    # the card (torch.matmul, the prefill attention paths, rglru_scan)
    err, flips, held = 0.0, 0, 0
    for uid, c in sorted(done.items()):
        ref = _teacher_forced(cfg, params, prompts[uid], c)
        e = float((logits[uid] - ref).abs().max())
        margin = _margin(ref)
        sure = margin > TOL_LM
        agree = ref.argmax(-1).cpu() == torch.tensor(c.tokens)
        held += int(sure.sum())
        flips += int((~agree).sum())
        print(f"serve_lm: request {uid} (prompt {len(prompts[uid])}): "
              f"logits vs the teacher-forced forward max_abs_err {e:.3e} "
              f"(tol {TOL_LM:g}; |logit| <= "
              f"{float(ref.abs().max()):.2f}); greedy tokens == argmax at "
              f"{int(agree.sum())}/{len(agree)} positions, smallest top-2 "
              f"margin {float(margin.min()):.3e}")
        check(bool(torch.isfinite(logits[uid]).all()),
              f"serve_lm: request {uid} has non-finite logits")
        check(e <= TOL_LM, f"serve_lm: request {uid}'s logits disagree with "
                           f"the forward: {e:.3e} > {TOL_LM:g}")
        check(bool(agree[sure.cpu()].all()),
              f"serve_lm: request {uid}: a greedy token differs from the "
              f"forward's argmax where the top-2 margin exceeds {TOL_LM:g}")
        err = max(err, e)
        del ref
    ctx["serve_lm_err"] = err
    print(f"serve_lm: tokens held at {held} positions with a top-2 margin "
          f"above {TOL_LM:g}; {flips} near-tie positions differ")
    # each attention layer of the decode step against the forward (F3)
    layer_share = 0.0
    for uid, c in sorted(done.items()):
        shares = _attn_layers_vs_forward(cfg, params, prompts[uid], c)
        layer_share = max(layer_share, max(shares))
        print(f"serve_lm: request {uid}: each attention layer's output at "
              f"the decoded positions vs the teacher-forced forward on the "
              f"same input, worst position over its limit (TOL_LAYER "
              f"{TOL_LAYER:g} of its largest |output|) by layer: "
              + ", ".join(f"{x:.3f}" for x in shares))
        check(max(shares) <= 1.0, f"serve_lm: request {uid}: an attention "
              f"layer of the decode step disagrees with the forward: "
              f"{max(shares):.3f} of TOL_LAYER")
    ctx["serve_lm_layer_share"] = layer_share

    _planted_faults(cfg, params, prompts)
    _depth3_vs_cpu(cfg, params)

    # a warm run, each decode step and prefill timed on the host clock
    # around a synchronize, and on the device by CUDA events around the
    # step (the token copy and the replay); the first replay at each batch
    # size is held against the step run eagerly (_replay_vs_eager), outside
    # its time
    times, checked = [], {}

    def timed(kind, n, fn, graph=None, tokens=None):
        replay = graph is not None and graph.graph is not None
        before = None
        if replay and graph not in checked:
            before = (_clone_cache(graph.cache),
                      tokens.to(dev, copy=True))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append((kind, n, (time.perf_counter() - t) * 1e3,
                      start.elapsed_time(end), replay))
        if before is not None:
            checked[graph] = _replay_vs_eager(graph, *before, n)
        return out

    t0 = time.perf_counter()
    warm, _, _ = _lm_serve(cfg, params, prompts, LM_NEW, "cuda", hook=timed)
    torch.cuda.synchronize()
    ctx["serve_lm_s"] = time.perf_counter() - t0
    check(len(checked) == 2, "serve_lm: the warm run did not replay both "
                             "decode graphs")
    ctx["serve_lm_replay_err"] = max(checked.values())
    pre_ms = {n: t for k, n, t, _, _ in times if k == "prefill"}
    ctx["serve_lm_prefill_ms"] = pre_ms
    for B, label, key, graph in (
            (4, "batched tick (B=4)", "tick", warm.tick_graph),
            (1, "batch-1 decode step", "step1", warm.single_graph)):
        busy_ms, kernel_ms = _profiled_replay(graph, B, lm,
                                              (6 * cfg.n_layers, n_attn, 0))
        ctx[f"serve_lm_{key}_kernel_ms"] = dict(
            zip((fn.__name__ for fn in lm), kernel_ms))
        steps = [(w, d, r) for k, n, w, d, r in times
                 if k == "decode" and n == B]
        wall = [w for w, _, r in steps if r]
        dev_ms = [d for _, d, r in steps if r]
        host = 1 - sum(dev_ms) / sum(wall)
        busy = busy_ms / stats.median(dev_ms)
        ctx[f"serve_lm_{key}_ms"] = stats.median(wall)
        ctx[f"serve_lm_{key}_device_ms"] = stats.median(dev_ms)
        ctx[f"serve_lm_{key}_host_share"] = host
        ctx[f"serve_lm_{key}_busy"] = busy
        first = [w for w, _, r in steps if not r]
        print(f"serve_lm: warm run, {label}: {len(wall)} replays, host wall "
              f"median {stats.median(wall):.3f} ms (min {min(wall):.3f}, "
              f"max {max(wall):.3f}), device span (CUDA events around the "
              f"step) median {stats.median(dev_ms):.3f} ms; host-overhead "
              f"share 1 - device span/wall = {100 * host:.1f}% (it cannot "
              f"see the device's gaps inside the span); device busy "
              f"{busy_ms:.3f} ms (one replay under the profiler) = "
              f"{100 * busy:.1f}% of the median span; the first step, "
              f"eager with the capture: "
              f"{first[0]:.1f} ms")
    gen = len(prompts) * LM_NEW
    print(f"serve_lm: warm run {ctx['serve_lm_s']:.3f} s wall for "
          f"{len(prompts)} requests ({sum(LM_PROMPTS)} prompt + {gen} "
          f"generated tokens); prefill ms by bucket "
          + ", ".join(f"{n}: {t:.1f}" for n, t in sorted(pre_ms.items())))
    if ctx["profile"]:
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=4096,
                            device="cuda")
        for uid, p in enumerate(_lm_prompts(cfg.vocab_size, (64,) * 4, 9)):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=64))
        eng.step()  # admission: four prefills, then the first tick
        torch.cuda.synchronize()
        profile_breakdown(lambda: [eng.step() for _ in range(8)],
                          "serve_lm 8 batched ticks")
        with torch.inference_mode():
            for n in (64, 2048):
                tokens = torch.as_tensor(
                    _lm_prompts(cfg.vocab_size, (n,), 11)[0],
                    dtype=torch.long, device="cuda")[None]
                prof = profile_breakdown(
                    lambda: eng._prefill(eng.params, tokens),
                    f"serve_lm prefill of {n} tokens")
                ms, k = device_share(*prof, "rglru_scan")
                print(f"serve_lm prefill of {n} tokens: rglru_scan {ms:.3f} "
                      f"ms of device time in {k} launches")
                check(k == n_rglru, f"serve_lm: the profiled prefill of {n} "
                      f"tokens ran {k} rglru_scan kernels, not {n_rglru}")
        del eng
    del params
    torch.cuda.empty_cache()


#: a kernel's name on the device, as the profiler reports it: every part
#: appears in it (the decode and sequence kernels share their cells)
DEVICE_NAMES = {"mvm": ("mvm_kernel",), "decode_attention": ("attn_kernel",),
                "rglru_scan": ("rglru_scan_kernel",),
                "lstm_cell": ("lstm_cell_kernel",),
                "lstm_decode": ("cluster_kernel", "LstmCell"),
                "gru_decode": ("cluster_kernel", "GruCell"),
                "lstm_seq": ("seq_kernel", "LstmCell"),
                "gru_seq": ("seq_kernel", "GruCell")}


def is_kernel(kernel: str, name: str) -> bool:
    """Whether the device kernel ``name`` is the port's ``kernel``."""
    return all(part in name for part in DEVICE_NAMES[kernel])


def _profiled_replay(graph, B, lm, per_step):
    """One more replay of ``graph`` (the engine has drained, so its state
    is no longer read) under torch.profiler.  A replay's launch counts are
    bookkeeping (``DecodeGraph.replay`` adds what the capture counted), so
    here the device's own events are counted by kernel name and must equal
    the counts the replay added, the capture's record and ``per_step``
    (mvm, decode_attention, rglru_scan).  Returns the device's busy time
    in ms, the sum of its events (the profiler stretches the replay's
    span, CUDA events around it, so that is printed but not used), and
    each of those kernels' device ms in the replay."""
    import torch

    from repro_torch.kernels.common import reset_counts

    reset_counts(*lm)
    tokens = graph.tokens.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay():
        with torch.inference_mode():
            start.record()
            graph(tokens)
            end.record()

    torch.cuda.synchronize()
    _, by_name, count = device_events(replay)
    span_us = start.elapsed_time(end) * 1e3
    on_device = tuple(
        sum(n for name, n in count.items()
            if is_kernel(fn.__name__, name)) for fn in lm)
    booked = tuple(fn.kernel_launches for fn in lm)
    captured = tuple(graph.captured.get(fn, (0, 0))[1] for fn in lm)
    busy = sum(by_name.values()) / 1e3
    kernel_ms = tuple(
        sum(us for name, us in by_name.items()
            if is_kernel(fn.__name__, name)) / 1e3 for fn in lm)
    print(f"serve_lm: one replay at B={B} under the profiler: device events "
          f"{sum(count.values())}, by kernel (mvm, decode_attention, "
          f"rglru_scan) on the device {on_device}, counted by the replay "
          f"{booked}, recorded at capture {captured}; their device ms "
          + ", ".join(f"{x:.4f}" for x in kernel_ms)
          + f"; device busy {busy:.3f} ms in a span of "
          f"{span_us / 1e3:.3f} ms under the profiler")
    check(on_device == booked == captured == tuple(per_step),
          f"serve_lm: a replay at B={B} ran {on_device} kernels on the "
          f"device but counted {booked} (captured {captured}, expected "
          f"{tuple(per_step)})")
    return busy, kernel_ms


def _clone_cache(cache):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in cache["layers"]],
            "idx": cache["idx"].clone()}


def _replay_vs_eager(graph, cache, tokens, B):
    """The replay that just ran, against the same step run eagerly
    (``DecodeGraph.eager``) on ``cache``, a clone of the static cache as it
    was before the replay, with the same tokens.  Both run the same
    kernels on the same inputs, and cuBLAS is asked for the same products
    in and out of a capture, so the logits must be bit-equal
    (TOL_REPLAY).  Returns the max |difference|; its launches count
    nowhere (the warm run's counts are not read)."""
    import torch

    replayed = graph.logits.clone()
    eager = graph.eager(cache=cache, tokens=tokens)
    torch.cuda.synchronize()
    err = float((replayed - eager).abs().max())
    equal = bool(torch.equal(replayed, eager))
    print(f"serve_lm: the first replayed decode step at B={B} against the "
          f"step run eagerly on a clone of its cache: logits max_abs_err "
          f"{err:.3e}, bit-equal {equal} (tol {TOL_REPLAY:g})")
    check(err <= TOL_REPLAY, f"serve_lm: the graph replay at B={B} "
                             f"disagrees with the eager step: {err:.3e}")
    return err


def _planted_faults(cfg, params, prompts):
    """The logit check above must see a wrong kernel: two requests (37 and
    64 prompt tokens, 8 new) are served once with each of two planted
    faults and held against the teacher-forced forward, which runs
    neither kernel.  The faults, planted at the entry points the model
    calls: mvm drops the last 64 of the X rows of every decode
    projection (a lost k-tile), and decode_attention drops the newest
    live slot (valid - 1, the token's own key).  Each must give logits
    beyond TOL_LM, or a greedy token that differs from the forward's
    argmax where its top-2 margin exceeds TOL_LM, and an attention layer
    beyond TOL_LAYER in the per-layer check (_attn_layers_vs_forward, the
    fault still planted), whose margin is printed beside the logits'.
    Launches here are outside the counted run."""
    import types

    import torch

    from repro_torch.models.layers import attention, common

    mvm, dattn = common.mvm, attention.decode_kernel.decode_attention
    faults = {
        "mvm drops the last 64 X rows": (
            common, "mvm",
            lambda x, W: mvm(x[:, :-64].contiguous(), W[:-64])),
        "decode_attention drops the newest slot": (
            attention, "decode_kernel", types.SimpleNamespace(
                decode_attention=lambda q, k, v, valid: dattn(
                    q, k, v, torch.clamp(valid - 1, min=1)))),
    }
    chosen = [prompts[LM_PROMPTS.index(n)] for n in (37, 64)]
    for name, (module, attr, planted) in faults.items():
        orig = getattr(module, attr)
        setattr(module, attr, planted)
        try:
            _, done, logits = _lm_serve(cfg, params, chosen, 8, "cuda")
            layers = max(max(_attn_layers_vs_forward(cfg, params, chosen[u],
                                                     c))
                         for u, c in done.items())
        finally:
            setattr(module, attr, orig)
        err, wrong = 0.0, 0
        for uid, c in sorted(done.items()):
            ref = _teacher_forced(cfg, params, chosen[uid], c)
            err = max(err, float((logits[uid] - ref).abs().max()))
            sure = (_margin(ref) > TOL_LM).cpu()
            agree = ref.argmax(-1).cpu() == torch.tensor(c.tokens)
            wrong += int((sure & ~agree).sum())
        print(f"serve_lm: planted fault, {name}: logits vs the forward "
              f"max_abs_err {err:.3e} (tol {TOL_LM:g}, margin "
              f"{err / TOL_LM:.2f}x); {wrong} tokens differ where the top-2 "
              f"margin exceeds {TOL_LM:g}; the per-layer check's worst "
              f"attention layer at {layers:.2f}x its limit (TOL_LAYER "
              f"{TOL_LAYER:g})")
        check(err > TOL_LM or wrong > 0, f"serve_lm: the logit check "
              f"does not see the planted fault ({name})")
        check(layers > 1.0, f"serve_lm: the per-layer check does not see "
              f"the planted fault ({name})")


def _attn_on_engine_rings(cfg, graph, cache, tokens):
    """The kernel on the rings serving really produces: one batched tick
    run eagerly on ``cache``, a clone of the engine's cache taken before
    the first tick with a wrapped ring, records each attention layer's
    (q, rings, valid) as ``models.layers.attention.decode_attention``
    receives them; the kernel on each is held against
    decode_attention_plain under the per-(row, head) bf16 limit.  Returns
    the worst share of the limit."""
    import torch

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models.layers import attention

    seen = []
    orig = attention.decode_attention

    def record(q, k, v, valid, *, window=0):
        seen.append(tuple(t.clone() for t in (q, k, v, valid)))
        return orig(q, k, v, valid, window=window)

    attention.decode_attention = record
    try:
        with torch.inference_mode():
            graph.eager(cache=cache, tokens=tokens.to(cache["idx"].device))
    finally:
        attention.decode_attention = orig
    check(len(seen) == cfg.layer_kinds().count("attn"),
          f"serve_lm: the tick ran {len(seen)} attention layers")
    worst = 0.0
    with torch.inference_mode():
        for q, k, v, valid in seen:
            out = ops.decode_attention(q, k, v, valid)
            ref = ops.decode_attention_plain(
                q[:, 0], k, v, valid,
                block_t=ops.default_block_t(k.shape[1]))
            torch.cuda.synchronize()
            worst = max(worst, _attn_share(out[:, 0], ref))
    counts, T = seen[0][3].tolist(), seen[0][1].shape[1]
    print(f"serve_lm: decode_attention on the engine's own rings (a clone "
          f"of its cache before the first batched tick with a wrapped "
          f"ring, idx {cache['idx'].tolist()}, valid {counts}), "
          f"{len(seen)} attention layers: worst head at {worst:.3f} of its "
          f"limit (ULP_BF16 of the head's largest output)")
    check(len(set(counts)) > 1 and max(counts) == T,
          "serve_lm: the engine's rings are not a wrapped ring among rows "
          "of mixed valid")
    check(worst <= 1.0, f"serve_lm: decode_attention disagrees with its "
                        f"plain version on the engine's rings: {worst:.3f}")
    return worst


def _attn_layers_vs_forward(cfg, params, prompt, completion):
    """Each attention layer of the decode step against the teacher-forced
    forward, on the same input (F3).  The forward is run layer by layer
    with the model's own functions (``transformer._layer_apply``, the
    prefill attention paths; its length padded as in _teacher_forced);
    at each attention layer the block's output and keys and values over
    the whole sequence come from ``transformer._attn_block`` in prefill
    mode.  The decode step's block (``_attn_block`` in decode mode: mvm
    projections, the new slot written into the ring, the decode_attention
    kernel) then takes the forward's normed input at every position the
    engine decoded (the remainder prompt tokens and the generated ones),
    one row each, over a 2048-slot ring that holds the forward's keys and
    values of the positions before it at slot pos % 2048, as the engine's
    ring does.  Returns, per attention layer, the worst position's
    max |decode - forward| over TOL_LAYER x its largest |output|."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.common import param_dtype
    from repro_torch.models.layers.embedding import embed
    from repro_torch.models.layers.norm import rms_norm
    from repro_torch.models.layers.rope import rope_angles

    seq = list(prompt) + completion.tokens[:-1]
    S, L = len(seq), len(prompt)
    rows = list(range(1 << (L.bit_length() - 1), S))  # decoded positions
    if tf.NAIVE_ATTN_MAX_SEQ < S < cfg.window:
        seq = seq + [0] * (cfg.window - S)
    Sp = len(seq)
    T = tf.cache_len(cfg, 4096)  # serve_lm's rings (max_seq 4096)
    dev = torch.device("cuda")
    pos = torch.tensor(rows, device=dev)
    idx = pos.to(torch.int32)
    shares = []
    with torch.inference_mode():
        x = embed(params["head"], torch.tensor(seq, device=dev)[None],
                  param_dtype(cfg))
        rope = rope_angles(torch.arange(Sp, dtype=torch.int32,
                                        device=dev)[None],
                           cfg.head_dim, cfg.rope_theta)
        rope_dec = rope_angles(idx[:, None], cfg.head_dim, cfg.rope_theta)
        for i, kind in enumerate(cfg.layer_kinds()):
            p = params["layers"][i]
            if kind == "attn":
                h = rms_norm(x, p["norm1"], cfg.norm_eps)
                o_fwd, kv = tf._attn_block(
                    cfg, p["attn"], h, rope,
                    {"k": h.new_empty((1, Sp, cfg.kv_dim))}, None, "prefill")
                ring = {key: h.new_zeros((len(rows), T, cfg.kv_dim))
                        for key in ("k", "v")}
                for r, t in enumerate(rows):
                    before = torch.arange(max(0, t - T + 1), t, device=dev)
                    for key in ("k", "v"):
                        ring[key][r, before % T] = kv[key][0, before]
                o_dec, _ = tf._attn_block(cfg, p["attn"], h[0, pos][:, None],
                                          rope_dec, ring, idx, "decode")
                ref = o_fwd[0, pos].float()
                err = (o_dec[:, 0].float() - ref).abs().amax(-1)
                limit = TOL_LAYER * ref.abs().amax(-1)
                shares.append(float((err / limit).max()))
                del ring, kv
            x, _ = tf._layer_apply(cfg, kind, p, x, rope, None, None,
                                   "train")
    return shares


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _depth3_vs_cpu(cfg, params):
    """The first three layers (rglru, rglru, attn) at full width serve two
    short prompts on the card and in a device="cpu" engine: equal tokens
    (up to a near-tie, after which the two continue from other tokens)
    and logits within TOL_LM_DEPTH3."""
    import dataclasses

    cfg3 = dataclasses.replace(cfg, n_layers=3)
    p3 = {"final_norm": params["final_norm"], "head": params["head"],
          "layers": params["layers"][:3]}
    prompts = _lm_prompts(cfg.vocab_size, (16, 40), seed=10)
    _, gpu, gpu_logits = _lm_serve(cfg3, p3, prompts, 4, "cuda",
                                   max_batch=2, max_seq=256)
    t0 = time.perf_counter()
    _, cpu, cpu_logits = _lm_serve(cfg3, p3, prompts, 4, "cpu", max_batch=2,
                                   max_seq=256)
    cpu_s = time.perf_counter() - t0
    err, compared = 0.0, 0
    for uid in sorted(gpu):
        g, c = gpu[uid], cpu[uid]
        for i, (tg, tc) in enumerate(zip(g.tokens, c.tokens)):
            e = float((gpu_logits[uid][i].cpu() - cpu_logits[uid][i])
                      .abs().max())
            err = max(err, e)
            compared += 1
            check(e <= TOL_LM_DEPTH3,
                  f"serve_lm depth 3: request {uid} token {i}: logits on "
                  f"the card and the CPU differ by {e:.3e} > "
                  f"{TOL_LM_DEPTH3:g}")
            if tg != tc:
                m = float(_margin(cpu_logits[uid][i:i + 1])[0])
                print(f"serve_lm depth 3: request {uid} token {i} differs "
                      f"at a top-2 margin of {m:.3e}; compared up to here")
                check(m <= TOL_LM_DEPTH3, "serve_lm depth 3: a token "
                      "differs between the card and the CPU")
                break
    on_card = [gpu[u].tokens for u in sorted(gpu)]
    on_cpu = [cpu[u].tokens for u in sorted(cpu)]
    print(f"serve_lm: depth 3 at full width, card vs device=\"cpu\" engine "
          f"({cpu_s:.1f} s on the CPU): tokens {on_card} vs {on_cpu}; "
          f"logits max_abs_err {err:.3e} over {compared} tokens (tol "
          f"{TOL_LM_DEPTH3:g})")


def phase_summary(ctx):
    rows = []
    for name, kernel in ROWS:
        m = ctx.get(name, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES.get(kernel, kernel)}.cu",
            "replaces": KERNELS[kernel],
            "launches": ctx["launches"][name],
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms"),
            **{k: m[k] for k in ("warm_ms", "condition", "b1_ms",
                                 "b1_bound_ms", "graph_ms", "wide_ms",
                                 "wide_bound_ms")
               if k in m},
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
                    help="after each phase's timed rerun, run its main "
                         "path once more under torch.profiler and print the "
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
           "launches": {name: 0 for name, _ in ROWS}}
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
