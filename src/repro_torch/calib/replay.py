"""Replay harness: lower a Candidate to the executor's launch and time it
(the port of ``repro.calib.replay``).

Each candidate becomes the SAME kernel entry point the executor's planned
rung calls for that signature — ``lstm_seq``/``gru_seq`` with (G, B, bt)
batched operands for sequence slots (int8 candidates with the
``quantize_per_gate`` payload and scales, bf16 candidates with the
``bf16_roundtrip`` U), ``lstm_decode``/``gru_decode`` with (L, ...)
stacked weights for chained decode slots — on synthetic operands of the
candidate's shapes and dtype, on the caller's device: the hand-written
kernels on a card, their plain versions on the CPU.

Timing goes through ``runtime.obs.measure_samples``: on the card, CUDA
events recorded around the eager call on an idle stream, so a µs includes
the entry point's host time (operand checks, the ctypes call) as well as
the kernel's.  That is what the eager executor pays per launch, which is
what the planner ranks; the replay is deliberately not timed in a CUDA
graph, because the executor does not run in one.  The per-signature
median + p90 land in a ``MeasuredCostTable`` beside the perfmodel's
analytic estimate for the same shape.

The input hoist (the X-GEMM) is not replayed: the executor runs it
outside the slot's launch (its own ``hoist`` span in a trace), so the
measured µs describe the launch alone.
"""
from __future__ import annotations

import statistics
from typing import Iterable, Optional, Sequence

import torch

from repro_torch.calib.candidates import Candidate, dedupe
from repro_torch.calib.table import (MeasuredCostTable, analytic_shape_cycles,
                                     current_backend, parse_signature)
from repro_torch.core.perfmodel import Design
from repro_torch.dispatch.workitem import GATES
from repro_torch.kernels.common import torch_dtype
from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq
from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq
from repro_torch.kernels.quant import bf16_roundtrip, quantize_per_gate
from repro_torch.rnn.compiled import resolve_device
from repro_torch.runtime.obs import measure_samples


def _operands(cand: Candidate, device: torch.device):
    """Synthetic operands on ``device`` matching the executor's call for
    this shape, and the launch thunk over them."""
    gates = GATES[cand.family]
    H, G, B, bt = cand.H, cand.G, cand.B, cand.block_t
    dt = torch_dtype(cand.dtype)
    lstm = cand.family == "lstm"

    def filled(shape, dtype=dt):
        # deterministic non-trivial values (no PRNG dependency, nothing
        # that can saturate the gates' nonlinearities to a constant)
        n = 1
        for s in shape:
            n *= s
        return (torch.arange(n, dtype=torch.float32, device=device)
                .reshape(shape) % 7.0 * 0.03 - 0.1).to(dtype)

    if cand.chained:
        # a decode tick: G is the layer count L (executor's chained rung)
        L = G
        xw0 = filled((B, gates, H))
        Ws = filled((L, H, gates, H))
        bs = filled((L, gates, H))
        Us = filled((L, H, gates, H))
        h0 = filled((L, B, H))
        if lstm:
            c0 = filled((L, B, H), torch.float32)
            return lambda: lstm_decode(xw0, Ws, bs, Us, h0, c0)
        return lambda: gru_decode(xw0, Ws, bs, Us, h0)

    U = filled((G, H, gates, H))
    xw = filled((G, B, bt, gates, H))
    h0 = filled((G, B, H))
    u_scales = None
    if cand.precision == "int8":
        # the executor's quantized operands: int8 payload + per-gate
        # scales, so the measured µs is the quantized launch's
        qs = [quantize_per_gate(U[g]) for g in range(G)]
        U = torch.stack([q for q, _ in qs])
        u_scales = torch.stack([s for _, s in qs])
    elif cand.precision == "bf16":
        U = bf16_roundtrip(U)
    if lstm:
        c0 = filled((G, B, H), torch.float32)
        return lambda: lstm_seq(U, xw, h0, c0, u_scales=u_scales,
                                block_t=bt)
    return lambda: gru_seq(U, xw, h0, u_scales=u_scales, block_t=bt)


def replay_candidate(cand: Candidate, *, device="cuda", repeats: int = 5,
                     warmup: int = 1) -> dict:
    """Replay one candidate on ``device``: {med_us, p90_us, n} over
    ``repeats`` timed runs (nearest-rank p90, exact at these sample
    sizes)."""
    fn = _operands(cand, resolve_device(device))
    ts = sorted(measure_samples(fn, repeats=repeats, warmup=warmup))
    rank = max(1, -(-len(ts) * 9 // 10))  # ceil(0.9 * n), nearest-rank
    return {"med_us": statistics.median(ts),
            "p90_us": ts[min(rank, len(ts)) - 1], "n": len(ts)}


def calibrate(cands: Iterable[Candidate], *,
              table: Optional[MeasuredCostTable] = None,
              device="cuda", repeats: int = 5, warmup: int = 1,
              macs: int = 16384, progress=None) -> MeasuredCostTable:
    """Replay every (deduped) candidate on ``device`` into a
    MeasuredCostTable bound to that device's backend tag
    (``current_backend(device)``).  ``progress`` is an optional ``str ->
    None`` line sink (the CLI passes print)."""
    backend = current_backend(device)
    if table is None:
        table = MeasuredCostTable(backend)
    elif table.backend != backend:
        raise ValueError(f"calibrate: the table is bound to "
                         f"{table.backend!r}, but device={str(device)!r} "
                         f"measures {backend!r}")
    design = Design(macs=macs, schedule="unfolded")
    for cand in dedupe(cands):
        r = replay_candidate(cand, device=device, repeats=repeats,
                             warmup=warmup)
        est = analytic_shape_cycles(cand.family, cand.H, cand.G, cand.B,
                                    cand.block_t, design,
                                    chained=cand.chained,
                                    precision=cand.precision)
        table.record(cand.signature(), r["med_us"], r["p90_us"], r["n"],
                     est)
        if progress is not None:
            progress(f"  {cand.signature()}: med={r['med_us']:.1f}us "
                     f"p90={r['p90_us']:.1f}us n={r['n']} est={est:.0f}cy")
    return table


def check_table(table: MeasuredCostTable, *, device="cuda",
                tolerance: float = 25.0, repeats: int = 2,
                progress=None) -> Sequence[str]:
    """Re-replay every signature of the table's bound backend on
    ``device`` once and compare against the stored median; returns the
    signatures whose fresh measurement disagrees by more than
    ``tolerance``x either way (a gross check: it exists to catch unit and
    lowering errors, not scheduler jitter).  ``device`` must measure the
    table's backend."""
    backend = current_backend(device)
    if table.backend != backend:
        raise ValueError(f"check_table: the table is bound to "
                         f"{table.backend!r}, but device={str(device)!r} "
                         f"measures {backend!r}")
    bad = []
    for sig in table.signatures():
        f = parse_signature(sig)
        if f is None:
            continue
        cand = Candidate(family=f["family"], H=f["H"], G=f["G"], B=f["B"],
                         block_t=f["chunk_len"], dtype=f["dtype"],
                         dirs=tuple(f["dirs"].split("+")),
                         chained=f["chained"], precision=f["precision"])
        fresh = replay_candidate(cand, device=device,
                                 repeats=repeats)["med_us"]
        stored = table.lookup(sig)["med_us"]
        ratio = max(fresh, stored) / max(min(fresh, stored), 1e-9)
        line = f"  {sig}: stored={stored:.1f}us fresh={fresh:.1f}us " \
               f"ratio={ratio:.2f}x"
        if progress is not None:
            progress(line)
        if ratio > tolerance:
            bad.append(sig)
    return bad
