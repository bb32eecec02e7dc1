"""Candidate launch shapes for the compile-and-replay calibration harness
(the port of ``repro.calib.candidates``).

A ``Candidate`` is one concrete launch shape the executor could make —
the same axes ``runtime.obs.slot_signature`` keys on (family x H x G x B x
block_t x dtype x dirs x chained x precision) — and ``calib.replay``
lowers it to the kernel call the executor's planned rung makes for that
signature.

Two enumeration modes, both deduped by signature, whose lists equal the
reference's signature for signature (the planner is a copy):

``candidates_for``
    Walk a ``ModelConfig`` / ``CompiledStack`` through the planner at the
    given (B, T) shapes and emit one candidate per distinct slot of the
    resulting plans, plus — for homogeneous lstm/gru stacks — both
    decode-tick alternatives (the chained single launch AND the per-layer
    loop) at each B, so the chained-vs-loop decision has measured costs on
    BOTH sides.

``sweep_grid``
    The cartesian product of explicit axis values — the offline grid mode
    (``python -m repro_torch.calib``), for populating a table ahead of any
    particular model.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiling import REFERENCE, DeviceModel
from repro_torch.dispatch.planner import DispatchPlan, plan, plan_decode
from repro_torch.dispatch.workitem import WorkItem
from repro_torch.runtime.obs import slot_signature


@dataclass(frozen=True)
class Candidate:
    """One replayable launch shape.  For ``chained`` candidates (a decode
    tick), ``G`` doubles as the layer count L — the chained slot's groups
    ARE the L serially dependent layer cells."""
    family: str
    H: int
    G: int
    B: int
    block_t: int
    dtype: str = "float32"
    dirs: Tuple[str, ...] = ("fwd",)
    chained: bool = False
    precision: str = "fp32"  # replayed with the matching kernel operands
    #                          (int8 payload + per-gate scales), so the
    #                          measured µs prices the quantized launch

    def signature(self) -> str:
        return slot_signature(self.family, self.H, self.G, self.B,
                              self.block_t, self.dtype,
                              directions=self.dirs, chained=self.chained,
                              precision=self.precision)


def _from_plan(p: DispatchPlan) -> List[Candidate]:
    return [Candidate(family=s.family, H=s.H, G=s.g, B=s.B,
                      block_t=s.chunk_len, dtype=s.dtype,
                      dirs=tuple(c.direction for c in s.cells),
                      chained=s.chained, precision=s.precision)
            for s in p.slots]


def dedupe(cands: Iterable[Candidate]) -> List[Candidate]:
    """Signature-keyed dedupe, first occurrence wins, order preserved."""
    seen, out = set(), []
    for c in cands:
        sig = c.signature()
        if sig not in seen:
            seen.add(sig)
            out.append(c)
    return out


def candidates_for(model: Union[ModelConfig, "object"], *,
                   shapes: Sequence[Tuple[int, int]] = ((1, 32),),
                   dtype: str = "float32",
                   macs: int = 16384,
                   decode: bool = True,
                   precision: str = "fp32",
                   device_model: DeviceModel = REFERENCE
                   ) -> List[Candidate]:
    """Candidates a model would actually launch: plan it at each (B, T)
    shape and harvest the slots; for homogeneous lstm/gru stacks add the
    decode tick's chained AND per-layer alternatives at each B.
    ``precision`` plans (and therefore prices) the quantized-weight
    variant of the same stack; ``device_model`` plans for the device the
    table is measured on (``core.tiling.device_model``: a card admits
    stripes the reference's VMEM budget does not).

    ``model`` is a ModelConfig (family "rnn") or any object with the
    CompiledStack shape surface (``families``/``H``/``X``/``L``/
    ``bidirectional``) — the enumeration needs shapes only, never
    parameters."""
    if isinstance(model, ModelConfig):
        fams = ("lstm",) * model.n_layers
        H, X, L = model.lstm_hidden, model.lstm_input, model.n_layers
        bidir = bool(getattr(model, "bidirectional", False))
    else:
        fams = tuple(model.families)
        H, X, L = model.H, model.X, model.L
        bidir = bool(model.bidirectional)

    def item(uid: int, B: int, T: int, share=None) -> WorkItem:
        return WorkItem(uid=uid, family=fams[0], B=B, T=T, H=H, L=L, X=X,
                        dtype=dtype, bidirectional=bidir, share=share,
                        families=fams, precision=precision)

    out: List[Candidate] = []
    for B, T in shapes:
        out += _from_plan(plan([item(0, B, T)], macs=macs,
                               device_model=device_model))
    if decode and not bidir and len(set(fams)) == 1 \
            and fams[0] in ("lstm", "gru"):
        for B in sorted({b for b, _ in shapes}):
            # both sides of the chained-vs-loop decode decision
            out += _from_plan(plan_decode([item(0, B, 1, share=0)],
                                          macs=macs,
                                          device_model=device_model))
            out += _from_plan(plan([item(0, B, 1, share=0)], macs=macs,
                                   schedule="wavefront", block_t=1,
                                   device_model=device_model))
    return dedupe(out)


def sweep_grid(*, families: Sequence[str] = ("lstm", "gru"),
               Hs: Sequence[int] = (64,),
               Gs: Sequence[int] = (1, 3),
               Bs: Sequence[int] = (1, 3),
               block_ts: Sequence[int] = (1,),
               dtypes: Sequence[str] = ("float32",),
               chained_Ls: Sequence[int] = (3,),
               precisions: Sequence[str] = ("fp32",)) -> List[Candidate]:
    """The cartesian grid: sequence-slot shapes over family x H x G x B x
    block_t x dtype x precision, plus chained decode shapes (one per
    family x H x B x dtype x L in ``chained_Ls`` — decode ticks run the
    dense dequantized weights, so they carry no precision axis)."""
    out = [Candidate(family=f, H=h, G=g, B=b, block_t=bt, dtype=dt,
                     precision=p)
           for f, h, g, b, bt, dt, p in itertools.product(
               families, Hs, Gs, Bs, block_ts, dtypes, precisions)]
    out += [Candidate(family=f, H=h, G=l, B=b, block_t=1, dtype=dt,
                      chained=True)
            for f, h, b, dt, l in itertools.product(
                families, Hs, Bs, dtypes, chained_Ls)]
    return dedupe(out)


#: the smoke grid (``python -m repro_torch.calib``): the reference's, so
#: both packages calibrate the same signatures — both sides of the
#: chained-vs-loop decode decision at H64/L3 and both sides of the
#: int8-vs-fp32 pricing split
SMOKE_GRID = dict(families=("lstm", "gru"), Hs=(64,), Gs=(1, 3),
                  Bs=(1, 3), block_ts=(1,), dtypes=("float32",),
                  chained_Ls=(3,), precisions=("fp32", "int8"))
