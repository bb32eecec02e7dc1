"""MeasuredCostTable + MeasuredCostModel: measured µs per slot signature
(the port of ``repro.calib.table``).

The planner's analytic ``perfmodel`` ranks launch shapes by the
reference's cycle formulas, which describe the paper's accelerator and
not the card.  This module is the ground-truth side of the measured-launch
cost model:

``MeasuredCostTable``
    ``signature -> {med_us, p90_us, n, est_cycles, runs, stamp}`` per
    backend, persisted to ``artifacts/measured_costs.json``.  The JSON
    schema and ``TABLE_VERSION`` are the reference's, so one file can hold
    the JAX package's entries and the port's side by side, each under its
    own backend tag.  The port's tags are ``cuda(<device name>)`` on the
    card and ``torch(cpu)`` for the kernels' plain versions; neither can
    equal a reference tag (``interpret(cpu)``, ``cpu``, ``tpu``), so a µs
    of one never scores a plan of another — lookups only see the table's
    bound backend.  ``save()`` merges across runs: a conflicting signature
    takes the NEWER run's med/p90/est (monotonic ``stamp``), while sample
    and run counts accumulate; other backends' entries pass through
    untouched.  A mismatched schema ``version`` is stale and loads empty.

``MeasuredCostModel``
    The planner-facing scorer (``ExecutionPolicy(cost_model="measured")``).
    ``slot_us(...)`` resolves a candidate launch shape in three steps:
    exact signature hit -> measured median; near miss -> the nearest
    measured neighbour (same family/dtype/dirs/chained/precision, every
    shape dim within ``NEIGHBOR_MAX_RATIO``) scaled by the analytic cycle
    ratio of the two shapes; otherwise -> the analytic estimate converted
    to µs by the table's mean ``cycles_per_us``.  Each resolution is
    counted (``hits``/``interpolated``/``fallbacks``, which
    ``CompiledStack.stats`` surfaces).  An EMPTY table reports ``active ==
    False`` and the planner never consults it, so cold-start measured mode
    plans exactly as analytic mode.

Timing never happens here: ``calib.replay`` measures through
``runtime.obs.measure_samples``.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.perfmodel import (Design, decode_plan_cycles,
                                        slot_launch_cycles)
from repro_torch.runtime.obs import slot_signature

#: persisted calibration table (replayed *candidate* shapes, which is what
#: the planner needs to score roads not taken)
MEASURED_COSTS_PATH = os.path.join("artifacts", "measured_costs.json")

#: schema version — the reference's; bump both together whenever entry
#: semantics change.  Older files are stale and load as empty.
TABLE_VERSION = 1

#: the backend tag of the kernels' plain versions on the CPU
CPU_BACKEND = "torch(cpu)"


def current_backend(device="cuda") -> str:
    """The backend tag measured entries carry for ``device``:
    ``cuda(<torch.cuda.get_device_name>)`` on a card (a µs of one card
    model never scores another's plans), ``torch(cpu)`` on the CPU.  Like
    ``rnn.resolve_device``, ``device="cuda"`` without a card raises: the
    port never answers with the CPU's tag on its own."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but "
                "torch.cuda.is_available() is False; pass device=\"cpu\" for "
                "the plain PyTorch versions' backend tag")
        return f"cuda({torch.cuda.get_device_name(device)})"
    if device.type == "cpu":
        return CPU_BACKEND
    raise ValueError(f"device={str(device)!r} invalid; allowed: cuda, cpu")


def parse_signature(sig: str) -> Optional[dict]:
    """Invert ``runtime.obs.slot_signature``: ``"lstm|H64|G3|B1|bt1|
    float32|fwd|chained"`` -> field dict, or None for a malformed string
    (foreign keys in a hand-edited table are skipped, not fatal).  The
    optional trailing tokens — ``p<precision>`` (absent = fp32) then
    ``chained`` — land in the ``precision`` / ``chained`` fields."""
    parts = sig.split("|")
    if len(parts) < 7:
        return None
    try:
        out = {"family": parts[0], "H": int(parts[1][1:]),
               "G": int(parts[2][1:]), "B": int(parts[3][1:]),
               "chunk_len": int(parts[4][2:]), "dtype": parts[5],
               "dirs": parts[6], "precision": "fp32", "chained": False}
        for tok in parts[7:]:
            if tok == "chained":
                out["chained"] = True
            elif tok.startswith("p"):
                out["precision"] = tok[1:]
            else:
                return None
        return out
    except (ValueError, IndexError):
        return None


def analytic_shape_cycles(family: str, H: int, G: int, B: int,
                          chunk_len: int, design: Design, *,
                          chained: bool = False,
                          precision: str = "fp32") -> float:
    """The perfmodel's estimate for one launch of this shape (chained
    slots: G is the layer count L; decode ignores precision — its ticks
    run the dense dequantized weights)."""
    if chained:
        return decode_plan_cycles(family, H, H, G, design)
    return slot_launch_cycles(family, H, chunk_len, [B] * G, design,
                              precision=precision)


class MeasuredCostTable:
    """Backend-tagged ``signature -> measured µs`` with run-merge and
    staleness semantics (module doc).  One instance is bound to ONE
    backend (lookups and ``record`` use it); entries for other backends
    are carried opaquely so ``save`` never drops a machine's calibration
    just because this run measured a different one."""

    def __init__(self, backend: str,
                 entries: Optional[Dict[str, Dict[str, dict]]] = None,
                 stamp: int = 0):
        self.backend = backend
        #: backend -> signature -> entry dict
        self.entries: Dict[str, Dict[str, dict]] = entries or {}
        #: the highest run stamp merged into ``entries`` (this run's new
        #: records are stamped ``stamp + 1`` at save time)
        self.stamp = stamp

    # -- recording ------------------------------------------------------
    def record(self, sig: str, med_us: float, p90_us: float, n: int,
               est_cycles: float) -> None:
        """File one replayed signature under the bound backend.  A repeat
        within one run overwrites.  The ``None`` stamp marks a
        not-yet-persisted record — always newest in ``save``'s merge, then
        replaced by the real run stamp."""
        self.entries.setdefault(self.backend, {})[sig] = {
            "med_us": float(med_us), "p90_us": float(p90_us),
            "n": int(n), "est_cycles": float(est_cycles),
            "runs": 1, "stamp": None,
        }

    # -- lookup ---------------------------------------------------------
    def lookup(self, sig: str) -> Optional[dict]:
        """The bound backend's entry for ``sig``, or None — entries
        measured under any other backend are invisible here."""
        return self.entries.get(self.backend, {}).get(sig)

    def signatures(self) -> List[str]:
        return sorted(self.entries.get(self.backend, {}))

    def __len__(self) -> int:
        return len(self.entries.get(self.backend, {}))

    def mean_cycles_per_us(self) -> float:
        """The calibration constant analytic fallbacks divide by: the mean
        est_cycles/med_us over the bound backend's entries (0.0 when the
        table is empty)."""
        ratios = [e["est_cycles"] / e["med_us"]
                  for e in self.entries.get(self.backend, {}).values()
                  if e["med_us"] > 0 and e["est_cycles"] > 0]
        return sum(ratios) / len(ratios) if ratios else 0.0

    # -- persistence ----------------------------------------------------
    def save(self, path: str = MEASURED_COSTS_PATH) -> str:
        """Merge this table into ``path`` and write it.

        The on-disk table is loaded first; for a signature both sides
        carry, the side with the newer ``stamp`` wins med/p90/est while
        ``n`` and ``runs`` ACCUMULATE; signatures only one side carries
        pass through.  This run's records are stamped one past the highest
        stamp ever merged, so "newer" is well-defined across machines
        sharing one file."""
        disk = self.load(path, backend=self.backend) \
            if os.path.exists(path) else MeasuredCostTable(self.backend)
        stamp = max(self.stamp, disk.stamp) + 1
        merged: Dict[str, Dict[str, dict]] = {
            b: dict(sigs) for b, sigs in disk.entries.items()}
        for b, sigs in self.entries.items():
            tgt = merged.setdefault(b, {})
            for sig, e in sigs.items():
                # a None stamp is a record made this run — always newest
                mine = {**e, "stamp": stamp} if e["stamp"] is None \
                    else dict(e)
                old = tgt.get(sig)
                if old is None:
                    tgt[sig] = mine
                    continue
                if e["stamp"] is not None and e["stamp"] == old["stamp"]:
                    continue  # same lineage (we loaded it from this file)
                newer, older = (mine, old) if mine["stamp"] >= old["stamp"] \
                    else (old, mine)
                tgt[sig] = {**newer,
                            "n": newer["n"] + older["n"],
                            "runs": newer["runs"] + older["runs"]}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": TABLE_VERSION, "stamp": stamp,
                       "backends": merged}, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str = MEASURED_COSTS_PATH, *,
             backend: Optional[str] = None) -> "MeasuredCostTable":
        """Load a table bound to ``backend`` (default: the card's,
        ``current_backend("cuda")``).  A missing file or a stale schema
        ``version`` loads as EMPTY — the planner then runs pure-analytic
        (cold start) instead of scoring against entries whose meaning may
        have changed."""
        backend = backend if backend is not None else current_backend()
        if not os.path.exists(path):
            return cls(backend)
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != TABLE_VERSION:
            return cls(backend)
        return cls(backend, entries=raw.get("backends", {}),
                   stamp=int(raw.get("stamp", 0)))

    def describe(self) -> str:
        rows = self.entries.get(self.backend, {})
        if not rows:
            return f"measured costs [{self.backend}]: (empty)"
        lines = [f"measured costs [{self.backend}]: {len(rows)} signatures"
                 f" (mean {self.mean_cycles_per_us():.2f}cy/us)"]
        for sig in sorted(rows):
            e = rows[sig]
            lines.append(
                f"  {sig}: med={e['med_us']:.1f}us p90={e['p90_us']:.1f}us "
                f"n={e['n']} runs={e['runs']} est={e['est_cycles']:.0f}cy")
        return "\n".join(lines)


class MeasuredCostModel:
    """The planner's measured scorer (module doc): exact hit ->
    interpolated neighbour -> analytic-converted fallback, with counters.

    All returns are µs; the planner only compares these against each
    other, never against raw cycles.  ``active`` is False over an empty
    table, in which case the planner never calls ``slot_us`` at all —
    cold-start measured mode IS analytic mode."""

    #: a neighbour is trustworthy only when every shape dim (H, G, B,
    #: chunk_len) is within this factor of the query — beyond that the
    #: analytic scaling ratio is extrapolating, not interpolating
    NEIGHBOR_MAX_RATIO = 4.0

    def __init__(self, table: MeasuredCostTable, macs: int = 16384):
        self.table = table
        self.design = Design(macs=macs, schedule="unfolded")
        self.hits = 0           # exact signature lookups
        self.interpolated = 0   # neighbour-scaled lookups
        self.fallbacks = 0      # analytic-converted (no close neighbour)
        self._cpu: Optional[float] = None

    @property
    def active(self) -> bool:
        return len(self.table) > 0

    @property
    def on_card(self) -> bool:
        """True when the bound table was measured on a card
        (``cuda(...)``): the planner then weighs kernel roads only."""
        return self.table.backend.startswith("cuda(")

    def cycles_to_us(self, cycles: float) -> float:
        """Analytic cycles -> µs via the table's mean calibration constant
        (keeps every candidate in ONE unit when some shapes have no
        measured neighbour)."""
        if self._cpu is None:
            self._cpu = self.table.mean_cycles_per_us()
        return cycles / self._cpu if self._cpu > 0 else cycles

    def slot_us(self, family: str, H: int, G: int, B: int, chunk_len: int,
                dtype: str, dirs: Sequence[str] = ("fwd",),
                chained: bool = False, precision: str = "fp32") -> float:
        """Measured µs for one candidate launch shape (resolution ladder
        in the module doc).  ``precision`` is categorical: an int8 query
        only ever resolves against int8 entries (exact or neighbour)."""
        sig = slot_signature(family, H, G, B, chunk_len, dtype,
                             directions=dirs, chained=chained,
                             precision=precision)
        hit = self.table.lookup(sig)
        if hit is not None:
            self.hits += 1
            return hit["med_us"]
        est = analytic_shape_cycles(family, H, G, B, chunk_len, self.design,
                                    chained=chained, precision=precision)
        nb = self._nearest(family, dtype, dirs, chained, precision,
                           H, G, B, chunk_len)
        if nb is not None:
            n, e = nb
            self.interpolated += 1
            n_est = analytic_shape_cycles(
                n["family"], n["H"], n["G"], n["B"], n["chunk_len"],
                self.design, chained=n["chained"],
                precision=n["precision"])
            return e["med_us"] * (est / n_est) if n_est > 0 else e["med_us"]
        self.fallbacks += 1
        return self.cycles_to_us(est)

    def _nearest(self, family, dtype, dirs, chained, precision,
                 H, G, B, chunk_len):
        """The closest measured shape sharing the categorical fields
        (family, dtype, dirs, chained, precision), by summed |log ratio|
        over (H, G, B, chunk_len); None when no entry is within
        ``NEIGHBOR_MAX_RATIO`` on every dim."""
        want_dirs = "+".join(sorted(set(dirs)))
        best = None
        for sig in self.table.signatures():
            n = parse_signature(sig)
            if n is None or n["family"] != family or n["dtype"] != dtype \
                    or n["dirs"] != want_dirs or n["chained"] != chained \
                    or n["precision"] != precision:
                continue
            ratios = [max(a, b) / min(a, b) for a, b in
                      ((n["H"], H), (n["G"], G), (n["B"], B),
                       (n["chunk_len"], chunk_len)) if min(a, b) > 0]
            if not ratios or max(ratios) > self.NEIGHBOR_MAX_RATIO:
                continue
            dist = sum(math.log(r) for r in ratios)
            if best is None or dist < best[0]:
                best = (dist, n, self.table.lookup(sig))
        return None if best is None else (best[1], best[2])

    def describe(self) -> str:
        state = (f"{len(self.table)} table entries "
                 f"[{self.table.backend}], {self.hits} hits, "
                 f"{self.interpolated} interpolated, "
                 f"{self.fallbacks} analytic fallbacks")
        if not self.active:
            return f"measured (cold start — empty table, scoring analytic; " \
                   f"{state})"
        return f"measured ({state})"
