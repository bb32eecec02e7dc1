"""repro_torch.calib: the compile-and-replay calibration subsystem (the
port of ``repro.calib``).

The planner's analytic ``perfmodel`` ranks launch shapes by the
reference's cycle formulas; this package measures the same shapes on the
card and gives the planner ground truth to score against
(``ExecutionPolicy(cost_model="measured")``):

``candidates``  enumerate candidate slot shapes — from a model through
                the planner, or an explicit grid — deduped by
                ``Slot.signature()``
``replay``      lower each candidate to the executor's kernel call and
                time it through ``runtime.obs.measure_samples``
``table``       ``MeasuredCostTable`` (persisted, backend-tagged,
                merge-across-runs, staleness-versioned; the reference's
                JSON schema) and ``MeasuredCostModel`` (exact hit ->
                interpolated neighbour -> analytic fallback, the planner's
                measured scorer)

``hlo``         the static cost walker: a step traced on fake tensors,
                one line per operation this rank dispatches, priced as
                the reference's HLO walker prices a compiled module
                (FLOPs, bytes, transcendentals, collectives); the dry
                run's and the roofline's input

CLI: ``python -m repro_torch.calib`` replays the smoke grid on the card
into ``artifacts/measured_costs.json`` (``--device cpu`` for the plain
versions).
"""
from repro_torch.calib.candidates import (Candidate, SMOKE_GRID,
                                          candidates_for, dedupe, sweep_grid)
from repro_torch.calib.replay import calibrate, check_table, replay_candidate
from repro_torch.calib.table import (CPU_BACKEND, MEASURED_COSTS_PATH,
                                     MeasuredCostModel, MeasuredCostTable,
                                     TABLE_VERSION, analytic_shape_cycles,
                                     current_backend, parse_signature)

__all__ = [
    "Candidate", "SMOKE_GRID", "candidates_for", "dedupe", "sweep_grid",
    "calibrate", "check_table", "replay_candidate",
    "CPU_BACKEND", "MEASURED_COSTS_PATH", "TABLE_VERSION",
    "MeasuredCostModel", "MeasuredCostTable", "analytic_shape_cycles",
    "current_backend", "parse_signature",
]
