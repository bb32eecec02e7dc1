"""Tile dispatcher: dependency-aware dispatch runtime for recurrent stacks
(the port of ``repro.dispatch``)."""
from repro_torch.dispatch.executor import execute, prepare_decode_stack
from repro_torch.dispatch.planner import (Cell, DispatchPlan, ItemPlan, Slot,
                                          plan, plan_decode)
from repro_torch.dispatch.workitem import WorkItem

__all__ = ["WorkItem", "plan", "plan_decode", "execute",
           "prepare_decode_stack", "DispatchPlan", "ItemPlan", "Slot",
           "Cell"]
