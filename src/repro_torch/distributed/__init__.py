"""Distributed helpers of the port: :mod:`.checkpoint`, the hot tier
(save/load) and the tape archive with its LTSP-planned restore, and
:mod:`.fault_tolerance`, straggler detection and elastic re-meshing plans."""

from .checkpoint import archive_to_tape, load_checkpoint, plan_restore, save_checkpoint
from .fault_tolerance import RemeshPlan, StragglerMonitor, remesh_plan, should_checkpoint

__all__ = ["RemeshPlan", "StragglerMonitor", "archive_to_tape", "load_checkpoint",
           "plan_restore", "remesh_plan", "save_checkpoint", "should_checkpoint"]
