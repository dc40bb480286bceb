"""Distributed helpers of the port.  So far :mod:`.checkpoint`: the hot tier
(save/load) and the tape archive with its LTSP-planned restore."""

from .checkpoint import archive_to_tape, load_checkpoint, plan_restore, save_checkpoint

__all__ = ["archive_to_tape", "load_checkpoint", "plan_restore", "save_checkpoint"]
