"""Distributed helpers of the port.  So far the tape half of
:mod:`.checkpoint` (archive and LTSP-planned restore)."""

from .checkpoint import archive_to_tape, plan_restore

__all__ = ["archive_to_tape", "plan_restore"]
