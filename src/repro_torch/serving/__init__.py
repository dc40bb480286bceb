"""Serving layer of the port.  So far only the schedule replay oracle
(:mod:`.sim`); the online queue service, drive pool, QoS and faults follow."""

from .sim import Leg, Replay, head_position, replay_schedule, rewind_time

__all__ = ["Leg", "Replay", "replay_schedule", "head_position", "rewind_time"]
