"""Tape tier: cartridges, LTSP-scheduled batch reads, pending queues."""
