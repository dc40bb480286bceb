"""Shared CLI helpers (importable without touching device state)."""

from __future__ import annotations

__all__ = ["parse_overrides"]


def parse_overrides(items: list[str] | None):
    """``k=v`` config overrides (bools/ints/floats/str)."""
    out = {}
    for item in items or []:
        k, v = item.split("=", 1)
        if v in ("true", "True"):
            val: object = True
        elif v in ("false", "False"):
            val = False
        else:
            try:
                val = int(v)
            except ValueError:
                try:
                    val = float(v)
                except ValueError:
                    val = v
        out[k] = val
    return out
