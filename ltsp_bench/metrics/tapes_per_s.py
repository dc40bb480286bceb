"""Mounts solved per second: every solve that returned a plan, over the
whole window's wall time (host clock)."""


def read(run: dict):
    if run.get("kind") != "mounts":
        return None
    return sum(s["ok"] for s in run["solves"]) / run["window_s"]
