"""The wait of the tape that waits longest, in ms: each tape's median time
to solution over its mounts in the window, from the call into the solver to
the plan on the host (host clock), and the largest of those medians.  A
median over one tape's own mounts does not move with where the window cuts
its last pass or with the traced pass's profiler, as a percentile over all
mounts does where a few tapes are several times slower than the rest."""

import collections

import numpy as np


def read(run: dict):
    if run.get("kind") != "mounts":
        return None
    by_tape = collections.defaultdict(list)
    for s in run["solves"]:
        if s["ok"]:
            by_tape[s["tape"]].append(s["seconds"])
    if not by_tape:
        return None
    return max(float(np.median(v)) for v in by_tape.values()) * 1e3
