"""The 95th percentile of every mount's time to solution in the window, in
ms: from the call into the solver to the plan on the host (host clock)."""

import numpy as np


def read(run: dict):
    if run.get("kind") != "mounts" or not run["solves"]:
        return None
    return float(np.percentile([s["seconds"] for s in run["solves"]], 95)) * 1e3
