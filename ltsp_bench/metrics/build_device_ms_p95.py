"""The 95th percentile over the traced pass's mounts of the table build's
device time, in ms: the ``device_ns`` the program's ``ltsp.tables`` spans
carry, from two CUDA events around the fills and the last fold launch
(none off the card)."""

import numpy as np

from ltsp_bench.host_spans import named, traced_mounts


def read(run: dict):
    mounts = traced_mounts(run)
    if mounts is None:
        return None
    build_ns = []
    for _, tree in mounts:
        tables = named(tree, "ltsp.tables")
        if not tables or any("device_ns" not in t.attrs for t in tables):
            return None
        build_ns.append(sum(t.attrs["device_ns"] for t in tables))
    return float(np.percentile(build_ns, 95)) / 1e6
