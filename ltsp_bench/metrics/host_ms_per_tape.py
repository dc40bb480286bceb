"""Host time a mount that the card cannot overlap, in ms, the mean over the
traced pass: each ``ltsp.solve`` root's duration less the two stretches
the card covers, ``ltsp.tables`` (the table build's enqueue) and the
``ltsp.wait`` on the root value (the build itself), from the program's
host-clock spans.  What is left is exposed: the preparation and its
copies, the traceback launch, the wait on the detours, the finish and the
root's own Python."""

from ltsp_bench.host_spans import named, traced_mounts


def read(run: dict):
    mounts = traced_mounts(run)
    if mounts is None:
        return None
    host_ns = []
    for root, tree in mounts:
        tables, build = named(tree, "ltsp.tables"), named(tree, "ltsp.wait", "root")
        if not tables or not build:
            return None
        host_ns.append(root.t1 - root.t0 - sum(s.t1 - s.t0 for s in tables + build))
    return sum(host_ns) / len(host_ns) / 1e6
