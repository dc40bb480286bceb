"""Requests the caching allocator could serve only after freeing its cached
blocks, over the traced pass: the ``alloc_retries`` of every ``ltsp.tables``
span (the change in ``num_alloc_retries`` across the table build), summed.
Nothing off the card or where the spans carry no such count."""

from ltsp_bench.host_spans import named, traced_mounts


def read(run: dict):
    mounts = traced_mounts(run)
    if mounts is None:
        return None
    builds = [t for _, tree in mounts for t in named(tree, "ltsp.tables")]
    if not builds or any("alloc_retries" not in t.attrs for t in builds):
        return None
    return float(sum(t.attrs["alloc_retries"] for t in builds))
