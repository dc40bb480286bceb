"""The table build's share of its roofline, in %: the least time of every
table built in the traced pass (``roofline.least_seconds``, each tape's own
shape and span) over the device time of the two kernels that build tables,
``far_fold_kernel`` and ``near_fold_kernel``, from the profiler's trace."""

from ltsp_bench.profiling import kernel_seconds

KERNELS = ("far_fold_kernel", "near_fold_kernel")


def read(run: dict):
    prof = run.get("profile")
    if not prof or run.get("kind") != "mounts":
        return None
    busy = sum(kernel_seconds(prof, k) for k in KERNELS)
    if busy <= 0:
        return None
    return 100.0 * sum(s["least_s"] for s in prof["solves"]) / busy
