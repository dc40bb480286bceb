"""Kernel launches of the table driver per mount in the traced pass: the
program's ``ltsp_dp.LAUNCHES`` of ``far_fold_kernel`` and
``near_fold_kernel``."""


def read(run: dict):
    prof = run.get("profile")
    if not prof or run.get("kind") != "mounts" or not prof["solves"]:
        return None
    n = prof["launches"].get("far_fold_kernel", 0) + prof["launches"].get("near_fold_kernel", 0)
    if n == 0:  # the plain version built the tables: nothing was launched
        return None
    return n / len(prof["solves"])
