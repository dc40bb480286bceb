"""Padded table cells over the tapes' own cells in the traced pass, from
the program's ``KernelProfile`` records (``B_pad R_pad^2 S_pad`` over the
sum of ``n_req^2 (n + 1)``)."""


def read(run: dict):
    prof = run.get("profile")
    if not prof or not prof.get("cells"):
        return None
    real = sum(r for r, _ in prof["cells"])
    return sum(p for _, p in prof["cells"]) / real if real else None
