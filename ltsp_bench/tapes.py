"""The benchmark's tape workload: a frozen copy of the generator it draws
from, and the seeded orders and samples of a run.

``generate_tapes`` reproduces ``repro_torch.data.generator.generate_dataset``
(the paper-calibrated IN2P3 profile, arXiv:2112.09384 Tables 1-2) as plain
numpy arrays: the benchmark's inputs must not move when the program's own
generator changes.  ``tests/test_bench_frozen.py`` holds it equal to the
program's at the configurations' seeds.  :func:`bucket` is the shape a
tape's tables are padded to; the pass order and the check's sample are
spread over those shapes.

A tape is a dict ``{"left", "size", "mult"}`` (int64 arrays over the
requested files, left to right) plus ``"m"``, the tape length, and
``"u_turn"``; positions are integer MB.
"""

from __future__ import annotations

import numpy as np

#: profile keys a configuration gives under ``"profile"`` (all required)
PROFILE_KEYS = (
    "n_tapes", "nf_median", "nf_sigma", "nf_clip", "req_frac_median", "req_frac_sigma",
    "req_frac_clip", "mult_alpha", "mult_cap", "n_req_cap", "cv_median", "cv_sigma",
    "cv_clip", "tape_capacity",
)


def _lognormal(z: float, median: float, sigma: float, lo, hi):
    return np.clip(median * np.exp(sigma * z), lo, hi)


def generate_tape(profile: dict, seed: int) -> dict:
    """One tape of ``profile`` drawn from ``seed`` (U-turn penalty 0)."""
    rng = np.random.default_rng(seed)
    cap = int(profile["tape_capacity"])
    n_f = int(_lognormal(rng.standard_normal(), profile["nf_median"], profile["nf_sigma"],
                         *profile["nf_clip"]))
    frac = float(_lognormal(rng.standard_normal(), profile["req_frac_median"],
                            profile["req_frac_sigma"], *profile["req_frac_clip"]))
    n_req = max(2, min(n_f, profile["n_req_cap"], int(round(frac * n_f))))
    cv = float(_lognormal(rng.standard_normal(), profile["cv_median"], profile["cv_sigma"],
                          *profile["cv_clip"]))
    mean_size = cap / n_f
    sigma2 = np.log1p(cv**2)
    mu = np.log(mean_size) - sigma2 / 2
    sizes = np.exp(rng.normal(mu, np.sqrt(sigma2), size=n_f))
    sizes = np.maximum(1, np.round(sizes * cap / sizes.sum())).astype(np.int64)
    lefts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    req_idx = np.sort(rng.choice(n_f, size=n_req, replace=False))
    mult = 1 + np.minimum(rng.zipf(profile["mult_alpha"], size=n_req), profile["mult_cap"] - 1)
    return {"left": lefts[req_idx].astype(np.int64), "size": sizes[req_idx].astype(np.int64),
            "mult": mult.astype(np.int64), "m": int(sizes.sum()), "u_turn": 0}


def half_seg(tapes: list[dict]) -> int:
    """The paper's U-turn penalty ``half_seg`` (§5.3): half the average
    requested-file size over the whole dataset."""
    total = sum(int(t["size"].sum()) for t in tapes)
    count = sum(len(t["left"]) for t in tapes)
    return (total // max(1, count)) // 2


def generate_tapes(profile: dict, base_seed: int, u_turn: str) -> list[dict]:
    """Every tape of the dataset (tape ``i`` from seed ``base_seed + i``),
    with the named U-turn penalty (``"zero"`` or ``"half_seg"``)."""
    tapes = [generate_tape(profile, base_seed + i) for i in range(profile["n_tapes"])]
    u = {"zero": 0, "half_seg": half_seg(tapes) if u_turn == "half_seg" else 0}[u_turn]
    for t in tapes:
        t["u_turn"] = u
    return tapes


def seeded(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use of a run's seed (traffic order, check
    sample, ...): the same seed gives the same draws, whatever its size."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), stream]))


def draw_sample(keys: list, work: list, groups: list, extra: int,
                rng: np.random.Generator) -> list:
    """Keys to check, in key order: the one with the most ``work`` (the
    first of equals), one drawn by ``rng`` from every other group of
    ``groups`` (a key's group, such as its shape bucket), and ``extra`` more
    drawn from the keys left."""
    if not keys:
        return []
    top = max(range(len(keys)), key=lambda j: (work[j], -j))
    picked = {top}
    for g in sorted(set(groups) - {groups[top]}):
        members = [j for j in range(len(keys)) if groups[j] == g]
        picked.add(members[int(rng.integers(len(members)))])
    rest = [j for j in range(len(keys)) if j not in picked]
    drawn = rng.choice(len(rest), size=min(extra, len(rest)), replace=False)
    picked.update(rest[j] for j in drawn.tolist())
    return [keys[j] for j in sorted(picked)]


def spread_order(keys: list, groups: list, rng: np.random.Generator) -> list:
    """``keys`` in an order drawn by ``rng`` in which every group is spread
    evenly: the ``j``-th of a group's ``n`` keys (in a drawn order) goes at
    ``(j + u) / n``, ``u`` drawn once for the group.  So before any point
    ``x`` of the order each group holds ``n x`` of its keys, within one,
    whatever the seed: a pass cut anywhere holds each group in proportion."""
    slots = []
    for g in sorted(set(groups)):
        members = [k for k, gk in zip(keys, groups) if gk == g]
        u = float(rng.random())
        for j, k in enumerate(rng.permutation(len(members)).tolist()):
            slots.append(((j + u) / len(members), float(rng.random()), members[k]))
    return [k for _, _, k in sorted(slots, key=lambda s: s[:2])]


def bucket(n_req: int, n: int) -> tuple[int, int]:
    """``(R_pad, S_pad)``, the shape a tape's tables are padded to: ``R`` to
    the next power of two, ``S = n + 1`` to the next power-of-two multiple
    of 128 (a copy of ``repro_torch.kernels.ltsp_dp.ops.bucket_shape``)."""
    return pow2(n_req), 128 * pow2(-(-(n + 1) // 128))


def pow2(v: int) -> int:
    """Smallest power of two >= v (v >= 1)."""
    return 1 << max(0, int(v) - 1).bit_length()
