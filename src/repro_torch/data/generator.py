"""Synthetic tape-workload generator calibrated to the paper's dataset.

The real IN2P3 dataset (paper Appendix C.1) is not redistributable here, so we
generate instances whose marginal statistics match the published Tables 1-2:

  =========================  =====  ======  =====  ======
  statistic                   min   median   mean    max
  =========================  =====  ======  =====  ======
  files per tape (n_f)        111     490     709   4,142
  requested files (n_req)      31     148     170     852
  total requests (n)        1,182   2,669   3,640  15,477
  avg file size (GB)          4.9      40      50     167
  file-size CV (%)              6      56      94     379
  =========================  =====  ======  =====  ======

Tapes are 20 TB Jaguar E cartridges; sizes are drawn lognormal with a
per-tape coefficient of variation, multiplicities are Zipf-like (aggregates
replace per-file requests, hence the heavy tail).  Positions are integer MB,
keeping every algorithm exact while staying far from int64 limits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.instance import Instance, make_instance

__all__ = [
    "DatasetProfile",
    "PAPER_PROFILE",
    "SMALL_PROFILE",
    "generate_instance",
    "generate_dataset",
    "u_turn_values",
]

MB = 1
GB = 1000 * MB
TB = 1000 * GB
TAPE_CAPACITY = 20 * TB  # Jaguar E


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """Statistical profile for the generator."""

    name: str
    n_tapes: int
    # lognormal parameters for files-per-tape, clipped to [lo, hi]
    nf_median: float
    nf_sigma: float
    nf_clip: tuple[int, int]
    # fraction of files requested, clipped
    req_frac_median: float
    req_frac_sigma: float
    req_frac_clip: tuple[float, float]
    # per-file request multiplicity: 1 + Zipf(alpha), capped
    mult_alpha: float
    mult_cap: int
    # absolute cap on requested files per tape (paper max: 852)
    n_req_cap: int
    # per-tape file-size coefficient of variation, lognormal, clipped
    cv_median: float
    cv_sigma: float
    cv_clip: tuple[float, float]
    tape_capacity: int = TAPE_CAPACITY


#: Matches the published IN2P3 statistics (use for paper-scale runs).
PAPER_PROFILE = DatasetProfile(
    name="paper",
    n_tapes=169,
    nf_median=490.0,
    nf_sigma=0.78,
    nf_clip=(111, 4142),
    req_frac_median=0.22,
    req_frac_sigma=0.55,
    req_frac_clip=(0.04, 0.80),
    mult_alpha=1.5,
    mult_cap=350,
    n_req_cap=860,
    cv_median=0.56,
    cv_sigma=0.80,
    cv_clip=(0.06, 3.79),
)

#: ~10x smaller instances for CI/benchmarks (same shape of distributions).
SMALL_PROFILE = dataclasses.replace(
    PAPER_PROFILE,
    name="small",
    n_tapes=40,
    nf_median=60.0,
    nf_clip=(16, 400),
    mult_cap=120,
    n_req_cap=120,
)

#: benchmark default: bounded so the exact DP finishes in ~1s/instance (the
#: paper's own single-thread Python DP needs minutes at full scale).
BENCH_PROFILE = dataclasses.replace(
    SMALL_PROFILE,
    name="bench",
    n_tapes=30,
    nf_clip=(16, 200),
    mult_cap=60,
    n_req_cap=44,
)


def _lognormal(rng: np.ndarray, median: float, sigma: float, lo, hi):
    v = median * np.exp(sigma * rng)
    return np.clip(v, lo, hi)


def generate_instance(
    profile: DatasetProfile, seed: int, u_turn: int = 0
) -> Instance:
    """Generate one tape (one LTSP instance) from the profile."""
    rng = np.random.default_rng(seed)

    n_f = int(_lognormal(rng.standard_normal(), profile.nf_median, profile.nf_sigma, *profile.nf_clip))
    frac = float(
        _lognormal(rng.standard_normal(), profile.req_frac_median, profile.req_frac_sigma, *profile.req_frac_clip)
    )
    n_req = max(2, min(n_f, profile.n_req_cap, int(round(frac * n_f))))
    cv = float(_lognormal(rng.standard_normal(), profile.cv_median, profile.cv_sigma, *profile.cv_clip))

    # lognormal sizes with target mean (tape full) and coefficient of variation
    mean_size = profile.tape_capacity / n_f
    sigma2 = np.log1p(cv**2)
    mu = np.log(mean_size) - sigma2 / 2
    sizes = np.exp(rng.normal(mu, np.sqrt(sigma2), size=n_f))
    sizes = np.maximum(1, np.round(sizes * profile.tape_capacity / sizes.sum())).astype(np.int64)

    # files are written back-to-back (segments), left to right
    lefts_all = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    m = int(sizes.sum())

    # which files are requested + Zipf-like multiplicities
    req_idx = np.sort(rng.choice(n_f, size=n_req, replace=False))
    mult = 1 + np.minimum(rng.zipf(profile.mult_alpha, size=n_req), profile.mult_cap - 1)

    return make_instance(
        left=lefts_all[req_idx],
        size=sizes[req_idx],
        mult=mult.astype(np.int64),
        m=m,
        u_turn=u_turn,
    )


def generate_dataset(
    profile: DatasetProfile = SMALL_PROFILE, u_turn: int = 0, base_seed: int = 20210917
) -> list[Instance]:
    """Generate the full multi-tape dataset (one Instance per tape)."""
    return [
        generate_instance(profile, seed=base_seed + i, u_turn=u_turn)
        for i in range(profile.n_tapes)
    ]


def u_turn_values(instances: list[Instance]) -> dict[str, int]:
    """Paper §5.3's three U-turn penalties: 0, half the average segment size
    across the dataset, and the average segment size."""
    tot = sum(int(i.size.sum()) for i in instances)
    cnt = sum(i.n_req for i in instances)
    avg_seg = tot // max(1, cnt)
    return {"zero": 0, "half_seg": avg_seg // 2, "full_seg": avg_seg}
