"""The benchmark's frozen generator and bucket rule equal the program's
at the configurations' seeds."""

import json

import numpy as np
import pytest

from ltsp_bench import cell as cells
from ltsp_bench import tapes as tapegen

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
CONFIGS = tuple(c["name"] for c in BENCH["configs"])


def config(name: str) -> dict:
    """The configuration ``BENCHMARK.json`` names ``name``, from its file."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    return json.loads((cells.ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_tapes_equal_the_programs_dataset(name):
    from repro_torch.data import PAPER_PROFILE, generate_dataset, u_turn_values

    ds = config(name)["dataset"]
    profile = {k: getattr(PAPER_PROFILE, k) for k in tapegen.PROFILE_KEYS}
    assert {k: list(v) if isinstance(v, tuple) else v for k, v in profile.items()} \
        == ds["profile"]
    u = u_turn_values(generate_dataset(PAPER_PROFILE))[ds["u_turn"]]
    theirs = generate_dataset(PAPER_PROFILE, u_turn=u, base_seed=ds["base_seed"])
    ours = tapegen.generate_tapes(ds["profile"], ds["base_seed"], ds["u_turn"])
    assert len(ours) == len(theirs) == 169
    for a, b in zip(ours, theirs):
        assert np.array_equal(a["left"], b.left)
        assert np.array_equal(a["left"] + a["size"], b.right)
        assert np.array_equal(a["mult"], b.mult)
        assert (a["m"], a["u_turn"]) == (b.m, b.u_turn)


#: the dataset's 8 tapes whose tables pad to 1024 windows (n_req 516-714)
WIDE_TAPES = (3, 5, 13, 22, 76, 108, 123, 160)

#: the tapes a configuration serves, by its ``max_r_pad``: every tape of
#: the 169 but the widest at 512, all of them at 1024
SERVED = {512: [i for i in range(169) if i not in WIDE_TAPES], 1024: list(range(169))}


def test_the_tape_set_is_the_configurations():
    from ltsp_bench.drivers import mounts

    for name in CONFIGS:
        cfg = config(name)
        kept = [i for i, _ in mounts.tape_set(cfg)]
        assert len(kept) == cfg["tapes_served"]
        if cfg["max_r_pad"] in SERVED:
            assert kept == SERVED[cfg["max_r_pad"]]


def test_a_configuration_at_1024_windows_serves_the_published_set():
    """The in2p3-dp dataset at ``max_r_pad`` 1024 serves all its published
    tapes; those past 512 windows are the 8 widest, n_req 516-714."""
    from ltsp_bench.drivers import mounts

    whole = config("in2p3-dp")
    whole.update(max_r_pad=1024, tapes_served=whole["published_tapes"])
    kept = dict(mounts.tape_set(whole))
    assert list(kept) == SERVED[1024]
    wide = [i for i, t in kept.items() if tapegen.pow2(len(t["left"])) > 512]
    assert tuple(wide) == WIDE_TAPES
    assert (min(len(kept[i]["left"]) for i in wide), max(len(kept[i]["left"]) for i in wide)) \
        == (516, 714)


@pytest.mark.parametrize("name", CONFIGS)
def test_buckets_equal_the_programs(name):
    from repro_torch.core.instance import make_instance
    from repro_torch.kernels.ltsp_dp.ops import bucket_shape
    from ltsp_bench.drivers import mounts

    for _, t in mounts.tape_set(config(name)):
        inst = make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"])
        assert tapegen.bucket(len(t["left"]), int(t["mult"].sum())) == bucket_shape(inst)


@pytest.mark.parametrize("seed", [1, 2**31 + 17, 2**40 + 3])
def test_every_stretch_of_a_pass_holds_each_bucket_in_proportion(seed):
    from ltsp_bench.drivers import mounts

    kept = mounts.tape_set(config("in2p3-dp"))
    ids = [i for i, _ in kept]
    groups = [tapegen.bucket(len(t["left"]), int(t["mult"].sum())) for _, t in kept]
    of = dict(zip(ids, groups))
    order = tapegen.spread_order(ids, groups, tapegen.seeded(seed, 0))
    assert sorted(order) == ids
    assert order != tapegen.spread_order(ids, groups, tapegen.seeded(seed + 1, 0))
    # before any point x of the pass a group of n keys holds n x + e of
    # them, |e| < 1; so a stretch of `cut` keys strays from its share by
    # less than 1 + share * (number of groups)
    for g in set(groups):
        share = groups.count(g) / len(ids)
        for cut in range(1, len(order) + 1):
            held = sum(of[i] == g for i in order[:cut])
            assert abs(held - share * cut) < 1 + share * len(set(groups))


@pytest.mark.parametrize("seed", [5, 2**31 + 5])
def test_the_check_covers_every_bucket_solved(seed):
    from ltsp_bench import roofline
    from ltsp_bench.drivers import mounts

    tapes = dict(mounts.tape_set(config("in2p3-dp")))
    state = {"tapes": tapes}
    solved = sorted(tapes)[::3]
    run = {"results": {i: None for i in solved}}
    picked = mounts.sample(state, run, seed, 4)
    bucket = {i: tapegen.bucket(len(tapes[i]["left"]), int(tapes[i]["mult"].sum()))
              for i in solved}
    assert {bucket[i] for i in picked} == set(bucket.values())
    assert set(picked) <= set(solved) and picked == sorted(set(picked))
    assert len(picked) == len(set(bucket.values())) + 4
    top = max(solved, key=lambda i: roofline.table_work(
        len(tapes[i]["left"]), int(tapes[i]["mult"].sum()), None, "float64")[0])
    assert top in picked
    assert picked == mounts.sample(state, run, seed, 4)
