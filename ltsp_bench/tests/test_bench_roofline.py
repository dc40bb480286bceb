"""The least-time count against brute-force enumeration of the recurrence."""

import pytest

from ltsp_bench import roofline


def brute_candidates(R: int, span):
    """Every (a, b, c) detour candidate the recurrence folds."""
    count = 0
    for a in range(R):
        for b in range(a + 1, R):
            lo = a + 1 if span is None else max(a + 1, b - span)
            count += sum(1 for _ in range(lo, b + 1))
    return count


@pytest.mark.parametrize("span", [None, 1, 2, 3, 5, 8])
@pytest.mark.parametrize("R", [1, 2, 3, 7, 12, 33])
def test_candidates_match_enumeration(R, span):
    assert roofline.candidates(R, span) == brute_candidates(R, span)


@pytest.mark.parametrize("type_name", ["float64", "float32"])
def test_table_work_counts_the_tapes_own_shape(type_name):
    R, n, item = 9, 40, roofline.ITEM_BYTES[type_name]
    ops, nbytes = roofline.table_work(R, n, None, type_name)
    assert ops == 7 * brute_candidates(R, None) * (n + 1)
    cells = sum(1 for a in range(R) for b in range(a, R)) * (n + 1)
    assert nbytes == cells * (item + 4) + R * (3 * item + 4)
    least = roofline.least_seconds(R, n, None, type_name)
    assert least == max(ops / roofline.PEAK_OPS_PER_S[type_name],
                        nbytes / roofline.HBM_BYTES_PER_S)


def test_policy_span():
    assert roofline.policy_span("dp", 200) is None
    assert roofline.policy_span("logdp1", 200) == 6  # ceil(ln 200)
    assert roofline.policy_span("logdp1", 13) == 3
    assert roofline.policy_span("logdp2", 200) == 11
