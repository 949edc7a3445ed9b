"""The solve's work is counted from live counts, whatever lays it out."""

import tiny_bench  # noqa: F401

from harness import roofline


def test_solve_work_counts_live_items():
    b, ops = roofline.solve_work(points=80_000, manifolds=25_000,
                                 bodies=20_480, sweeps=20)
    assert b == 80_000 * 152 + 25_000 * 60 + 20_480 * 96
    assert ops == 80_000 * 20 * 187.5
    # dead slots and colors do not enter: the same live counts, the same work
    assert roofline.solve_work(80_000, 25_000, 20_480, 20) == (b, ops)


def test_bound_takes_the_larger_and_names_it():
    ms, by = roofline.bound(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = roofline.bound(1.0, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    assert roofline.share_pct(0.005, 1.0) == 0.5
