"""Each kernel's bytes and operations, copied from chip_smoke.py phase 3,
held equal to phase 3's arithmetic on the same numbers (the expressions
below are phase 3's, written out)."""

import math

from kbench.roofline import event_scatter, least_seconds, schedule_cycle, select_cycle_commit


def test_event_scatter_matches_phase_3():
    C, N, P, E, n_valid = 1024, 1713, 8192, 32, 15_000
    assert event_scatter.need(C, N, P, E, n_valid) == (C * E + 16 * n_valid + 2 * C * (5 * N + 12 * P), n_valid)


def test_select_cycle_commit_matches_phase_3():
    C, N, P = 4, 96, 648
    depth = [10, 3, 0, 70]
    picks = [8, 3, 0, 64]
    compares = sum((math.lgamma(d + 1) - math.lgamma(d - k + 1)) / math.log(2) for d, k in zip(depth, picks))
    need = C * P + 12 * sum(depth) + 8 * sum(picks) + 17 * C * N + 16 * sum(picks) + 24 * C * P + 20 * C
    assert select_cycle_commit.need(C, N, P, depth, picks) == (need, int(3 * compares) + 16 * N * sum(picks))


def test_schedule_cycle_matches_phase_3():
    C, N, K, n_live = 1, 1713, 256, 40
    assert schedule_cycle.need(C, N, K, n_live) == (
        9 * C * N + C * K + 8 * n_live + 8 * C * N + 6 * C * K, 16 * N * n_live)


def test_least_time_takes_the_larger_bound():
    assert least_seconds(3.35e12, 0) == 1.0 and least_seconds(0, 67e12) == 1.0
