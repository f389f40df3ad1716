"""The open-loop generator and the tail it reports."""

import asyncio
import math
import time

import numpy as np

from benchmark.harness import openloop


def test_due_times_count_is_fixed_by_rate_and_window():
    for seed in (1, 2, 3):
        d = openloop.due_times(np.random.default_rng(seed), 12.0, 30.0)
        assert len(d) == 360 and np.all(np.diff(d) >= 0)
        assert 0.0 <= d[0] and d[-1] < 30.0


def test_latency_runs_from_the_due_time_so_a_stall_delays_later_requests():
    """Request 2 blocks the loop for 0.3 s; requests due during the stall
    are sent late, and their latencies include the wait."""
    dues = np.array([0.0, 0.05, 0.10, 0.15, 0.20, 0.25, 0.60])

    async def send(i, rec):
        if i == 2:
            time.sleep(0.3)  # a stall of the whole loop
        await asyncio.sleep(0.01)
        return True

    recs = asyncio.run(openloop.run(dues, send))
    lat = [r.latency for r in recs]
    assert all(r.ok for r in recs)
    assert lat[0] < 0.1 and lat[1] < 0.1
    # due inside the stall: sent only when it ended, timed from the due time
    assert lat[3] > 0.2 and lat[4] > 0.15 and lat[5] > 0.1
    assert recs[3].sent - recs[3].due > 0.2
    assert lat[6] < 0.1
    assert openloop.lateness(recs)["max_ms"] > 200


def test_a_failed_request_counts_as_failed():
    async def send(i, rec):
        if i == 1:
            raise OSError("refused")
        return i != 2

    recs = asyncio.run(openloop.run(np.array([0.0, 0.0, 0.0]), send))
    assert [r.ok for r in recs] == [True, False, False]
    assert "refused" in recs[1].detail["error"]


def test_tail_is_nearest_rank_over_all_requests_failures_infinite():
    xs = [i / 1000 for i in range(1, 101)]
    assert openloop.tail_ms(xs) == 95.0
    assert openloop.tail_ms(xs[:94] + [math.inf] * 6) == math.inf
    assert openloop.tail_ms(xs[:95] + [math.inf] * 5) == 95.0
    assert math.isnan(openloop.tail_ms([]))
