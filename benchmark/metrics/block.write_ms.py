"""Mean local block write over the window, in ms, every node together:
the window's change in ``block_write_duration_seconds``'s sum over its
change in count, summed over every node's admin ``/metrics``."""

from benchmark.harness import promtext

LAYER = "block/manager.py"
UNIT = "ms"
MOVES = "put_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    n = sum(promtext.total(p, "block_write_duration_seconds_count") for p in prom)
    if n <= 0:
        return None
    return 1e3 * sum(promtext.total(p, "block_write_duration_seconds_sum")
                     for p in prom) / n
