"""Mean duration of node 0's block RPCs over the window, in ms, while
two nodes are lost: ``rpc_duration_seconds{endpoint="garage/block"}``
from node 0's admin ``/metrics`` (the gathering of a lost block's
surviving pieces, and the reads of blocks other nodes hold)."""

from benchmark.harness import promtext

LAYER = "rpc/ + model/parity_repair.py + block/repair_plan.py"
UNIT = "ms"
MOVES = "degraded_get_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    return promtext.hist_mean_ms(prom[0], "rpc_duration_seconds",
                                 endpoint="garage/block")
