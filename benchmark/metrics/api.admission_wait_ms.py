"""Mean wait at node 0's S3 admission gate per request over the window,
in ms: the window's change in the sum of
``api_admission_queue_wait_seconds`` (observed for requests that queued)
over its change in ``api_admission_total`` (every verdict), from node
0's admin ``/metrics``.  A request that never queued adds 0."""

from benchmark.harness import promtext

LAYER = "api/ S3 front end (api/admission.py)"
UNIT = "ms"
MOVES = "put_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    n = promtext.total(prom[0], "api_admission_total")
    if n <= 0:
        return None
    return 1e3 * promtext.total(prom[0], "api_admission_queue_wait_seconds_sum") / n
