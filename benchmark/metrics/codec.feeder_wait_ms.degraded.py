"""Mean submit-to-dispatch wait of node 0's decodes in its codec feeder
over the window, in ms: ``codec_batch_wait_seconds{kind="decode"}``
from node 0's admin ``/metrics``."""

from benchmark.harness import promtext

LAYER = "ops/ codec stack (feeder, hybrid, transport)"
UNIT = "ms"
MOVES = "degraded_get_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    return promtext.hist_mean_ms(prom[0], "codec_batch_wait_seconds",
                                 kind="decode")
