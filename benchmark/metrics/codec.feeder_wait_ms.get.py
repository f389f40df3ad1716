"""Mean submit-to-dispatch wait of node 0's block hashes in its codec
feeder over the window, in ms (PUT and GET hashes alike): the window's
mean of ``codec_batch_wait_seconds{kind="hash"}`` from node 0's admin
``/metrics``."""

from benchmark.harness import promtext

LAYER = "ops/ codec stack (feeder, hybrid, transport)"
UNIT = "ms"
MOVES = "get_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    return promtext.hist_mean_ms(prom[0], "codec_batch_wait_seconds", kind="hash")
