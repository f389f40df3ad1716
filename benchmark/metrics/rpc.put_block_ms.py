"""Mean duration of node 0's block RPCs over the window, in ms: the
window's mean of ``rpc_duration_seconds{endpoint="garage/block"}`` from
node 0's admin ``/metrics``.  Node 0 holds every block of the replicated
deployment, so its block RPCs are the pushes of written blocks to the
other nodes; in the erasure-coded one, the pushes of blocks and parity
pieces to their nodes."""

from benchmark.harness import promtext

LAYER = "rpc/, net/ (replica and piece RPC)"
UNIT = "ms"
MOVES = "put_p95_ms"
SOURCE = "program_counter"


def read(obs):
    prom = obs.get("prom")
    if not prom:
        return None
    return promtext.hist_mean_ms(prom[0], "rpc_duration_seconds",
                                 endpoint="garage/block")
