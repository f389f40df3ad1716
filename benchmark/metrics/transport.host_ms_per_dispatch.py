"""The host's time per scrub dispatch on node 0, in ms: its ``stage``,
``adopt``, ``submit`` and ``collect`` slot events of scrub work in the
window, summed, over its ``submit scrub`` count (prefetches included).

Read by ``harness/spans.py`` from the program's own timeline, drained
whole over the traced window; nothing is read when the drain lost an
event (``dropped`` above 0)."""

from benchmark.harness import spans

LAYER = "ops/transport.py"
UNIT = "ms"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "program_span"
NAME = "transport.host_ms_per_dispatch"

read = spans.reader(NAME)
