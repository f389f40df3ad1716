"""The event loop's delay per scrub batch, in ms: for each of node 0's
batches in the window, the time from its read being ready, and from its
verdicts being delivered, to the worker resuming, summed; the mean over
the batches.

Read by ``harness/spans.py`` from the program's own timeline, drained
whole over the traced window; nothing is read when the drain lost an
event (``dropped`` above 0)."""

from benchmark.harness import spans

LAYER = "the nodes' asyncio event loop"
UNIT = "ms"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "program_span"
NAME = "scrub.loop_delay_ms"

read = spans.reader(NAME)
