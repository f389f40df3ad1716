"""The read-ahead that the previous window's verify did not hide, in ms:
the mean over node 0's ``scrub await_read`` events in the window of
their ``ready_ns`` less their start, at least 0.

Read by ``harness/spans.py`` from the program's own timeline, drained
whole over the traced window; nothing is read when the drain lost an
event (``dropped`` above 0)."""

from benchmark.harness import spans

LAYER = "block/repair.py ScrubWorker"
UNIT = "ms"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "program_span"
NAME = "scrub.read_exposed_ms"

read = spans.reader(NAME)
