"""The card's idle time in the window during which no node had a span
open, over all its idle time, in percent.

Read by ``harness/spans.py`` from the program's own timeline, drained
whole over the traced window; nothing is read when the drain lost an
event (``dropped`` above 0)."""

from benchmark.harness import spans

LAYER = "device"
UNIT = "%"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "device_trace"
NAME = "device_idle.scrub.unnamed"

read = spans.reader(NAME)
