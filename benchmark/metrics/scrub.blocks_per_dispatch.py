"""Blocks per codec dispatch on the scrubbing node over the window: the
window's change in its feeder's ``dispatched_blocks`` over its change in
``dispatches`` (``feeder.stats()``)."""

LAYER = "block/repair.py ScrubWorker"
UNIT = "blocks"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "program_counter"


def read(obs):
    pair = obs.get("feeder")
    if pair is None:
        return None
    before, after = pair
    n = after["dispatches"] - before["dispatches"]
    if n <= 0:
        return None
    return (after["dispatched_blocks"] - before["dispatched_blocks"]) / n
