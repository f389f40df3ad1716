"""The scrub's rate over the window in GiB/s: the bytes of its whole
passes over its time, their heals included, on the host's clock.

It follows the host's speed, which drifts between runs on one machine
by more than an end-to-end bound may hold, so it is read here, beside
the card's time per GiB that the cell holds to its bound."""

LAYER = "block/repair.py ScrubWorker"
UNIT = "GiB/s"
MOVES = "scrub_card_ms_per_gib"
SOURCE = "host_clock"


def read(obs):
    gibs = obs.get("window_gibs")
    return gibs if gibs else None
