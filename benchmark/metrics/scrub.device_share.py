"""Share of the scrubbing node's codec bytes that the card took over the
window, in percent: the window's change in the codec observer's
``bytes_total`` on the device side over its change on both sides."""

LAYER = "ops/hybrid_codec.py"
UNIT = "%"
MOVES = "scrub_gibs"
SOURCE = "program_counter"


def read(obs):
    pair = obs.get("bytes_by_side")
    if pair is None:
        return None
    before, after = pair
    d = {s: after.get(s, 0) - before.get(s, 0) for s in after}
    total = sum(d.values())
    if total <= 0:
        return None
    return 100.0 * d.get("tpu", 0) / total
