"""K1 (``blake2s_kernel``, csrc/blake2s.cu) against its roofline, in
percent, over the traced window.

The work counted is what the window's inputs need: the bytes the
scrubbing node sent to the card (the codec observer's device-side
bytes), cut into 64-byte chunks, times the 1,120 32-bit operations of a
BLAKE2s compression, every byte read once.  The time is the sum of K1's
device time in the trace, so a launch that hashes a block again counts
against the share.  The least time is the larger of the bytes over the
card's bandwidth and the operations over its 32-bit integer issue rate
(``harness/roofline.py``).
"""

from benchmark.harness import roofline

LAYER = "kernel csrc/blake2s.cu"
UNIT = "%"
MOVES = "scrub_gibs"
SOURCE = "device_trace"


def read(obs):
    trace, pair = obs.get("trace"), obs.get("trace_bytes_by_side")
    if not trace or pair is None or trace.get("k1_s", 0) <= 0:
        return None
    before, after = pair
    device_bytes = after.get("tpu", 0) - before.get("tpu", 0)
    chunks = device_bytes // roofline.B2S_CHUNK
    ops = chunks * roofline.B2S_OPS_PER_CHUNK
    return roofline.share_percent(ops, device_bytes, trace["k1_s"])
