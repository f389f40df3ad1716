"""Share of the traced window in which the card ran no kernel, copy or
memset, in percent: 1 - (the union of the device intervals of the
``torch.profiler`` trace) / (the window)."""

LAYER = "device"
UNIT = "%"
MOVES = "scrub_gibs"
SOURCE = "device_trace"


def read(obs):
    trace = obs.get("trace")
    if not trace or trace.get("window_s", 0) <= 0 or trace.get("device_events", 0) == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
