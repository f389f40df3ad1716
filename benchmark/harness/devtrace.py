"""Device time from a ``torch.profiler`` (CUPTI) trace.

The profiler's Chrome-trace export lists each kernel, copy and memset
the card ran as an event with a start and a duration in microseconds.
``load`` puts them on the wall clock by the window's opening marker (a
``record_function`` range whose wall-clock time the window recorded), so
that the traces of several processes on one card line up.  From those: the time the card was busy (the union of the
intervals), the operations that took most of it, and the longest gaps
in which the card was idle, each named by what the host was doing
(``harness/hoststacks.py``).
"""

from __future__ import annotations

import json
from typing import Callable, Iterable, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
MARK = "bench.window_open"


def load(path: str, mark_wall_us: float) -> List[dict]:
    """The trace's complete events, their ``ts`` in wall-clock us, given
    the wall-clock time of the opening marker."""
    with open(path) as f:
        data = json.load(f)
    done = [e for e in data["traceEvents"]
            if e.get("ph") == "X" and "ts" in e and "dur" in e]
    mark = next(e["ts"] for e in done if e.get("name") == MARK)
    return [dict(e, ts=e["ts"] - mark + mark_wall_us) for e in done]


def device_events(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_seconds(dev: List[dict]) -> float:
    return 1e-6 * sum(b - a for a, b in union(
        [(e["ts"], e["ts"] + e["dur"]) for e in dev]))


def kernel_seconds(dev: List[dict], needle: str) -> float:
    return 1e-6 * sum(e["dur"] for e in dev if e.get("cat") == "kernel"
                      and needle in e["name"])


def top_ops(dev: List[dict], top: int = 10) -> List[list]:
    """[name, device seconds] of the operations that took most time."""
    by: dict = {}
    for e in dev:
        by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(dev: List[dict], window: Tuple[float, float],
              label: Optional[Callable[[float, float], str]] = None,
              top: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the longest idle gaps of
    the card inside ``window`` (wall-clock us); ``dev`` lies inside it."""
    lo, hi = window
    edges = [(lo, lo)] + union([(e["ts"], e["ts"] + e["dur"])
                                for e in dev]) + [(hi, hi)]
    gaps = [(c - b, b, c) for (_a, b), (c, _d) in zip(edges, edges[1:]) if c > b]
    gaps.sort(reverse=True)
    return [[label(b, c) if label else "host", g * 1e-6]
            for g, b, c in gaps[:top]]


def reduce(events: List[dict], window: Tuple[float, float],
           label: Optional[Callable[[float, float], str]] = None) -> dict:
    """busy seconds, the breakdown and K1's device seconds of the trace
    of a window (wall-clock us)."""
    lo, hi = window
    dev = []
    for e in device_events(events):
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            dev.append(dict(e, ts=a, dur=b - a))
    return {"busy_s": busy_seconds(dev), "window_s": (hi - lo) * 1e-6,
            "device_ops": top_ops(dev),
            "idle_gaps": idle_gaps(dev, window, label),
            "k1_s": kernel_seconds(dev, "blake2s_kernel"),
            "device_events": len(dev)}
