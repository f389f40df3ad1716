"""The program's own spans beside the device trace: which stage of the
scrub path the card was waiting on.

Each node's codec timeline (``garage_tpu_torch/utils/timeline.py``) is
drained whole over a traced window (``Drain``: anchors and cursors read
beside the window's marker, ``since()`` polled with the window's own
loop, and once more as it closes) and put on the wall clock by the node's anchor.  Every idle instant
of the card in the window then goes to one span: the open span with the
latest start on the scrubbing node (node 0), counting the derived
loop-delay spans from the moment a read-ahead was ready, or a verdict
delivered, to the moment the worker resumed; failing that another node's
(``n1:``, ``n2:``); failing that ``unnamed``.

The profiler's trace is put on the wall clock by the END of the window's
marker (``devtrace.load`` takes its start): the marker is the window's
first profiled range and its entry can take a millisecond, while the
wall clock is read just before its exit.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import devtrace

SCRUBBING = 0  # the node whose ScrubWorker the cell measures
GAP_US = 50_000  # unnamed idle stretches listed one by one from here
READ_DELAY = "loop delay after read"
VERIFY_DELAY = "loop delay after verify"
HOST_STAGES = ("stage scrub", "adopt scrub", "submit scrub", "collect scrub")
# the scrub events whose stamp starts a derived loop-delay span
STAMPS = {"scrub await_read": ("ready_ns", READ_DELAY),
          "scrub verify": ("delivered_ns", VERIFY_DELAY)}


class Drain:
    """Every event of each node's timeline over a window, read as they
    come so that the ring never wraps between two reads.  A program
    whose timeline cannot be read so (no ``since``) gives nothing."""

    def __init__(self, timelines: Sequence):
        self.timelines = list(timelines)
        if not all(hasattr(tl, "since") for tl in self.timelines):
            self.timelines = []
        self.anchors: List[dict] = []
        self.cursors: List[int] = []
        self.events: List[List[dict]] = [[] for _ in self.timelines]
        self.dropped = 0

    def open(self) -> None:
        """At the window's marker: each node's anchor, and its cursor
        (what was recorded before the window is not read)."""
        self.anchors = [tl.anchor() for tl in self.timelines]
        self.cursors = [tl.since(0)[1] for tl in self.timelines]

    def poll(self) -> None:
        for i, tl in enumerate(self.timelines):
            evs, self.cursors[i], lost = tl.since(self.cursors[i])
            self.events[i] += evs
            self.dropped += lost

    def spans(self) -> List[List[dict]]:
        """Each node's spans on the wall clock (``to_wall``), as drained
        by the last ``poll`` (the caller's, at the window's end)."""
        return [to_wall(evs, a, tl.track_names())
                for evs, a, tl in zip(self.events, self.anchors,
                                      self.timelines)]

    def result(self, trace_path: str,
               window: Tuple[float, float]) -> Optional[dict]:
        """``summarize`` over the profiler's trace of the window (its
        wall-clock us, the marker's reading first), with ``dropped``;
        None when there was nothing to drain."""
        if not self.timelines:
            return None
        out = summarize(trace_events(trace_path, window[0]), self.spans(),
                        window)
        out["dropped"] = self.dropped
        return out


def reader(name: str):
    """The ``read`` of a per-layer metric that ``summarize`` computes:
    the metric ``name`` of a traced window's spans, or None when there
    were none or the drain lost an event (``dropped`` above 0)."""
    def read(obs):
        sp = obs.get("spans")
        if not sp or sp.get("dropped", 1) > 0:
            return None
        return sp["metrics"].get(name)
    return read


def trace_events(path: str, mark_wall_us: float) -> List[dict]:
    """The profiler trace's complete events on the wall clock (us),
    aligned by the end of the window's marker."""
    events = devtrace.load(path, mark_wall_us)
    mark = next(e for e in events if e.get("name") == devtrace.MARK)
    return [dict(e, ts=e["ts"] - mark["dur"]) for e in events]


def to_wall(events: Iterable[dict], anchor: dict,
            tracks: Dict[int, str]) -> List[dict]:
    """The duration events of one timeline as spans on the wall clock
    (us): ``name``, ``track``, ``start``, ``end``, ``args``; a scrub
    ``await_read`` or ``verify`` also gets ``stamp``, its ``ready_ns`` or
    ``delivered_ns`` on the wall clock, and is followed by its derived
    loop-delay span."""
    off = (anchor["wall_ns"] - anchor["mono_ns"]) / 1e3
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = e["ts"] + off, e["ts"] + e["dur"] + off
        args = e.get("args", {})
        span = {"name": e["name"], "track": tracks.get(e["tid"], ""),
                "start": a, "end": b, "args": args}
        out.append(span)
        key, derived = STAMPS.get(e["name"], (None, None))
        if key and args.get(key):
            span["stamp"] = args[key] / 1e3 + off
            # the worker waited on the loop from the stamp (not before
            # its own await began) to its resume
            c = max(a, span["stamp"])
            if c < b:
                out.append({"name": derived, "track": "scrub", "start": c,
                            "end": b, "args": args})
    return out


def idle_intervals(events: List[dict],
                   window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The card's idle intervals inside the window: its complement of
    the union of kernel, copy and memset intervals."""
    lo, hi = window
    busy = devtrace.union([
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
        for e in devtrace.device_events(events)
        if e["ts"] < hi and e["ts"] + e["dur"] > lo])
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def attribute(idle: List[Tuple[float, float]], nodes: List[List[dict]],
              unnamed: Optional[list] = None) -> Dict[str, float]:
    """{label: idle seconds}: each idle instant to the open span with the
    latest start on node ``SCRUBBING``, else on another node (its label
    prefixed ``n<i>:``), else ``unnamed``, whose stretches (wall us) are
    appended to ``unnamed`` when given."""
    order = [SCRUBBING] + [i for i in range(len(nodes)) if i != SCRUBBING]
    cand = []  # (start, end, rank, label)
    for rank, i in enumerate(order):
        pre = "" if i == SCRUBBING else f"n{i}:"
        cand += [(s["start"], s["end"], rank, pre + s["name"])
                 for s in nodes[i] if s["end"] > s["start"]]
    cand.sort()
    points = sorted({p for a, b in idle for p in (a, b)}
                    | {p for s, e, _r, _l in cand for p in (s, e)})
    heaps: List[list] = [[] for _ in order]  # (-start, end, label)
    out: Dict[str, float] = {}
    j = k = 0
    for a, b in zip(points, points[1:]):
        while j < len(cand) and cand[j][0] <= a:
            s, e, rank, label = cand[j]
            heapq.heappush(heaps[rank], (-s, e, label))
            j += 1
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        if k == len(idle) or idle[k][0] > a:
            continue  # the card is busy over [a, b]
        label = "unnamed"
        for h in heaps:
            while h and h[0][1] <= a:
                heapq.heappop(h)
            if h:
                label = h[0][2]
                break
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
        if label == "unnamed" and unnamed is not None:
            if unnamed and unnamed[-1][1] == a:
                unnamed[-1] = (unnamed[-1][0], b)
            else:
                unnamed.append((a, b))
    return out


def neighbours(gap: Tuple[float, float], spans: List[dict]) -> List[str]:
    """The span that ended last before the gap and the one that started
    first after it (``""`` where there is none)."""
    a, b = gap
    before = max((s for s in spans if s["end"] <= a), default=None,
                 key=lambda s: s["end"])
    after = min((s for s in spans if s["start"] >= b), default=None,
                key=lambda s: s["start"])
    return [s["name"] if s else "" for s in (before, after)]


def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def scrub_metrics(spans: List[dict], unnamed_s: float,
                  idle_s: float) -> Dict[str, Optional[float]]:
    """The four per-layer numbers, in ms and %, from the scrubbing
    node's spans that start in the window: the read-ahead the previous
    verify did not hide (mean over ``await_read``), the loop's delay per
    batch (its two derived spans), the host's time per dispatch, and the
    card's idle time with no open span on any node."""
    exposed = [max(0.0, s["stamp"] - s["start"]) / 1e3 for s in spans
               if s["name"] == "scrub await_read" and "stamp" in s]
    delay: Dict[int, float] = {}
    for s in spans:
        if s["track"] != "scrub":
            continue
        b = s["args"].get("batch")
        if s["name"] in ("scrub await_read", "scrub verify"):
            delay.setdefault(b, 0.0)
        elif s["name"] in (READ_DELAY, VERIFY_DELAY):
            delay[b] = delay.get(b, 0.0) + (s["end"] - s["start"]) / 1e3
    host = [s for s in spans if s["track"].startswith("slot")
            and s["name"] in HOST_STAGES]
    submits = sum(1 for s in host if s["name"] == "submit scrub")
    return {
        "scrub.read_exposed_ms": _mean(exposed),
        "scrub.loop_delay_ms": _mean(list(delay.values())),
        "transport.host_ms_per_dispatch": (
            sum(s["end"] - s["start"] for s in host) / 1e3 / submits
            if submits else None),
        "device_idle.scrub.unnamed": (100.0 * unnamed_s / idle_s
                                      if idle_s > 0 else None),
    }


def slot_seconds(spans: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in spans:
        if s["track"].startswith("slot"):
            out[s["name"]] = out.get(s["name"], 0.0) + (s["end"] - s["start"]) * 1e-6
    return out


def throttle_seconds(spans: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in spans:
        if s["name"] == "scrub throttle":
            k = s["args"].get("signal", "")
            out[k] = out.get(k, 0.0) + (s["end"] - s["start"]) * 1e-6
    return out


def summarize(events: List[dict], nodes: List[List[dict]],
              window: Tuple[float, float]) -> dict:
    lo, hi = window
    idle = idle_intervals(events, window)
    idle_s = sum(b - a for a, b in idle) * 1e-6
    clipped = [[dict(s, start=max(s["start"], lo), end=min(s["end"], hi))
                for s in spans if s["end"] > lo and s["start"] < hi]
               for spans in nodes]
    gaps: list = []
    by_span = attribute(idle, clipped, gaps)
    unnamed = by_span.get("unnamed", 0.0)
    own = [s for s in nodes[SCRUBBING] if lo <= s["start"] < hi]
    return {"idle_s": idle_s,
            "idle_by_span": sorted(([k, v] for k, v in by_span.items()),
                                   key=lambda kv: -kv[1]),
            # [seconds into the window, seconds, node 0's span before,
            # node 0's span after] of each unnamed stretch of 50 ms or more
            "unnamed_gaps": [[(a - lo) * 1e-6, (b - a) * 1e-6]
                             + neighbours((a, b), nodes[SCRUBBING])
                             for a, b in gaps if b - a >= GAP_US],
            # node 0's seconds in each slot event: with idle_by_span,
            # how much of a stage the card sat idle through
            "slot_s": slot_seconds(own),
            # the load governor's pauses of node 0's scrub, by the
            # signal that pressed hardest
            "throttle_s": throttle_seconds(own),
            "metrics": scrub_metrics(own, unnamed, idle_s),
            "events": sum(len(s) for s in nodes)}
