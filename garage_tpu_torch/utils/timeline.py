"""Timeline — a bounded ring of timestamped events, exportable as
Chrome-trace (catapult) JSON.

The device/transport pipeline's overlap claims (double-buffered staging,
EDF foreground-first dispatch) were only ever *inferred* from counters;
this ring records the actual begin/end of every stage — enqueue, EDF
pop, per-slot staging, device submit, collect — so `chrome://tracing`
(or Perfetto) renders the pipeline as it ran and "did slot 1 stage while
slot 0 computed" is a picture, not an argument.

Always on, bounded (`maxlen` events, each a small dict), one lock.
Producers are the scrub worker, the codec feeder and the device
transport via the shared CodecObserver (`obs.timeline`); consumers are
the admin `device_timeline` command, the HTTP `/v1/timeline` endpoint,
`tools/device_timeline.py`, and readers that drain the ring with
`since()` so that a window longer than the ring arrives whole.

Events are numbered in the order they were recorded; `since(cursor)`
returns those after a cursor and counts the ones the ring evicted
before they were read.  `anchor()` pairs the wall clock with the
monotonic clock the events are stamped on, so an export lines up with
another trace on the wall clock (a `torch.profiler` trace, a request's
waterfall).  A submitter that wants its work followed across threads
sets a `Src` (`submitting`): the feeder item and the transport batches
made from that work carry its id as `src`.

Chrome-trace mapping: duration events are phase "X" (ts + dur, µs),
instants are "i", counters are "C".  Tracks ("tid") are stable small
integers assigned per track name, with thread_name metadata events so
the UI shows "slot0", "edf", "feeder" instead of numbers.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

DEFAULT_SIZE = 8192


def anchor() -> dict:
    """The wall clock (``time_ns``) beside the monotonic clock the events
    are stamped on: the narrowest of three back-to-back readings, the
    monotonic time taken as the middle of its bracket.  An event at
    monotonic ``t`` ns happened at wall ``t + wall_ns - mono_ns``."""
    best = None
    for _ in range(3):
        m0 = time.monotonic_ns()
        wall = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[2]:
            best = (wall, (m0 + m1) // 2, m1 - m0)
    return {"wall_ns": best[0], "mono_ns": best[1], "bracket_ns": best[2]}


class Src:
    """One submitter's unit of work (a scrub batch): ``id`` is what the
    feeder item and the transport batches made from it carry as
    ``src``; ``delivered_ns`` is the monotonic moment the feeder or the
    transport resolved its result (0 until then)."""

    __slots__ = ("id", "delivered_ns")

    def __init__(self, id: int):
        self.id = int(id)
        self.delivered_ns = 0

    def delivered(self, _future=None) -> None:
        """A future's done-callback: runs in the resolving thread."""
        self.delivered_ns = time.monotonic_ns()


_src: contextvars.ContextVar[Optional[Src]] = contextvars.ContextVar(
    "garage_tpu_timeline_src", default=None)


def current_src() -> Optional[Src]:
    return _src.get()


def src_ids(items) -> List[int]:
    """The submitters' batch ids among work items (their ``src``), the
    ``src`` of an event about them."""
    return sorted({i for i in (getattr(it, "src", None) for it in items)
                   if i is not None})


@contextlib.contextmanager
def submitting(src: Src) -> Iterator[Src]:
    """Work submitted inside the block (this task, and the threads it
    hands work to) carries ``src``."""
    token = _src.set(src)
    try:
        yield src
    finally:
        _src.reset(token)


class Timeline:
    def __init__(self, size: int = DEFAULT_SIZE):
        self._ring: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self._tracks: Dict[str, int] = {}
        self.dropped = 0  # events evicted by the ring bound

    def _track(self, name: str) -> int:
        tid = self._tracks.get(name)
        if tid is None:
            tid = self._tracks[name] = len(self._tracks) + 1
        return tid

    def event(self, name: str, track: str, start_ns: int,
              end_ns: Optional[int] = None, cat: str = "transport",
              **args) -> None:
        """Duration event [start_ns, end_ns] (monotonic_ns), or an
        instant when end_ns is None."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X" if end_ns is not None else "i",
            "ts": start_ns // 1000,  # chrome wants µs
            "pid": 1,
        }
        if end_ns is not None:
            ev["dur"] = max(0, (end_ns - start_ns) // 1000)
        else:
            ev["s"] = "t"  # instant scope: thread
        if args:
            ev["args"] = args
        self._append(ev, track)

    def counter(self, name: str, start_ns: int, **values) -> None:
        """Counter sample (stacked area in the trace viewer) — queue
        depths, slot occupancy."""
        ev = {"name": name, "cat": "counter", "ph": "C",
              "ts": start_ns // 1000, "pid": 1,
              "args": {k: float(v) for k, v in values.items()}}
        self._append(ev, "counters")

    def _append(self, ev: dict, track: str) -> None:
        with self._lock:
            ev["tid"] = self._track(track)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def since(self, cursor: int = 0) -> Tuple[List[dict], int, int]:
        """(the events recorded after ``cursor``, the cursor after them,
        how many of those the ring evicted before this read).  Event n
        (from 1) is the n-th recorded; the ring holds the events after
        ``dropped``, so a reader that calls again with the returned
        cursor before the ring wraps reads every event once."""
        with self._lock:
            first, held = self.dropped, len(self._ring)
            # from the newest end: a poll costs the events it returns
            new = max(0, min(held, first + held - cursor))
            events = list(itertools.islice(reversed(self._ring), new))
        events.reverse()
        return events, first + held, max(0, first - cursor)

    def track_names(self) -> Dict[int, str]:
        """tid -> track name."""
        with self._lock:
            return {tid: name for name, tid in self._tracks.items()}

    anchor = staticmethod(anchor)

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit > 0:
            out = out[-limit:]
        return out

    def chrome_trace(self, limit: Optional[int] = None) -> dict:
        """The catapult JSON object: sorted traceEvents plus
        process/thread metadata so tracks render with their names."""
        events = sorted(self.snapshot(limit), key=lambda e: e["ts"])
        meta: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "garage_tpu_torch device pipeline"},
        }]
        for tid, name in sorted(self.track_names().items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": name}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "garage_tpu_torch",
                "captured_at": round(time.time(), 3),
                "dropped_events": self.dropped,
                # ts + (wall_ns - mono_ns) / 1000 = wall-clock us
                "anchor": anchor(),
            },
        }


def overlapping_slot_windows(chrome: dict) -> int:
    """Count pairs of phase-X events on DISTINCT slot tracks whose time
    windows overlap — the smoke/test assertion that the double buffer
    actually overlapped staging with compute (≥ 1 pair means two slots
    were concurrently occupied)."""
    slots: Dict[int, list] = {}
    names = {}
    for ev in chrome.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    for ev in chrome.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        track = names.get(ev.get("tid"), "")
        if not str(track).startswith("slot"):
            continue
        slots.setdefault(ev["tid"], []).append(
            (ev["ts"], ev["ts"] + ev.get("dur", 0)))
    pairs = 0
    tids = sorted(slots)
    for i, a in enumerate(tids):
        for b in tids[i + 1:]:
            for s0, e0 in slots[a]:
                if any(s0 < e1 and s1 < e0 for s1, e1 in slots[b]):
                    pairs += 1
                    break
    return pairs
