"""Incident flight recorder — one-call diagnostic bundles.

When an incident happens the evidence is ephemeral: the retained
waterfalls rotate, the device timeline ring wraps, breaker and governor
state heal themselves, gossip forgets.  By the time a human looks, the
system has already recovered — or the interesting 30 seconds have been
overwritten.  The flight recorder closes that gap: a single ``capture``
call walks a registry of *collectors* (metrics snapshot, retained
waterfalls, device timeline, breaker/disk/governor/gate state, the
gossiped peer table, recent event rings, SLO budgets) and writes ONE
JSON bundle to ``<metadata_dir>/incidents/``.

Triggered three ways:

  - **automatically** (``trigger``) on fast-burn SLO breaches
    (utils/slo.py), fail-slow flag transitions (utils/health_score.py)
    and disk/cluster state degradation — debounced so a breach that
    fires every bucket produces ONE bundle per ``debounce_s``, and the
    retention bound (``max_bundles``, oldest deleted first) means an
    incident storm can never fill the metadata disk;
  - **manually** via admin ``incident_capture`` / CLI ``incident
    capture`` / ``scripts/incident_dump.py`` (manual captures skip the
    debounce — an operator asking for a snapshot always gets one);
  - from tests, with injectable clocks.

Collector failures are recorded IN the bundle (``{"error": ...}``),
never raised: a capture triggered by a sick subsystem must not die of
the same sickness it is documenting.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("garage_tpu_torch.flightrec")

SCHEMA = "garage_tpu.incident/1"

# bundle filenames: incident-<epoch_ms>-<seq>-<reason>.json (reason
# slugged; seq = process-monotonic same-millisecond disambiguator)
_SLUG_OK = "abcdefghijklmnopqrstuvwxyz0123456789_-"


def _slug(reason: str) -> str:
    s = "".join(c if c in _SLUG_OK else "-" for c in str(reason).lower())
    return s[:48] or "incident"


class FlightRecorder:
    """One per node (model/garage.py wires the collectors)."""

    def __init__(self, dir_path: str, node_id: str = "",
                 max_bundles: int = 16, debounce_s: float = 60.0,
                 metrics=None,
                 clock: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic):
        self.dir = dir_path
        self.node_id = node_id
        self.max_bundles = max(1, int(max_bundles))
        self.debounce_s = float(debounce_s)
        self.clock = clock
        self.mono = mono
        self.collectors: Dict[str, Callable[[], Any]] = {}
        self._last_auto_at: Optional[float] = None  # monotonic
        self._capturing = False
        self._seq = itertools.count()  # same-ms filename disambiguator
        self.captures = 0
        self.suppressed = 0
        if metrics is not None:
            self._m_captures = metrics.counter(
                "incident_capture_total",
                "Flight-recorder bundles written, by trigger")
            self._m_suppressed = metrics.counter(
                "incident_suppressed_total",
                "Auto incident triggers suppressed by the debounce "
                "window (a bundle for the same storm already exists)")
            metrics.gauge(
                "incident_bundles_retained",
                "Incident bundles currently on disk (bounded by the "
                "retention limit, oldest deleted first)",
                fn=lambda: float(len(self._bundle_files())))
        else:
            self._m_captures = self._m_suppressed = None

    # --- collector registry ----------------------------------------------

    def add_collector(self, name: str, fn: Callable[[], Any]) -> None:
        self.collectors[name] = fn

    # --- capture ----------------------------------------------------------

    def trigger(self, reason: str, detail: Optional[dict] = None
                ) -> Optional[str]:
        """The AUTO path: debounced.  Returns the bundle path, or None
        when suppressed (a bundle for the current storm already exists)
        or deferred (see below).

        Auto triggers fire from hot paths — a fast-burn breach fires
        inside a request handler, a fail-slow flip inside peer-rank's
        health view.  Under a running event loop the collectors run
        inline (the caller IS the loop, so loop-owned state is read
        race-free, at Prometheus-scrape cost) but the expensive
        serialize + disk write happens on a short-lived worker thread
        (the node is already degraded; stalling every in-flight request
        to write the evidence would deepen the incident being
        documented).  Without a loop (tests, scripts) the whole capture
        runs inline and the path is returned."""
        now = self.mono()
        if self._capturing or (
                self._last_auto_at is not None
                and now - self._last_auto_at < self.debounce_s):
            # _capturing: a collector observed a NEW transition while a
            # capture was already assembling (e.g. the metrics render's
            # health-score sweep flips a fail-slow flag) — the bundle
            # being written documents that same storm; without the
            # guard the nested trigger would assemble a second full
            # bundle inline, inside its own collector
            self.suppressed += 1
            if self._m_suppressed is not None:
                self._m_suppressed.inc()
            logger.debug("incident trigger %r suppressed (debounce)", reason)
            return None
        self._last_auto_at = now
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            try:
                return self.capture(reason, detail=detail, trigger="auto")
            except Exception:
                # a failed WRITE must not consume the debounce window:
                # the incident most likely to break the write (a dying
                # metadata disk) is the one that must keep retrying on
                # its next trigger instead of ending with zero bundles.
                # Compare-and-swap: only roll back OUR stamp — a newer
                # trigger's window must not be clobbered
                if self._last_auto_at == now:
                    self._last_auto_at = None
                raise
        # under a running loop: collect HERE (the caller's thread IS
        # the loop, so collectors see loop-owned dicts race-free; the
        # walk is scrape-grade — metrics.render runs on the loop at
        # every Prometheus scrape already) and push only the expensive
        # serialize + disk write to a worker thread
        bundle = self.collect(reason, detail=detail, trigger="auto")
        threading.Thread(
            target=self._write_logged, args=(bundle, now),
            name="incident-write", daemon=True).start()
        return None

    def _write_logged(self, bundle: dict, stamp: float) -> None:
        from .cpuprof import register_thread, unregister_thread
        register_thread("incident-write")
        try:
            self.write(bundle)
        except Exception:  # noqa: BLE001 — an unwritable dir, already logged
            # roll back the debounce window, but only OUR stamp (a slow
            # failing write must not clobber a newer trigger's window)
            if self._last_auto_at == stamp:
                self._last_auto_at = None
            logger.exception("deferred incident write failed (%s)",
                             bundle.get("reason"))
        finally:
            unregister_thread()

    def capture(self, reason: str, detail: Optional[dict] = None,
                trigger: str = "manual") -> str:
        """Assemble + write one bundle; returns its path.  Never raises
        on collector failure (recorded per-section instead); only an
        unwritable incidents directory propagates.  Collectors run on
        the CALLING thread — call from the event loop (or split it
        yourself: ``collect`` on the loop, ``write`` off it, as the
        admin handler and the auto trigger do) so they see loop-owned
        state race-free."""
        return self.write(self.collect(reason, detail=detail,
                                       trigger=trigger))

    def collect(self, reason: str, detail: Optional[dict] = None,
                trigger: str = "manual") -> dict:
        """Walk the collectors into a bundle dict (no I/O).  A failing
        collector is recorded as its section's ``{"error": ...}``."""
        sections: Dict[str, Any] = {}
        self._capturing = True
        try:
            for name, fn in self.collectors.items():
                try:
                    sections[name] = fn()
                except Exception as e:  # noqa: BLE001 — document the sickness
                    sections[name] = {"error": f"{type(e).__name__}: {e}"}
        finally:
            self._capturing = False
        ts = self.clock()
        return {
            "schema": SCHEMA,
            "captured_at": round(ts, 3),
            "node_id": self.node_id,
            "trigger": trigger,
            "reason": str(reason),
            "detail": detail or {},
            # header copy of the section names: every scalar a listing
            # needs sits BEFORE the (potentially MBs-large) sections
            # payload, so bundles() can parse a bounded prefix
            "section_list": sorted(sections),
            "sections": sections,
        }

    def write(self, bundle: dict) -> str:
        """Serialize + write a collected bundle (the expensive half —
        safe on a worker thread: touches no shared mutable state beyond
        the counters).  The filename carries a process-monotonic
        sequence so two captures in the same wall-clock millisecond
        (concurrent manual requests) never overwrite each other."""
        os.makedirs(self.dir, exist_ok=True)
        name = (f"incident-{int(bundle['captured_at'] * 1000)}-"
                f"{next(self._seq):03d}-{_slug(bundle['reason'])}.json")
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=_json_default)
        os.replace(tmp, path)
        self.captures += 1
        if self._m_captures is not None:
            self._m_captures.inc(trigger=bundle["trigger"])
        self._enforce_retention()
        logger.info("incident bundle written: %s (%s)", path,
                    bundle["reason"])
        return path

    # --- retention / listing ----------------------------------------------

    def _bundle_files(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(
            os.path.join(self.dir, n) for n in names
            if n.startswith("incident-") and n.endswith(".json")
        )

    def _enforce_retention(self) -> None:
        files = self._bundle_files()
        for p in files[:max(0, len(files) - self.max_bundles)]:
            try:
                os.remove(p)
            except OSError:
                pass

    def bundles(self) -> List[dict]:
        """[{path, reason, trigger, captured_at, sections}] newest last
        — the admin ``incident_list`` payload (headers only, never the
        full sections: a listing must stay cheap).  Only a bounded
        prefix of each file is read and parsed: ``capture`` writes all
        the scalar header fields (and a ``section_list`` copy of the
        section names) before the large ``sections`` payload, so the
        prefix is cut at the ``"sections"`` key and re-closed; anything
        that defeats the cut (hand-edited bundle) falls back to a full
        parse."""
        out = []
        for p in self._bundle_files():
            row = {"path": p, "reason": None}
            head = None
            try:
                with open(p) as f:
                    prefix = f.read(16384)
                cut = prefix.find('"sections"')
                if cut != -1:
                    try:
                        head = json.loads(
                            prefix[:cut].rstrip().rstrip(",") + "}")
                    except ValueError:
                        head = None
                if head is None:
                    with open(p) as f:
                        head = json.load(f)
            except (OSError, ValueError):
                out.append(row)
                continue
            row.update({
                "reason": head.get("reason"),
                "trigger": head.get("trigger"),
                "captured_at": head.get("captured_at"),
                "sections": (head.get("section_list")
                             or sorted((head.get("sections") or {}).keys())),
            })
            out.append(row)
        return out


def _json_default(o):
    """Bundles hold whatever the collectors return: bytes become hex,
    everything else its repr — a capture must never die of a non-JSON
    value."""
    if isinstance(o, (bytes, bytearray)):
        return bytes(o).hex()
    return repr(o)
