"""Lightweight metrics registry — counters, gauges, histograms with
Prometheus text exposition.

Equivalent of the reference's OpenTelemetry metric helpers
(ref util/metrics.rs:8-63) plus the per-layer metric structs
(rpc/metrics.rs:38, table/metrics.rs, block/metrics.rs:7-127,
api/generic_server.rs:63-95).  The reference pushes through the OTel
SDK to its Prometheus exporter; here the registry IS the exporter: every
`System` owns one (`system.metrics`), all layers record into it, and the
admin API renders it (`/metrics`).  No OTel dependency — the sample
model (monotonic counters, label sets, cumulative histogram buckets)
follows the Prometheus exposition format directly.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# latency buckets (seconds), roughly the OTel default boundaries
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)

# histogram exemplars: the max observation per label set is remembered
# for one window, with the trace id that produced it — the link from "a
# p99 bucket grew" to the exact request waterfall to pull
EXEMPLAR_WINDOW_S = 60.0

_trace_id_fn = None


def _current_trace_id():
    """Lazy bridge to utils.tracing.current_trace_id (metrics must not
    import the tracing module at import time — the registry is used by
    bare-library code that never touches spans)."""
    global _trace_id_fn
    if _trace_id_fn is None:
        try:
            from .tracing import current_trace_id as fn
        except Exception:  # pragma: no cover — broken install
            fn = lambda: None  # noqa: E731
        _trace_id_fn = fn
    return _trace_id_fn()


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotonic counter, optionally labelled."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._vals[key] = self._vals.get(key, 0.0) + n

    def get(self, **labels) -> float:
        return self._vals.get(tuple(sorted(labels.items())), 0.0)

    def drop_label(self, name: str, value: str) -> None:
        """Remove every series carrying label ``name == value``.  Used
        when a labelled POPULATION member leaves for good (a peer removed
        from the committed layout): its series would otherwise report a
        frozen count forever, indistinguishable from a live-but-quiet
        node."""
        gone = [k for k in self._vals
                if any(ln == name and lv == value for ln, lv in k)]
        for k in gone:
            del self._vals[k]

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, v in sorted(self._vals.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")
        if not self._vals:
            out.append(f"{self.name} 0")
        return out


class Gauge:
    """Point-in-time value: set directly or observed via a callback at
    render time (the reference's ValueObserver pattern).

    `labeled_fn` is the labelled flavor of `fn`: a callback returning
    an iterable of ({label: value}, sample) pairs, evaluated at render
    time.  It exists for small FIXED populations whose truth lives in
    one object (per-data-root disk state): unlike clear-then-set
    observers it needs no scrape-side refresh hook, so any render() —
    admin /metrics, a test, the CLI — sees current values."""

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None,
                 labeled_fn: Optional[Callable[[], object]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self.labeled_fn = labeled_fn
        self._vals: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, v: float, **labels) -> None:
        self._vals[tuple(sorted(labels.items()))] = v

    def clear(self) -> None:
        """Drop all labelled samples.  Scrape-time observers that mirror a
        MUTABLE population (per-worker, per-peer) clear + repopulate so a
        reaped worker's series disappears instead of freezing at its last
        value."""
        self._vals.clear()

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if self.fn is not None:
            try:
                out.append(f"{self.name} {_num(self.fn())}")
            except Exception:  # noqa: BLE001 — observers must never break scrape
                pass
        if self.labeled_fn is not None:
            try:
                samples = sorted(
                    (tuple(sorted(labels.items())), v)
                    for labels, v in self.labeled_fn()
                )
            except Exception:  # noqa: BLE001 — observers must never break scrape
                samples = []
            for key, v in samples:
                out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")
        for key, v in sorted(self._vals.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")
        return out


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics).

    With ``exemplars=True`` each label set remembers the trace id of its
    max-value observation per EXEMPLAR_WINDOW_S window (the trace id is
    read from the task-local tracing context unless the caller passes
    ``trace_exemplar=``).  The plain text render stays untouched
    (promlint-clean); ``render(openmetrics=True)`` appends the
    OpenMetrics ``# {trace_id="…"} value ts`` exemplar on the holding
    bucket line, and ``exemplar_snapshot()`` serves them to the admin
    CLI."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 exemplars: bool = False):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets)
        self.exemplars = bool(exemplars)
        # labels -> [bucket counts..., +inf count, sum, count]
        self._vals: Dict[Tuple[Tuple[str, str], ...], list] = {}
        # labels -> [window_start, value, bucket_index, trace_id, ts]
        self._exemplars: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def observe(self, v: float, trace_exemplar: Optional[str] = None,
                **labels) -> None:
        key = tuple(sorted(labels.items()))
        slot = self._vals.get(key)
        if slot is None:
            slot = [0] * (len(self.buckets) + 1) + [0.0, 0]
            self._vals[key] = slot
        i = bisect.bisect_left(self.buckets, v)
        slot[i] += 1
        slot[-2] += v
        slot[-1] += 1
        if self.exemplars:
            tid = (trace_exemplar if trace_exemplar is not None
                   else _current_trace_id())
            if tid:
                now = time.time()
                ex = self._exemplars.get(key)
                if (ex is None or now - ex[0] > EXEMPLAR_WINDOW_S
                        or v >= ex[1]):
                    start = (now if ex is None
                             or now - ex[0] > EXEMPLAR_WINDOW_S else ex[0])
                    self._exemplars[key] = [start, v, i, tid, now]

    def exemplar_snapshot(self) -> list:
        """[{labels, value, trace_id, ts}] — current-window max-bucket
        exemplars for every label set."""
        out = []
        for key, (_w, v, _i, tid, ts) in sorted(self._exemplars.items()):
            out.append({"labels": dict(key), "value": round(v, 6),
                        "trace_id": tid, "ts": round(ts, 3)})
        return out

    def time(self, **labels):
        """Context manager recording elapsed seconds (the reference's
        RecordDuration combinator, util/metrics.rs:8-57)."""
        return _Timer(self, labels)

    def quantile(self, q: float, min_count: int = 1,
                 **labels) -> Optional[float]:
        """Estimate the q-quantile for one label set by linear
        interpolation inside the holding bucket (the same estimate
        Prometheus' histogram_quantile() makes at query time — the hedge
        trigger reuses it process-side).  None when the label set has
        fewer than min_count observations; observations in the +Inf
        bucket clamp to the last finite bucket edge."""
        slot = self._vals.get(tuple(sorted(labels.items())))
        if slot is None or slot[-1] < min_count:
            return None
        target = q * slot[-1]
        cum = 0.0
        lo = 0.0
        for i, edge in enumerate(self.buckets):
            c = slot[i]
            if cum + c >= target:
                if c <= 0:
                    return lo
                return lo + (edge - lo) * (target - cum) / c
            cum += c
            lo = edge
        return self.buckets[-1]

    def render(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for key, slot in sorted(self._vals.items()):
            ex = self._exemplars.get(key) if openmetrics else None
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += slot[i]
                lab = key + (("le", _num(b)),)
                line = f"{self.name}_bucket{_fmt_labels(lab)} {cum}"
                if ex is not None and ex[2] == i:
                    line += (f' # {{trace_id="{ex[3]}"}} {_num(ex[1])} '
                             f"{ex[4]:.3f}")
                out.append(line)
            cum += slot[len(self.buckets)]
            lab = key + (("le", "+Inf"),)
            line = f"{self.name}_bucket{_fmt_labels(lab)} {cum}"
            if ex is not None and ex[2] == len(self.buckets):
                line += (f' # {{trace_id="{ex[3]}"}} {_num(ex[1])} '
                         f"{ex[4]:.3f}")
            out.append(line)
            out.append(f"{self.name}_sum{_fmt_labels(key)} {_num(slot[-2])}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {slot[-1]}")
        return out


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)
        return False


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


def maybe_time(hist: Optional[Histogram], **labels):
    """Histogram timer, or a no-op context when the layer runs without a
    metrics registry (tests, bare library use) — keeps hot paths free of
    per-call conditionals."""
    return hist.time(**labels) if hist is not None else _NULL_TIMER


class MetricsRegistry:
    """One per System; layers create their metrics through it and the
    admin endpoint renders everything.

    Families are deduplicated BY NAME: two components asking for the same
    family name share one metric object (several Table instances all
    record into `table_merge_duration_seconds` with their own labels),
    and the exposition never emits duplicate `# TYPE` blocks — Prometheus
    rejects those at scrape time.  Asking for an existing name with a
    different metric type is a programming error and raises."""

    def __init__(self):
        self._metrics: List[object] = []
        self._by_name: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, *args):
        m = self._by_name.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m
        m = cls(name, *args)
        self._by_name[name] = m
        self._metrics.append(m)
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              labeled_fn: Optional[Callable[[], object]] = None) -> Gauge:
        """A second registration of an existing gauge may not pass a
        DIFFERENT observer callback: the first registration's `fn` used to
        win silently, which turned a double-construction bug (two
        components observing through dead instances) into wrong metrics
        instead of a crash.  Per-instance values must use labelled
        `set()`; re-requesting an existing gauge without an observer
        stays valid (that is the sharing path).  The same rule covers
        `labeled_fn` (render-time labelled observers)."""
        m = self._by_name.get(name)
        if m is not None and fn is not None and getattr(m, "fn", None) is not fn:
            raise ValueError(
                f"gauge {name!r} already registered"
                + (" with a different observer callback"
                   if getattr(m, "fn", None) is not None else "")
                + "; a second fn= observer would be silently ignored"
            )
        if (m is not None and labeled_fn is not None
                and getattr(m, "labeled_fn", None) is not labeled_fn):
            raise ValueError(
                f"gauge {name!r} already registered; a second labeled_fn= "
                f"observer would be silently ignored"
            )
        return self._get_or_create(Gauge, name, help, fn, labeled_fn)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  exemplars: bool = False) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets, exemplars)

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition; ``openmetrics=True`` additionally
        appends histogram exemplars (`# {trace_id=…} v ts` bucket-line
        suffixes) — serve that flavor only to scrapers that negotiated
        the OpenMetrics content type (the plain format's parsers reject
        the suffix)."""
        lines: List[str] = []
        for m in self._metrics:
            if openmetrics and isinstance(m, Histogram):
                lines.extend(m.render(openmetrics=True))
            else:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"
