"""Strict Prometheus text-exposition lint.

The registry in utils/metrics.py IS this project's exporter — there is no
client library between the metric objects and the scrape body, so a
rendering bug (duplicate `# TYPE` from a name collision, an unescaped
label value, a histogram whose cumulative counts go backwards) ships
straight to Prometheus, which rejects the whole scrape at ingest time and
takes every metric on the node dark at once.  This lint runs as a unit
test against a fully-populated registry and inside the smoke script
against a live node's /metrics body.

Checks (a strict subset of the text-exposition format Prometheus
actually enforces, plus this repo's own rendering conventions):

  - metric and label names match the Prometheus grammar
  - no duplicate `# TYPE`/`# HELP` for a family; TYPE precedes samples
  - samples belong to their declared family (histograms may only append
    `_bucket`/`_sum`/`_count`)
  - no duplicate sample (same name + same label set)
  - label values use only the three legal escapes (\\\\, \\", \\n) and
    contain no raw newline/quote
  - non-`le` labels are emitted in sorted order and `le` comes last on
    `_bucket` lines (what metrics.py renders; a violation means a bypass
    of the registry)
  - histogram `le` values are strictly increasing, cumulative bucket
    values are non-decreasing, the `+Inf` bucket exists and equals
    `_count` for the same label set
  - sample values parse as floats
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$"
)
_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}


def _parse_labels(raw: str) -> Optional[List[Tuple[str, str]]]:
    """Parse the inside of {...}; None on malformed input.  Hand-rolled
    scanner because escapes make a regex split unsound."""
    out: List[Tuple[str, str]] = []
    i, n = 0, len(raw)
    while i < n:
        j = raw.find("=", i)
        if j < 0:
            return None
        name = raw[i:j]
        if j + 1 >= n or raw[j + 1] != '"':
            return None
        i = j + 2
        val = []
        while i < n:
            c = raw[i]
            if c == "\\":
                if i + 1 >= n or raw[i + 1] not in ('\\', '"', 'n'):
                    return None  # illegal escape
                val.append(raw[i:i + 2])
                i += 2
                continue
            if c == '"':
                break
            if c == "\n":
                return None
            val.append(c)
            i += 1
        else:
            return None  # unterminated value
        out.append((name, "".join(val)))
        i += 1  # past closing quote
        if i < n:
            if raw[i] != ",":
                return None
            i += 1
    return out


def _unescape(v: str) -> str:
    return (v.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\x00", "\\"))


def _family_of(name: str, types: Dict[str, str]) -> Optional[str]:
    if name in types:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        base = name[: -len(suffix)] if name.endswith(suffix) else None
        if base and types.get(base) in ("histogram", "summary"):
            return base
    return None


def lint_exposition(text: str) -> List[str]:
    """→ list of human-readable violations (empty = clean)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: set = set()
    seen_samples: set = set()
    # (family, non-le label tuple) -> [(le_float, cum_value)]
    buckets: Dict[tuple, List[Tuple[float, float]]] = {}
    counts: Dict[tuple, float] = {}

    if text and not text.endswith("\n"):
        errors.append("exposition does not end with a newline")

    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or parts[3] not in _TYPES:
                errors.append(f"line {ln}: malformed TYPE line: {line!r}")
                continue
            fam = parts[2]
            if fam in types:
                errors.append(f"line {ln}: duplicate # TYPE for {fam!r}")
            if not _METRIC_NAME.match(fam):
                errors.append(f"line {ln}: invalid family name {fam!r}")
            types[fam] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            fam = parts[2] if len(parts) >= 3 else ""
            if fam in helps:
                errors.append(f"line {ln}: duplicate # HELP for {fam!r}")
            helps.add(fam)
            continue
        if line.startswith("#"):
            continue  # free comment

        m = _SAMPLE.match(line)
        if m is None:
            errors.append(f"line {ln}: unparsable sample: {line!r}")
            continue
        name = m.group("name")
        try:
            value = float(m.group("value"))
        except ValueError:
            errors.append(f"line {ln}: non-numeric value on {name}")
            continue
        fam = _family_of(name, types)
        if fam is None:
            errors.append(
                f"line {ln}: sample {name!r} has no preceding # TYPE")
            continue

        raw_labels = m.group("labels")
        labels = _parse_labels(raw_labels) if raw_labels is not None else []
        if labels is None:
            errors.append(f"line {ln}: malformed/ill-escaped labels on {name}")
            continue
        for k, _v in labels:
            if not _LABEL_NAME.match(k):
                errors.append(f"line {ln}: invalid label name {k!r} on {name}")
        non_le = [k for k, _ in labels if k != "le"]
        if non_le != sorted(non_le):
            errors.append(
                f"line {ln}: labels not sorted on {name}: {non_le}")
        if any(k == "le" for k, _ in labels) and labels[-1][0] != "le":
            errors.append(f"line {ln}: 'le' is not the last label on {name}")

        key = (name, tuple(labels))
        if key in seen_samples:
            errors.append(
                f"line {ln}: duplicate sample {name}{{{raw_labels or ''}}}")
        seen_samples.add(key)

        if types.get(fam) == "histogram":
            base_labels = tuple((k, v) for k, v in labels if k != "le")
            if name == fam + "_bucket":
                le_raw = dict(labels).get("le")
                if le_raw is None:
                    errors.append(f"line {ln}: _bucket without le on {name}")
                    continue
                le = (math.inf if _unescape(le_raw) == "+Inf"
                      else float(_unescape(le_raw)))
                buckets.setdefault((fam, base_labels), []).append((le, value))
            elif name == fam + "_count":
                counts[(fam, base_labels)] = value

    for (fam, base), series in buckets.items():
        lbl = "{" + ",".join(f'{k}="{v}"' for k, v in base) + "}"
        les = [le for le, _ in series]
        if les != sorted(les) or len(set(les)) != len(les):
            errors.append(f"{fam}{lbl}: le values not strictly increasing")
        vals = [v for _, v in series]
        if any(b < a for a, b in zip(vals, vals[1:])):
            errors.append(f"{fam}{lbl}: cumulative bucket counts decrease")
        if not les or les[-1] != math.inf:
            errors.append(f"{fam}{lbl}: missing +Inf bucket")
        elif (fam, base) in counts and vals[-1] != counts[(fam, base)]:
            errors.append(f"{fam}{lbl}: +Inf bucket != _count")

    return errors
