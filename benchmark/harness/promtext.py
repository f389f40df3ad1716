"""Prometheus text-format samples, and histogram means over a window."""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, Optional, Tuple

Key = Tuple[str, FrozenSet[Tuple[str, str]]]
_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> Dict[Key, float]:
    out: Dict[Key, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        labels = frozenset(_LABEL.findall(m.group(3) or ""))
        try:
            out[(m.group(1), labels)] = float(m.group(4))
        except ValueError:
            continue
    return out


def total(samples: Dict[Key, float], name: str, **match: str) -> float:
    want = set(match.items())
    return sum(v for (n, labels), v in samples.items()
               if n == name and want <= labels)


def delta(before: Dict[Key, float], after: Dict[Key, float]) -> Dict[Key, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def hist_mean_ms(samples: Dict[Key, float], name: str,
                 **match: str) -> Optional[float]:
    """Mean of a histogram's observations in ms (its ``_sum`` over its
    ``_count``); None when it observed nothing."""
    n = total(samples, f"{name}_count", **match)
    if n <= 0:
        return None
    return 1e3 * total(samples, f"{name}_sum", **match) / n
