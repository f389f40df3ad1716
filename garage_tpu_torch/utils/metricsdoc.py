"""Metrics-docs lint: every family on /metrics must have a doc row.

The registry is this project's exporter and docs/OBSERVABILITY.md is
its contract with operators — a family that ships without a row there
is a dashboard nobody can read and a playbook nobody can follow.  This
check closes the loop the same way promlint does for the exposition
format: it runs as a unit test against a fully-populated node's render
and against every live node's /metrics in scripts/test_smoke.sh, so an
undocumented family fails CI the day it is introduced.

A family is "documented" when its exact name appears anywhere in the
doc as a backticked token (the convention every metrics table already
follows).  Genuinely internal families go on the explicit allowlist
below — with a reason — instead of silently rotting undocumented.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Set

# Families deliberately kept out of the operator doc.  Keep this SHORT
# and reasoned: the default for a new family is a doc row, not a listing
# here.
ALLOWLIST: Set[str] = {
    # per-test scratch families some suites register on throwaway
    # registries; never rendered by a daemon
    "test_metric",
}

_TYPE_LINE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) ")
_TICKED = re.compile(r"`([a-zA-Z_:][a-zA-Z0-9_:]*)`")


def families_in_exposition(text: str) -> Set[str]:
    """Family names declared by `# TYPE` lines in a scrape body."""
    out = set()
    for line in text.splitlines():
        m = _TYPE_LINE.match(line)
        if m:
            out.add(m.group(1))
    return out


def documented_families(doc_text: str) -> Set[str]:
    """Every backticked identifier in the doc — superset of the family
    names, which is exactly what we need for membership tests."""
    return set(_TICKED.findall(doc_text))


def undocumented_families(exposition: str, doc_text: str,
                          allow: Iterable[str] = ()) -> List[str]:
    """Families present on /metrics but absent from the doc (and not
    allowlisted) — empty means the contract holds."""
    fams = families_in_exposition(exposition)
    doc = documented_families(doc_text)
    extra = set(allow) | ALLOWLIST
    return sorted(f for f in fams if f not in doc and f not in extra)
