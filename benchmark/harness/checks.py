"""The numbers a run compares, each beside its limit."""

from __future__ import annotations

import sys
from typing import Dict


class Checks:
    def __init__(self):
        self.items: Dict[str, dict] = {}

    def at_most(self, name: str, value, limit) -> None:
        self.items[name] = {"value": value, "limit": limit, "holds": "<="}

    def at_least(self, name: str, value, limit) -> None:
        self.items[name] = {"value": value, "limit": limit, "holds": ">="}

    @staticmethod
    def holds(c: dict) -> bool:
        return (c["value"] <= c["limit"] if c["holds"] == "<="
                else c["value"] >= c["limit"])

    def ok(self) -> bool:
        return bool(self.items) and all(map(self.holds, self.items.values()))

    def print_lines(self, stream=sys.stderr) -> None:
        for name, c in self.items.items():
            print(f"check {name}: {c['value']} {c['holds']} {c['limit']} "
                  f"{'ok' if self.holds(c) else 'FAILED'}", file=stream)
        stream.flush()
