"""Column-aligned table printer for CLI output.

Equivalent of reference src/format-table/lib.rs (49 LoC): rows are
tab-separated strings; columns are padded to the widest cell.
"""

from __future__ import annotations

from typing import List


def format_table(rows: List[str]) -> str:
    cells = [r.split("\t") for r in rows]
    if not cells:
        return ""
    ncols = max(len(r) for r in cells)
    widths = [0] * ncols
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    out = []
    for r in cells:
        out.append(
            "  ".join(c.ljust(widths[i]) for i, c in enumerate(r)).rstrip()
        )
    return "\n".join(out)
