"""What a scrub of a replicated node must leave behind.

A scrub pass walks the store in the order of the hashes' first two bytes
(the ``xx/yy`` directories), so the blocks it has judged by the time it
stops are those whose two-byte prefix lies in the ranges it covered.  Of
those, every copy planted bad must have been set aside (``.corrupted``)
and fetched again from a replica; no good copy may have been set aside;
and every file left under a name must hash to it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple


def prefix(digest: bytes) -> int:
    return (digest[0] << 8) | digest[1]


def covered(digests: Iterable[bytes],
            ranges: Sequence[Tuple[int, int]]) -> Set[bytes]:
    """The digests whose prefix lies in one of the half-open ranges."""
    return {d for d in digests
            if any(lo <= prefix(d) < hi for lo, hi in ranges)}


def judge(digests: Sequence[bytes], planted: Set[bytes],
          ranges: Sequence[Tuple[int, int]],
          present: Dict[str, List[str]], quarantined: Iterable[str],
          healed_ok: Set[str]) -> Dict[str, int]:
    """Counts of every way the scrubbed node departs from what it must
    hold.  ``present``: block files by hex name; ``quarantined``: hex
    names with a ``.corrupted`` copy; ``healed_ok``: hex names whose
    present copy hashes to its name."""
    seen = covered(digests, ranges)
    quarantined = set(quarantined)
    hx = {d: d.hex() for d in digests}
    missed = sum(1 for d in seen & planted if hx[d] not in quarantined)
    false_q = sum(1 for d in seen - planted if hx[d] in quarantined)
    unhealed = sum(1 for d in seen & planted if hx[d] not in healed_ok)
    # blocks the node must still hold under their name: all but the
    # planted ones the scrub set aside and has not healed
    missing = sum(1 for d in digests if hx[d] not in present
                  and not (d in planted and hx[d] in quarantined))
    return {"verdicts": len(seen), "planted_reached": len(seen & planted),
            "missed_corruptions": missed, "false_quarantines": false_q,
            "unhealed": unhealed, "missing_blocks": missing}
