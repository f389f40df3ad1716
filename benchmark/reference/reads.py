"""Read-after-write under Garage's quorums, from the client's clock.

``replication_mode = "3"`` writes and reads with a quorum of 2 of 3, so
a GetObject sees every PutObject acknowledged before it was sent.  What a
GET may return is then fixed by the client's own record of sends and
acknowledgements: any version of the key that was sent before the GET's
answer came, except one superseded before the GET was sent, that is,
followed by a PUT of the same key that was sent after the version's
acknowledgement and acknowledged itself before the GET left.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Set


@dataclass
class Version:
    """One PutObject as the client saw it; ``acked`` is None for a PUT
    that failed (it may or may not have been applied)."""
    key: str
    digest: bytes
    sent: float
    acked: Optional[float]


class History:
    def __init__(self):
        self.by_key: Dict[str, List[Version]] = {}

    def add(self, v: Version) -> None:
        self.by_key.setdefault(v.key, []).append(v)

    def acked(self) -> List[Version]:
        return [v for vs in self.by_key.values() for v in vs
                if v.acked is not None]

    def valid(self, key: str, sent: float, done: float) -> Set[bytes]:
        """Digests a GET of ``key`` sent at ``sent`` and answered at
        ``done`` may return."""
        vs = self.by_key.get(key, [])
        out = set()
        for v in vs:
            if v.sent >= done:
                continue
            v_ack = v.acked if v.acked is not None else math.inf
            superseded = any(
                w is not v and w.acked is not None and w.sent > v_ack
                and w.acked < sent for w in vs)
            if not superseded:
                out.add(v.digest)
        return out
