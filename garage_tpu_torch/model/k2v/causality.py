"""K2V causality tokens — vector clocks over writer nodes.

Equivalent of reference src/model/k2v/causality.rs:21-127: a CausalContext
maps writer node (first 8 bytes of its id, as u64) → the highest timestamp
of that node's writes the reader has seen.  Serialized as a base64url
token handed to clients; an insert carrying a token supersedes exactly the
values the token covers, everything else becomes a concurrent sibling.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, Optional


def node_id64(node_id: bytes) -> int:
    """Writer key = first 8 bytes of the 32-byte node id (ref
    causality.rs make_node_id)."""
    return struct.unpack(">Q", bytes(node_id)[:8])[0]


class CausalContext:
    __slots__ = ("vector_clock",)

    def __init__(self, vector_clock: Optional[Dict[int, int]] = None):
        self.vector_clock: Dict[int, int] = vector_clock or {}

    def serialize(self) -> str:
        """ref causality.rs:35-54: sorted (node u64, ts u64) pairs,
        big-endian, base64url without padding."""
        buf = b"".join(
            struct.pack(">QQ", n, t)
            for n, t in sorted(self.vector_clock.items())
        )
        return base64.urlsafe_b64encode(buf).decode().rstrip("=")

    @classmethod
    def parse(cls, s: str) -> "CausalContext":
        if not s:
            return cls()
        pad = "=" * ((-len(s)) % 4)
        try:
            buf = base64.urlsafe_b64decode(s + pad)
        except Exception as e:
            raise ValueError(f"invalid causality token: {e}")
        if len(buf) % 16 != 0:
            raise ValueError("invalid causality token length")
        vc = {}
        for i in range(0, len(buf), 16):
            n, t = struct.unpack(">QQ", buf[i : i + 16])
            vc[n] = t
        return cls(vc)

    def get(self, node: int) -> int:
        return self.vector_clock.get(node, 0)

    def advance(self, node: int, ts: int) -> None:
        self.vector_clock[node] = max(self.vector_clock.get(node, 0), ts)

    def is_newer_than(self, other: "CausalContext") -> bool:
        """True if self has seen anything other hasn't (ref
        causality.rs:100-110)."""
        return any(
            t > other.vector_clock.get(n, 0)
            for n, t in self.vector_clock.items()
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CausalContext)
            and self.vector_clock == other.vector_clock
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"CausalContext({self.vector_clock})"
