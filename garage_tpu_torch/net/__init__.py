"""net — the cluster communication backend.

Equivalent of the reference's external `netapp 0.10` crate (SURVEY.md §2.3,
§5 "Distributed communication backend"): TCP transport, ed25519-keyed
authenticated handshake where the node ID *is* the public key, multiplexed
request streams with 4 priority levels so repair traffic yields to user
traffic, streaming message bodies, typed endpoints, and full-mesh peering
with ping-based latency estimation.

This is a new asyncio design, not a port: one writer task per connection
drains four bounded priority queues (strict priority, FIFO within a level,
16 KiB chunking so a background stream never blocks a high-priority frame
for more than one chunk), and every request/response is a msgpack blob plus
an optional byte stream.

Modules:
  frame.py    wire framing + priorities
  netapp.py   Connection (handshake, mux), NetApp (listener + endpoints)
  peering.py  FullMeshPeering: connect-to-all, pings, latency, liveness
"""

from .frame import (
    PRIO_BACKGROUND,
    PRIO_HIGH,
    PRIO_NORMAL,
    PRIO_SECONDARY,
)
from .netapp import Endpoint, NetApp, NodeID, gen_node_key
from .peering import FullMeshPeering

__all__ = [
    "PRIO_HIGH", "PRIO_NORMAL", "PRIO_SECONDARY", "PRIO_BACKGROUND",
    "NetApp", "Endpoint", "NodeID", "gen_node_key", "FullMeshPeering",
]
