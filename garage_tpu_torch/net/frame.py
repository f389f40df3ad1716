"""Wire framing for the cluster RPC fabric.

Frame layout (all integers big-endian):

    kind:u8  prio:u8  stream_id:u32  length:u32  payload[length]

Stream IDs are allocated by the connection side that opens the request
(odd/even split by dialer/listener so both sides can open streams without
coordination).  Priorities (ref rpc/rpc_helper.rs:19-21): lower value =
more urgent; the connection writer drains queues in strict priority order,
chunking DATA frames at CHUNK so a bulk background body never delays a
high-priority frame by more than one chunk.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

# Priorities (ref netapp PRIO_*): 0 is most urgent.
PRIO_HIGH = 0        # membership gossip, health
PRIO_NORMAL = 1      # user-facing metadata + block ops
PRIO_SECONDARY = 2   # offloading, read-repair pushes
PRIO_BACKGROUND = 3  # resync/scrub/rebalance bulk traffic

N_PRIO = 4

# Metric/display labels for the priority levels (index == PRIO_* value).
PRIO_NAMES = ("high", "normal", "secondary", "background")

# Frame kinds.
K_REQ = 1        # open stream: payload = msgpack request header + body blob
K_RESP = 2       # payload = msgpack response header + body blob
K_DATA = 3       # streaming body chunk
K_EOS = 4        # end of stream (clean)
K_ERR = 5        # stream aborted: payload = utf-8 error text
K_PING = 6       # payload = 8-byte token, echoed in PONG
K_PONG = 7
K_GOODBYE = 8    # clean shutdown notice
K_WIN = 9        # per-stream flow-control credit grant: payload = u32 chunks
K_CANCEL = 10    # receiver abandoned an incoming stream: sender stops pumping

CHUNK = 16 * 1024          # streaming body chunk size
MAX_FRAME = 16 * 1024 * 1024  # sanity bound on one frame payload

_HDR = struct.Struct(">BBII")
HDR_SIZE = _HDR.size


class Frame(NamedTuple):
    kind: int
    prio: int
    stream_id: int
    payload: bytes

    def encode(self) -> bytes:
        return _HDR.pack(self.kind, self.prio, self.stream_id, len(self.payload)) + self.payload


def decode_header(buf: bytes):
    """→ (kind, prio, stream_id, length)."""
    return _HDR.unpack(buf)
