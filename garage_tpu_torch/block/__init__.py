"""Block store — content-addressed data blocks with batched TPU codec ops.

Equivalent of reference src/block/ (SURVEY.md §2.5): BlockManager local
file storage + streaming RPC get/put, refcounting, persistent resync queue
with error backoff, and scrub/repair/rebalance workers.  TPU-first
difference: the scrub/verify/RS paths are *batch-first* — the workers feed
block batches to the configured BlockCodec (ops/) instead of hashing one
block at a time (ref block/repair.rs:438-490 is strictly sequential).
"""

from .block import DataBlock, DataBlockHeader
from .layout import DataLayout
from .rc import BlockRc, RcEntry
from .manager import BlockManager, INLINE_THRESHOLD
from .resync import BlockResyncManager, ResyncWorker
from .repair import BlockStoreIterator, RepairWorker, ScrubWorker

__all__ = [
    "DataBlock",
    "DataBlockHeader",
    "DataLayout",
    "BlockRc",
    "RcEntry",
    "BlockManager",
    "INLINE_THRESHOLD",
    "BlockResyncManager",
    "ResyncWorker",
    "BlockStoreIterator",
    "RepairWorker",
    "ScrubWorker",
]
