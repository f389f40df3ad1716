"""K2V — the key/key/value store (ref src/model/k2v/, SURVEY.md §2.6).

Items are addressed (bucket, partition_key, sort_key) and hold a DVVS
(dotted version vector set) causal multi-value register: concurrent writes
from different nodes are all retained as conflicting values until a write
with a causal context covering them supersedes them.
"""

from .causality import CausalContext
from .item_table import DvvsEntry, DvvsValue, K2VItem, K2VItemTableSchema

__all__ = [
    "CausalContext",
    "DvvsEntry",
    "DvvsValue",
    "K2VItem",
    "K2VItemTableSchema",
]
