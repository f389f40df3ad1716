"""Data model layer — the S3 data model over the table engine.

Equivalent of reference src/model/ (SURVEY.md §2.6): the `Garage` god
object wiring DB + membership + block store + all replicated tables, the
object/version/block_ref metadata chain whose transactional `updated()`
hooks couple S3 metadata to block refcounts, bucket/key/alias CRDT tables,
and distributed index counters.
"""

from .garage import Garage
from .bucket_table import Bucket, BucketParams
from .bucket_alias_table import BucketAlias
from .key_table import Key, KeyParams
from .permission import BucketKeyPerm
from .helper import GarageHelper

__all__ = [
    "Garage",
    "Bucket",
    "BucketParams",
    "BucketAlias",
    "Key",
    "KeyParams",
    "BucketKeyPerm",
    "GarageHelper",
]
