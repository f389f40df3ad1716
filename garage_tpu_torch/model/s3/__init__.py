"""S3 data model tables (ref src/model/s3/)."""

from .object_table import (
    Object,
    ObjectVersion,
    ObjectVersionData,
    ObjectVersionHeaders,
    ObjectVersionMeta,
)
from .version_table import Version, VersionBlock, VersionBlockKey
from .block_ref_table import BlockRef
from .mpu_table import MultipartUpload, MpuPart

__all__ = [
    "Object",
    "ObjectVersion",
    "ObjectVersionData",
    "ObjectVersionHeaders",
    "ObjectVersionMeta",
    "Version",
    "VersionBlock",
    "VersionBlockKey",
    "BlockRef",
    "MultipartUpload",
    "MpuPart",
]
