"""DataBlock — a block payload, plain or zstd-compressed.

Equivalent of reference src/block/block.rs:10-115: `Plain(bytes)` vs
`Compressed(bytes)` (zstd frame with content checksum); `verify` checks
the content hash for plain data and the zstd frame checksum for compressed
data (block.rs:66-78); `from_buffer` compresses when it shrinks the block
(block.rs:80-91).

`verify` routes through a BlockCodec when one is supplied (the
BlockManager read path passes its codec — `codec.verify_one`, whose
default is defined in terms of the same batch_verify the scrub path
uses); without a codec it falls back to hashlib directly (standalone
DataBlock uses in tests/tools).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils.data import Hash, block_hash
from ..utils.zstd_compat import zstandard
from ..utils.error import CorruptData


@dataclasses.dataclass
class DataBlockHeader:
    """Wire header accompanying a block body (ref block.rs DataBlockHeader)."""

    compressed: bool

    def pack(self) -> str:
        return "zst" if self.compressed else "plain"

    @classmethod
    def unpack(cls, v: str) -> "DataBlockHeader":
        return cls(compressed=(v == "zst"))


class DataBlock:
    # `parity`: this block is a distributed-parity shard (travels with
    # fetches so re-writes on other nodes keep it out of the write-time
    # codeword accumulators — parity of parity protects nothing the
    # decode can use)
    __slots__ = ("compressed", "inner", "parity")

    def __init__(self, inner: bytes, compressed: bool,
                 parity: bool = False):
        self.inner = inner
        self.compressed = compressed
        self.parity = parity

    @classmethod
    def plain(cls, data: bytes) -> "DataBlock":
        return cls(data, compressed=False)

    @classmethod
    def compressed_from(cls, data: bytes) -> "DataBlock":
        return cls(data, compressed=True)

    @classmethod
    def from_buffer(
        cls, data: bytes, compression_level: Optional[int]
    ) -> "DataBlock":
        """Compress if configured and it shrinks the block
        (ref block.rs:80-91)."""
        if compression_level is not None:
            c = zstandard.ZstdCompressor(
                level=compression_level,
                write_checksum=True,
                write_content_size=True,
            )
            out = c.compress(data)
            if len(out) < len(data):
                return cls(out, compressed=True)
        return cls(data, compressed=False)

    def header(self) -> DataBlockHeader:
        return DataBlockHeader(self.compressed)

    def verify(self, hash: Hash, algo: str = "blake2s", codec=None) -> None:
        """ref block.rs:66-78: plain → content hash must match; compressed →
        zstd frame checksum validates (content hash covers the *uncompressed*
        bytes, which we don't have without decompressing).  With `codec`,
        plain-block hashing goes through codec.verify_one — the same seam
        the batched scrub path uses."""
        if self.compressed:
            try:
                zstandard.ZstdDecompressor().decompress(self.inner)
            except zstandard.ZstdError as e:
                raise CorruptData(f"zstd verify failed: {e}") from None
        elif codec is not None:
            if not codec.verify_one(self.inner, hash):
                raise CorruptData(f"hash mismatch for block {hash.hex()[:16]}")
        else:
            if bytes(block_hash(self.inner, algo)) != bytes(hash):
                raise CorruptData(f"hash mismatch for block {hash.hex()[:16]}")

    def decompressed(self) -> bytes:
        if self.compressed:
            return zstandard.ZstdDecompressor().decompress(self.inner)
        return self.inner

    def __len__(self) -> int:
        return len(self.inner)
