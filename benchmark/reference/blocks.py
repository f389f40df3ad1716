"""Blocks as a Garage node stores them, from first principles.

A block's name is the BLAKE2s-256 of its uncompressed content (RFC 7693,
unkeyed, 32-byte digest; Python's ``hashlib``).  A node stores it under
``<data_dir>/<hex[0:2]>/<hex[2:4]>/<hex>`` and, when compressed, with a
``.zst`` suffix; a copy the scrub found bad gets ``.corrupted`` appended.
A compressed file is a zstd frame where the ``zstandard`` module is
installed, and otherwise a zlib stream behind the 4-byte magic ``GTZF``.
"""

from __future__ import annotations

import hashlib
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

FALLBACK_MAGIC = b"GTZF"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
HEX = set("0123456789abcdef")


def blake2s256(data) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


def digests(blocks: List, threads: int = 8) -> List[bytes]:
    """BLAKE2s-256 of every block; hashlib releases the GIL on large
    buffers, so a thread pool hashes them in parallel."""
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(blake2s256, blocks, chunksize=16))


def split_blocks(body, block_size: int) -> List:
    """An object body cut into the blocks a PutObject stores."""
    mv = memoryview(body)
    return [mv[i:i + block_size] for i in range(0, len(body), block_size)] or [mv]


def decompress(raw: bytes) -> Optional[bytes]:
    """Content of a ``.zst`` block file; None when it does not decode."""
    if raw[:4] == FALLBACK_MAGIC:
        try:
            return zlib.decompress(raw[4:])
        except zlib.error:
            return None
    if raw[:4] == ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            return None
        try:
            return zstandard.ZstdDecompressor().decompress(raw)
        except zstandard.ZstdError:
            return None
    return None


def walk_store(data_dir: str) -> Tuple[Dict[str, List[str]], List[str], List[str]]:
    """(block files by hex name, quarantined names, other files) under a
    node's data dir.  A hex name may have a plain and a ``.zst`` file."""
    blocks: Dict[str, List[str]] = {}
    corrupted, other = [], []
    for dirpath, _dirs, files in os.walk(data_dir):
        for name in files:
            path = os.path.join(dirpath, name)
            stem, _, ext = name.partition(".")
            if len(stem) != 64 or not set(stem) <= HEX:
                other.append(path)
            elif ext in ("corrupted", "zst.corrupted"):
                corrupted.append(stem)
            elif ext in ("", "zst"):
                blocks.setdefault(stem, []).append(path)
            else:
                other.append(path)
    return blocks, corrupted, other


def file_content_ok(path: str) -> bool:
    """Does the file's content hash to its name?"""
    with open(path, "rb") as f:
        raw = f.read()
    stem = os.path.basename(path).partition(".")[0]
    data = decompress(raw) if path.endswith(".zst") else raw
    return data is not None and blake2s256(data).hex() == stem


def bad_files(paths: Iterable[str], threads: int = 8) -> List[str]:
    """The files whose content does not hash to their name."""
    paths = list(paths)
    with ThreadPoolExecutor(threads) as ex:
        ok = list(ex.map(file_content_ok, paths, chunksize=8))
    return [p for p, good in zip(paths, ok) if not good]
