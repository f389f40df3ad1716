"""Inputs made from the seed: block stores and object payloads.

Every seed gives the same counts and sizes, at other places and with
other bytes, so that two seeds do the same work.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed (any
    integer, negative or past 64 bits included)."""
    return np.random.default_rng([seed % 2**64, seed // 2**64 % 2**64, stream])


class BlockStore:
    """``n`` blocks of ``size`` bytes: ``n / short_every`` of them cut to
    ``short_bytes_per_mib`` bytes per MiB of ``size``, ``n / compressible_every`` a 512-byte pattern
    repeated (a node stores those compressed), the rest random; and
    ``n / corrupt_every`` chosen to be planted bad, each with a byte
    offset to flip."""

    def __init__(self, seed: int, n: int, size: int, t: dict):
        g = rng(seed, 1)
        order = g.permutation(n)
        n_comp = n // int(t["compressible_every"])
        n_short = n // int(t["short_every"])
        self.compressible = set(int(i) for i in order[:n_comp])
        short = set(int(i) for i in order[n_comp:n_comp + n_short])
        short_size = int(t["short_bytes_per_mib"]) * size // 2**20
        self.sizes = [short_size if i in short else size for i in range(n)]
        raw = memoryview(g.bytes(sum(self.sizes)))
        self.blocks, off = [], 0
        for i, s in enumerate(self.sizes):
            if i in self.compressible:
                pat = g.bytes(512)
                self.blocks.append(memoryview((pat * (s // 512 + 1))[:s]))
            else:
                self.blocks.append(raw[off:off + s])
            off += s
        bad = g.choice(n, n // int(t["corrupt_every"]), replace=False)
        self.planted = {int(i): float(g.uniform()) for i in bad}

    def __len__(self) -> int:
        return len(self.blocks)


def payloads(seed: int, stream: int, count: int, size: int) -> memoryview:
    """``count`` payloads of ``size`` bytes, back to back."""
    return memoryview(rng(seed, stream).bytes(count * size))
