"""Peaks of the card and the work a kernel's inputs need.

Peaks of one NVIDIA H100 SXM5 80 GB (the H100 data sheet; the Hopper
architecture white paper for the SM count and boost clock):

- HBM3 bandwidth 3.35 TB/s;
- 32-bit integer issue: 64 results per clock per SM for 32-bit integer
  add, bitwise AND/OR/XOR and shift, the "Throughput of Native
  Arithmetic Instructions" table of NVIDIA's CUDA C++ Programming Guide,
  compute capability 9.0; times 132 SMs at the 1,980 MHz maximum boost
  clock: 16.73e12 operations per second.

These hold at the card's 700 W limit; a run prints its card's limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_HZ = 1.980e9
INT32_PER_CLOCK_PER_SM = 64
INT32_OPS_PER_S = INT32_PER_CLOCK_PER_SM * SMS * BOOST_HZ

# BLAKE2s (RFC 7693 section 3.2): a compression is 10 rounds of 8 G
# functions, and G is 6 additions, 4 XORs and 4 rotations of 32-bit words
B2S_ROUNDS, B2S_G_PER_ROUND = 10, 8
B2S_OPS_PER_G = 6 + 4 + 4
B2S_OPS_PER_CHUNK = B2S_ROUNDS * B2S_G_PER_ROUND * B2S_OPS_PER_G  # 1,120
B2S_CHUNK = 64
B2S_DIGEST = 32


def blake2s_chunks(length: int) -> int:
    """Compressions one message of ``length`` bytes needs (an empty one
    still compresses one chunk)."""
    return max(1, -(-length // B2S_CHUNK))


def blake2s_work(lengths) -> tuple:
    """(32-bit operations, bytes moved) to hash messages of these
    lengths: every input byte read once, every digest written once."""
    lengths = list(lengths)
    ops = sum(blake2s_chunks(n) for n in lengths) * B2S_OPS_PER_CHUNK
    return ops, sum(lengths) + B2S_DIGEST * len(lengths)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the issue bound
    and the bandwidth bound."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share_percent(ops: float, nbytes: float, seconds: float):
    """A kernel's share of its roofline in percent; None with no time."""
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / seconds
