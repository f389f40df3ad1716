"""Reed-Solomon RS(k, m) parity over GF(2^8), frozen, in NumPy.

The field is GF(2^8) modulo x^8 + x^4 + x^3 + x^2 + 1 (0x11D), the field
of ISA-L and jerasure.  The code is systematic: a codeword is the k data
shards and m parity shards, parity row i = sum over j of P[i, j] * data
j, with the Cauchy matrix P[i, j] = 1 / ((k + i) XOR j), so that any k
of the k + m shards recover the data.  Shards shorter than the longest
member are padded with zeros.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

POLY = 0x11D


def _tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse")
    return int(EXP[255 - LOG[a]])


def parity_matrix(k: int, m: int) -> np.ndarray:
    return np.array([[inv((k + i) ^ j) for j in range(k)] for i in range(m)],
                    dtype=np.int32)


def scale(c: int, x: np.ndarray) -> np.ndarray:
    """c * x elementwise, x a uint8 array."""
    if c == 0:
        return np.zeros_like(x)
    out = EXP[LOG[c] + LOG[x.astype(np.int32)]].astype(np.uint8)
    out[x == 0] = 0
    return out


def encode(k: int, m: int, members: Sequence[bytes]) -> List[bytes]:
    """The m parity shards of a codeword of at most k members (missing
    members are zero shards), each as long as the longest member."""
    width = max(len(b) for b in members)
    data = np.zeros((k, width), dtype=np.uint8)
    for j, b in enumerate(members):
        data[j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    p = parity_matrix(k, m)
    out = []
    for i in range(m):
        acc = np.zeros(width, dtype=np.uint8)
        for j in range(k):
            acc ^= scale(int(p[i, j]), data[j])
        out.append(acc.tobytes())
    return out
