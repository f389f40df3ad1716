"""Kernel times on the card, and the H100's peak rates they are held to.

``queued_ms`` times a function with CUDA events.  Its launches go in
batches of at most ``TIMED_BATCH`` windows, each batch queued behind a
sleep kernel that holds the card until the whole batch is queued, so the
events time the card and not the host's launch rate (back-to-back Python
launches take ~20 us each, as long as a small kernel).  With a ``flush``
tensor, every call comes after a read of one half of it, larger than the
L2, so its inputs come from HBM; the read leaves clean lines, which cost
the call nothing to drop.  The call's own output then sits in the L2 as
dirty lines, which HBM has not yet received: its window therefore runs on
through a read of the other half, which writes them back, and the time of
that read alone, measured the same way right after it, is taken off.  The
result is the median of those differences, so a host stall that lets the
queue run dry inside one window does not move it.  ``chip_smoke.py`` and
``tools/gf_tune.py`` time with it.

``ops_ms`` is the least time of integer work on the card's SMs.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch

# H100 SXM peaks (NVIDIA's data sheet): 3.35 TB/s HBM3, 132 SMs at up to
# 1.98 GHz, 50 MB of L2
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
FLUSH_BYTES = 128 << 20         # two halves, each more than the L2
# timed windows queued behind one sleep kernel: well inside the depth of a
# stream's launch queue, past which the host would block in a launch
TIMED_BATCH = 64
# Integer rates.  Only the SM's INT32 ALU pipe runs xors, rotates, byte
# permutes and logic (LOP3, SHF, PRMT): 64 lanes per SM per clock (the
# Hopper architecture white paper: 64 INT32 beside 128 FP32 lanes per SM;
# the CUDA guide's throughput table for compute capability 9.0: 64
# results per SM per clock for 32-bit integer add, shift, compare and
# logic).  Adds, multiplies and shifts can also run on the FMA pipe as
# IMAD, so all integer instructions together are capped by the issue of
# one warp instruction per clock by each of the SM's 4 schedulers: 128
# lanes.  chip_smoke.py checks the ALU rate on the card from the GF
# kernel's SASS census over its measured time: ~56 lanes on an H100 at
# 700 W (PERF.md), below 64.
ALU_LANES_PER_SM_CLOCK = 64
ISSUE_LANES_PER_SM_CLOCK = 128


def ops_ms(alu_ops: float, ops: float) -> float:
    """The least milliseconds for integer work of `ops` instructions (one
    lane each), of which `alu_ops` run only on the ALU pipe: the larger of
    the ALU-only ones over 64 lanes and all over 128, x 132 SMs x 1.98 GHz."""
    lanes = max(alu_ops / ALU_LANES_PER_SM_CLOCK,
                ops / ISSUE_LANES_PER_SM_CLOCK)
    return lanes / (SMS * SM_CLOCK_HZ) * 1e3


def evict_l2(buf: torch.Tensor) -> None:
    """Push the L2's lines out with a read of `buf` (larger than the L2),
    which leaves clean lines of its own."""
    buf.view(torch.int64).sum()


def queued_ms(fn: Callable[[], object], reps: int,
              flush: Optional[torch.Tensor] = None) -> float:
    """Milliseconds of fn() on the current CUDA device: one warm-up call,
    then `reps` calls in batches behind a sleep kernel.  Without `flush` a
    batch of calls runs back to back between two events, and the result
    is their mean.  With it, each call follows ``evict_l2`` of the first
    half of `flush` and is timed with ``evict_l2`` of the second half
    behind it, which writes back the lines the call left dirty; after each
    call the same read is timed alone, and the result is the median over
    the calls of the difference."""
    windows, before = [fn], None
    if flush is not None:
        ahead, behind = flush.view(torch.uint8).chunk(2)

        def before():
            evict_l2(ahead)

        def paid():
            fn()
            evict_l2(behind)

        windows = [paid, lambda: evict_l2(behind)]

    def one_rep(pairs=None):
        for j, body in enumerate(windows):
            if before is not None:
                before()
            if pairs is None:
                body()
                continue
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            body()
            b.record()
            pairs.append((j, a, b))

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_rep()
    host_s = time.perf_counter() - t0
    times = [[] for _ in windows]
    per_batch = max(1, TIMED_BATCH // len(windows))
    done = 0
    while done < reps:
        n = min(per_batch, reps - done)
        torch.cuda.synchronize()
        torch.cuda._sleep(int((2 * host_s * n + 1e-3) * SM_CLOCK_HZ))
        pairs = []
        if before is None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            pairs.append((0, a, b))
        else:
            for _ in range(n):
                one_rep(pairs)
        torch.cuda.synchronize()
        for j, a, b in pairs:
            times[j].append(a.elapsed_time(b))
        done += n
    if before is None:
        return sum(times[0]) / reps
    return statistics.median(p - q for p, q in zip(*times))
