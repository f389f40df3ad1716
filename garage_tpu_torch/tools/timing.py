"""Kernel times on the card, and the H100's peak rates they are held to.

``queued_ms`` times a function with CUDA events.  Its launches go in
batches of at most ``TIMED_BATCH``, each queued behind a sleep kernel that
holds the card until the whole batch is queued, so the events time the
card and not the host's launch rate (back-to-back Python launches take
~20 us each, as long as a small kernel).  With a ``flush`` tensor larger
than the L2, every launch follows a write of it and is timed on its own,
so its inputs come from HBM.  ``chip_smoke.py`` and ``tools/gf_tune.py``
time with it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

# H100 SXM peaks (NVIDIA's data sheet): 3.35 TB/s HBM3, 132 SMs at up to
# 1.98 GHz, 50 MB of L2
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
FLUSH_BYTES = 64 << 20          # more than the L2
# launches queued behind one sleep kernel: well inside the depth of a
# stream's launch queue, past which the host would block in a launch
TIMED_BATCH = 64


def queued_ms(fn: Callable[[], object], reps: int,
              flush: Optional[torch.Tensor] = None) -> float:
    """Mean milliseconds of fn() on the current CUDA device: one warm-up
    call, then `reps` calls in batches of TIMED_BATCH behind a sleep
    kernel.  Without `flush` a batch runs back to back between two
    events; with it, each call follows `flush.zero_()` between its own
    two events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if flush is not None:
        flush.zero_()
    fn()
    host_s = time.perf_counter() - t0
    total, done = 0.0, 0
    while done < reps:
        n = min(TIMED_BATCH, reps - done)
        torch.cuda.synchronize()
        torch.cuda._sleep(int((2 * host_s * n + 1e-3) * SM_CLOCK_HZ))
        if flush is None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            pairs = [(a, b)]
        else:
            pairs = []
            for _ in range(n):
                flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                pairs.append((a, b))
        torch.cuda.synchronize()
        total += sum(a.elapsed_time(b) for a, b in pairs)
        done += n
    return total / reps
