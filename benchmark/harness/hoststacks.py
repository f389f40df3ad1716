"""What the host's threads were doing, sampled beside a traced window.

The profiler records no operator of the program's own threads, so the
card's idle gaps are named from samples instead: every few ms, the
innermost frame of each thread that is running Python code of the
program or of the benchmark (not parked in a wait), stamped with the
wall clock the profiler's trace also uses.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import List, Tuple

# innermost frames of a parked thread (a pool worker waiting for a task
# sits in thread.py's _worker, inside the queue's C code)
WAITS = {"wait", "select", "poll", "acquire", "sleep", "get", "_wait_for_tstate_lock",
         "accept", "recv", "recv_into", "read", "readinto", "epoll", "_worker"}
OURS = ("garage_tpu_torch", "benchmark")


def _label(frame) -> str:
    """The innermost frame of ours, or "" when the thread is parked or
    runs no code of ours."""
    if frame.f_code.co_name in WAITS:
        return ""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if any(f"{os.sep}{p}{os.sep}" in fn for p in OURS):
            mod = fn.rsplit(os.sep, 2)
            return f"{mod[-2]}/{mod[-1]}:{f.f_code.co_name}"
        f = f.f_back
    return ""


class Sampler:
    def __init__(self, period_s: float = 0.02):
        self.period = period_s
        self.samples: List[Tuple[float, str]] = []  # (epoch us, label)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bench-host-sampler")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            t = time.time_ns() / 1e3
            for tid, frame in sys._current_frames().items():
                if tid != me:
                    label = _label(frame)
                    if label:
                        self.samples.append((t, label))
            time.sleep(self.period)

    def label(self, lo_us: float, hi_us: float) -> str:
        """The most sampled label inside [lo, hi] (epoch us)."""
        c = collections.Counter(l for t, l in self.samples if lo_us <= t <= hi_us)
        return c.most_common(1)[0][0] if c else "no thread in the program's code"
