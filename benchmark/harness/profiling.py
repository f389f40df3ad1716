"""A traced window: ``torch.profiler`` (CPU and CUDA activities) on this
process and a sampler of its threads' stacks, written to files; and the
card's time over an untraced window (``CardTime``)."""

from __future__ import annotations

import json
import time
from typing import List

from . import devtrace
from .hoststacks import Sampler


class Window:
    def __init__(self, out_path: str):
        """Writes ``<out_path>`` (the profiler's trace) and
        ``<out_path>.host.json`` (the samples and the window)."""
        self.out_path = out_path
        self.prof = self.sampler = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.sampler = Sampler()
        self.sampler.start()
        # the marker's trace time against the wall clock puts the trace
        # on the clock of the samples and of the other processes
        with record_function(devtrace.MARK):
            self.t0 = time.time_ns() / 1e3

    def stop(self) -> float:
        """Ends the window and writes its files; returns its seconds."""
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns() / 1e3
        self.sampler.stop()
        self.prof.stop()
        self.prof.export_chrome_trace(self.out_path)
        with open(self.out_path + ".host.json", "w") as f:
            json.dump({"window": [self.t0, self.t1],
                       "samples": self.sampler.samples}, f)
        self.prof = None
        return (self.t1 - self.t0) * 1e-6


class CardTime:
    """The card's busy time over an untraced window: ``torch.profiler``
    with the CUDA activity alone, no host operators and no stack
    samples, so that the host does an untraced run's work.  The caller
    opens and closes it with the card idle, so every device event of
    the trace lies inside the window."""

    def __init__(self, out_path: str):
        self.out_path = out_path
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(self.out_path)
        self.prof = None


def card_time(trace_path: str) -> dict:
    """busy seconds (the union of every kernel, copy and memset) and the
    count of device events of an untraced window's trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = devtrace.device_events(e for e in events if e.get("ph") == "X"
                                 and "ts" in e and "dur" in e)
    return {"busy_s": devtrace.busy_seconds(dev), "device_events": len(dev)}


def reduce(trace_paths: List[str], window=None) -> dict:
    """The traces of one card's processes as one: ``devtrace.reduce``
    over their events, the window the harness's own when given, else the
    widest of theirs; idle gaps named from every process's samples."""
    events, samples, spans = [], [], []
    for p in trace_paths:
        with open(p + ".host.json") as f:
            host = json.load(f)
        events += devtrace.load(p, host["window"][0])
        samples += [tuple(s) for s in host["samples"]]
        spans.append(host["window"])
    if window is None:
        window = (min(s[0] for s in spans), max(s[1] for s in spans))
    sampler = Sampler()
    sampler.samples = samples
    out = devtrace.reduce(events, window, sampler.label)
    out["traces"] = len(trace_paths)
    return out
