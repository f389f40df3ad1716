"""Event-loop stalls of the chaos node_rebuild drill.

    python -m garage_tpu_torch.tools.loop_stalls [--device cuda|cpu]

Runs ``tools/chaos.py``'s node_rebuild drill at its ``--quick`` shape (6
storage nodes in 3 zones, RS(2,2), a 3 s storm) once in each of 12 fresh
processes.  In each, a watchdog thread records every thread's stack
when the event loop, which all the in-process nodes share, has not run
for 0.35 s, and again once the same stall passes 0.9 s; full
collections are timed through ``gc.callbacks``.  Each stall
is put in a window by where the drill's own coroutine stands (its await
chain, and the loop's stack when it is the one running): ``startup``
inside ``SimCluster.start`` or in ``run_node_rebuild``'s own code (the
nodes' construction and the client's set-up, before the first request),
``teardown`` inside ``SimCluster.stop``, else ``traffic``.

Prints one JSON line: per run the drill's verdict, client errors, p99,
full-collection seconds and its stalls (lag, window, the loop's frames
in the package and its last 8, the other threads' last 6), and per
window the runs that stalled and the range of their largest stalls.
Exits non-zero when a drill fails, or does not end in 150 s (its process
then prints every thread's stack).  ``--device cuda`` (the default)
builds every node's codec on the card and needs a GPU: without one the
tool exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import gc
import json
import subprocess
import sys
import threading
import time
import traceback
import types

from .common import check, emit

RUNS = 12
THRESHOLD_S = 0.35
LATE_S = 0.9
DUMP_S = 150  # a drill takes ~30 s: past this the child dumps its threads
RUN_TIMEOUT_S = 180


def window_of(frames) -> str:
    """The drill's window for (file, function) frames, outermost first:
    startup, traffic or teardown."""
    ours = [(f, n) for f, n in frames if n != "<module>" and f.replace(
        "\\", "/").endswith(("tools/chaos.py", "testing/sim_cluster.py"))]
    cluster = {n for f, n in ours if f.endswith("sim_cluster.py")}
    if "stop" in cluster:
        return "teardown"
    if "start" in cluster or (ours and ours[-1][1] == "run_node_rebuild"):
        return "startup"
    return "traffic"


def await_chain(coro) -> list:
    """(file, function) of every coroutine `coro` is awaiting through,
    outermost first."""
    out = []
    while isinstance(coro, types.CoroutineType):
        frame = coro.cr_frame
        if frame is not None:
            out.append((frame.f_code.co_filename, frame.f_code.co_name))
        coro = coro.cr_await
    return out


class Sampler:
    """A watchdog over the event loop of the thread that calls `run`."""

    def __init__(self, threshold: float = THRESHOLD_S, late: float = LATE_S):
        self.threshold, self.late = threshold, late
        self.episodes, self.gcs = [], []
        self._beat = time.monotonic()
        self._on = False
        self._gc_t0 = None
        self._loop_tid = None
        self._coro = None

    def _gc(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gcs.append(time.perf_counter() - self._gc_t0)
            self._gc_t0 = None

    def _snap(self, lag: float) -> dict:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        loop = traceback.extract_stack(frames[self._loop_tid])
        window = window_of(await_chain(self._coro)
                           + [(f.filename, f.name) for f in loop])
        return {"lag": lag, "gc": self._gc_t0 is not None, "window": window,
                "loop": "".join(traceback.format_list(
                    [f for f in loop[:-8] if "garage_tpu_torch" in f.filename]
                    + loop[-8:])),
                "threads": {names.get(tid, str(tid)): "".join(
                    traceback.format_stack(fr)[-6:])
                    for tid, fr in frames.items() if tid != self._loop_tid}}

    def _watch(self):
        ep = None
        while self._on:
            time.sleep(0.03)
            lag = time.monotonic() - self._beat
            if lag <= self.threshold:
                ep = None
                continue
            if ep is None:
                ep = {"first": self._snap(lag), "late": None}
                ep["window"] = ep["first"]["window"]
                self.episodes.append(ep)
            ep["max"] = max(ep.get("max", 0.0), lag)
            if lag > self.late and ep["late"] is None:
                ep["late"] = self._snap(lag)

    async def run(self, coro):
        """Await `coro` with the watchdog on."""
        self._loop_tid = threading.get_ident()
        self._coro = coro

        async def beat():
            while True:
                self._beat = time.monotonic()
                await asyncio.sleep(0.02)

        gc.callbacks.append(self._gc)
        self._beat = time.monotonic()
        self._on = True
        watch = threading.Thread(target=self._watch, name="stall-watchdog",
                                 daemon=True)
        watch.start()
        b = asyncio.create_task(beat())
        try:
            return await coro
        finally:
            self._on = False
            b.cancel()
            watch.join()
            gc.callbacks.remove(self._gc)


def child(device: str) -> dict:
    """One node_rebuild drill under the sampler, in this process; every
    thread's stack on stderr and exit 1 if it has not ended in DUMP_S."""
    from . import chaos

    faulthandler.dump_traceback_later(DUMP_S, exit=True)
    sampler = Sampler()
    try:
        s = asyncio.run(sampler.run(chaos.run_node_rebuild(3.0, device, 6,
                                                           3)))
    finally:
        faulthandler.cancel_dump_traceback_later()
    st = s["phases"]["node_rebuild"]
    return {"ok": bool(s["ok"]), "errors": st.get("errors"),
            "error_notes": st.get("error_notes"), "p99_ms": st.get("p99_ms"),
            "gc2_s": sampler.gcs,
            "stalls": sorted(sampler.episodes, key=lambda e: -e["max"])}


def summarise(runs: list) -> dict:
    """Per window: the runs with a stall and their largest stalls."""
    out = {}
    for window in ("startup", "traffic", "teardown"):
        worst = [max((e["max"] for e in r["stalls"]
                      if e["window"] == window), default=None) for r in runs]
        hit = [w for w in worst if w is not None]
        out[window] = {"runs_with_stall": len(hit), "runs": len(runs),
                       "max_s": [min(hit), max(hit)] if hit else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every node's codec runs")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        # torch and the CUDA context load inside the drill, as in chaos.py
        print("RESULT " + json.dumps(child(args.device), default=float),
              flush=True)
        return 0
    if args.device == "cuda":
        from .common import require_card

        require_card()
    runs = []
    for i in range(RUNS):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", __spec__.name, "--child",
                            "--device", args.device], capture_output=True,
                           text=True, timeout=RUN_TIMEOUT_S)
        lines = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode != 0 or not lines:
            print(r.stderr, file=sys.stderr)
        check(r.returncode == 0 and lines, f"run {i} exited {r.returncode}")
        res = json.loads(lines[-1][len("RESULT "):])
        res["secs"] = time.perf_counter() - t0
        runs.append(res)
        print(f"run {i}: ok {res['ok']}, errors {res['errors']}, stalls "
              f"{[(round(e['max'], 3), e['window']) for e in res['stalls']]}",
              file=sys.stderr, flush=True)
    emit({"tool": "loop_stalls", "device": args.device,
          "threshold_s": THRESHOLD_S, "summary": summarise(runs),
          "runs": runs})
    return 0 if all(r["ok"] and r["errors"] == 0 for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
