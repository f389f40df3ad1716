"""One node of a deployment as its own process: the daemon's entry.

    python3 benchmark/node.py <config.toml> [--control DIR] [--fault FILE]

Runs ``garage_tpu_torch.server.run_server`` exactly as ``python -m
garage_tpu_torch -c <config.toml> server`` does (the same logging set-up,
then the server until SIGTERM), and, given a control dir, beside one task of
the benchmark's own: when the file ``start`` appears in the control dir it opens a
``torch.profiler`` window on this process, and when ``stop`` appears it
closes the window and writes ``trace-<pid>.json`` (and its
``.host.json``) there, then ``done-<pid>``.  Only ``--trace 1`` runs give a control dir.  ``--fault``
is the tests' seam: a Python file run in the node's process before it
serves, to break the program underneath a run; no run of the benchmark
gives one.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


async def profile_on_request(ctl: Path) -> None:
    from benchmark.harness.profiling import Window

    while not (ctl / "start").exists():
        await asyncio.sleep(0.02)
    pid = os.getpid()
    win = Window(str(ctl / f"trace-{pid}.json"))
    win.start()
    while not (ctl / "stop").exists():
        await asyncio.sleep(0.02)
    seconds = win.stop()
    (ctl / f"done-{pid}").write_text(f"{seconds}\n")


async def serve(config: str, ctl) -> None:
    from garage_tpu_torch.server import run_server

    if ctl is None:
        await run_server(config)
        return
    watcher = asyncio.create_task(profile_on_request(Path(ctl)))
    try:
        await run_server(config)
    finally:
        watcher.cancel()
        try:
            await watcher
        except asyncio.CancelledError:
            pass


def main() -> None:
    import argparse
    import runpy

    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--control")
    ap.add_argument("--fault")
    args = ap.parse_args()
    if args.fault:
        runpy.run_path(args.fault)
    from garage_tpu_torch.utils.tracing import install_log_trace_ids

    install_log_trace_ids()
    logging.basicConfig(
        level=os.environ.get("GARAGE_TPU_LOG", "INFO"),
        format="%(asctime)s %(levelname).1s %(name)s [%(trace_id)s]: "
               "%(message)s")
    try:
        asyncio.run(serve(args.config, args.control))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
