#!/usr/bin/env python3
"""Run one cell of the garage_tpu_torch benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, its traffic mix and its per-layer metrics are files found
by name (``harness/spec.py``).  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, ``host``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which the last
lines of standard error repeat.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "garage_tpu"}


def forbidden_loaded() -> list:
    """Top-level names in sys.modules that the port must never load,
    compared whole (``garage_tpu_torch`` is not ``garage_tpu``)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Ctx:
    """What a driver gets: the run's arguments, the cell's files, where
    to write, and the test seam ``fault`` (None in every real run)."""

    def __init__(self, args, spec, cell, device, tmp, fault=None):
        from benchmark.harness import host

        self.seed, self.seconds, self.trace = args.seed, args.seconds, args.trace
        self.cell = cell
        self.config = spec.config(cell)
        self.traffic = spec.traffic(cell)
        self.device = device
        self.tmp = tmp
        self.t_process = T_PROCESS
        self.fault = fault
        # the host, its load read again by the driver as the window opens
        self.host = host.record(tmp)

    def memory_peak(self) -> int:
        if self.device != "cuda":
            return 0
        import torch

        return int(torch.cuda.max_memory_reserved())


def run_cell(spec, cell, args, device: str = "cuda", card=None, fault=None):
    """One run of a cell; returns (the result object, its Checks, the
    run's notes for standard error)."""
    from benchmark.harness.spec import read_metrics

    tmp = tempfile.mkdtemp(prefix="garage-bench-")
    try:
        ctx = Ctx(args, spec, cell, device, tmp, fault)
        driver = importlib.import_module(
            f"benchmark.drivers.{ctx.traffic['driver']}")
        out = asyncio.run(driver.run(ctx))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = dict(card or {"platform": "cpu", "kind": "cpu", "count": 0})
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    units = {m["name"]: m["unit"] for m in spec.end_to_end(cell)}
    res = {"correct": out["checks"].ok(), "attempted": out["attempted"],
           "failed": out["failed"]}
    if args.trace:
        red = out.get("trace") or {}
        res["metrics"] = read_metrics(spec, cell, out["obs"])
        dev["busy_s"] = red.get("busy_s", 0.0)
        dev["window_s"] = red.get("window_s", 0.0)
        res["device"] = dev
        res["breakdown"] = {"device_ops": red.get("device_ops", []),
                            "idle_gaps": red.get("idle_gaps", [])}
    else:
        res["metrics"] = {n: {"value": out["metrics"][n], "unit": u}
                          for n, u in units.items()}
        res["device"] = dev
    res["host"] = ctx.host
    res["checks"] = out["checks"].items
    return res, out["checks"], out.get("notes", {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import card as cardmod
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    try:
        card = cardmod.require(int(cell["chips"]))
    except cardmod.NoCard as e:
        return int(e.code)
    print(f"card: {card['kind']} x {card['count']}, power limit "
          f"{card['power_limit_w']} W", file=sys.stderr)
    build_s = cardmod.build_program()
    print(f"build/load of kernels and native libraries: {build_s:.3f} s",
          file=sys.stderr)
    res, checks, notes = run_cell(spec, cell, args, "cuda", card)
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    print(json.dumps({"notes": notes}), file=sys.stderr)
    print(json.dumps(res), flush=True)
    checks.print_lines(sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
