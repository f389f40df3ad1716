"""The scrub cell: a node's own ScrubWorker over a store of seeded blocks.

Set-up starts the configuration's nodes in this process, writes the
mix's blocks to node 0 through the node's local write path (and good
copies of the blocks planted bad to node 1), references them as an
object table would, plants the bad bytes on node 0's disk, and starts
the scrub at tranquility 0, as ``worker set scrub-tranquility 0`` and
``repair scrub start`` do.  The window measures the bytes whose verdict
the worker reaches, starting a new pass as each one ends.  After the
window the scrub is paused and the node's store is judged against the
reference: every planted copy it reached set aside and healed from node
1, no good copy set aside, every stored file hashing to its name.
"""

from __future__ import annotations

import asyncio
import os
import time
from pathlib import Path
from typing import List, Tuple

from ..harness import data, profiling
from ..harness.checks import Checks
from ..reference import blocks as ref_blocks
from ..reference import scrub as ref_scrub

FULL = 65536  # the scrub walks two-byte hash prefixes 0 .. 65535


class PassTracker:
    """The prefix ranges a ScrubWorker has judged, pass by pass, read
    from its verified position."""

    def __init__(self, worker):
        """``worker`` has a pass under way."""
        self.w = worker
        self.passes: List[List[int]] = [[0, 0]]

    def poll(self) -> None:
        """Follows the worker; starts a new pass when one has ended."""
        w = self.w
        if w.iterator is None and self.passes[-1] != [0, 0]:
            self.passes[-1][1] = FULL
            self.passes.append([0, 0])
            w.send_command("start")
        elif w.iterator is not None:
            self.passes[-1][1] = max(self.passes[-1][1], w._verified_pos)

    def cursor(self) -> Tuple[int, int]:
        return len(self.passes) - 1, self.passes[-1][1]

    def between(self, a: Tuple[int, int], b: Tuple[int, int]) -> List[Tuple[int, int]]:
        (pa, xa), (pb, xb) = a, b
        if pa == pb:
            return [(xa, xb)]
        return [(xa, FULL)] + [(0, FULL)] * (pb - pa - 1) + [(0, xb)]

    def all_ranges(self) -> List[Tuple[int, int]]:
        return [(lo, hi) for lo, hi in self.passes if hi > lo]


def bytes_in(ranges, prefixes, sizes) -> int:
    return sum(s for p, s in zip(prefixes, sizes)
               for lo, hi in ranges if lo <= p < hi)


def flip_byte(path: str, frac: float) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        off = min(int(frac * f.tell()), f.tell() - 1)
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


async def bounded(coros, width: int = 16):
    sem = asyncio.Semaphore(width)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*[one(c) for c in coros])


async def wait_until(cond, timeout: float, dt: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(dt)
    return True


async def run(ctx) -> dict:
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.utils.data import Hash

    from ..harness import inproc

    t = ctx.traffic
    level = ctx.config["garage"].get("compression_level")
    nodes = await inproc.start(ctx.config, Path(ctx.tmp), ctx.device)
    try:
        m0, m1 = nodes[0].block_manager, nodes[1].block_manager
        # 1. the store, its digests by the reference, written through
        # node 0's local write path
        size = int(ctx.config["garage"]["block_size"])
        store = data.BlockStore(ctx.seed, int(ctx.config["store_bytes"]) // size,
                                size, t)
        digests = ref_blocks.digests(store.blocks)
        planted = set(store.planted)

        def block(i):
            raw = bytes(store.blocks[i])
            return (DataBlock.from_buffer(raw, level)
                    if i in store.compressible else DataBlock.plain(raw))

        await bounded([m0.write_block(Hash(digests[i]), block(i))
                       for i in range(len(store))])
        await bounded([m1.write_block(Hash(digests[i]), block(i))
                       for i in planted])
        m0.db.transaction(lambda tx: [m0.rc.block_incref(tx, Hash(d))
                                      for d in digests])
        m1.db.transaction(lambda tx: [m1.rc.block_incref(tx, Hash(digests[i]))
                                      for i in planted])
        for i, frac in store.planted.items():
            flip_byte(m0.find_block(Hash(digests[i]))[0], frac)
        if ctx.fault is not None:
            ctx.fault(nodes)
        await wait_until(lambda: m0.resync.queue_len() == 0
                         and m1.resync.queue_len() == 0, 60)

        # 2. warm-up: the scrub itself, until it has judged some blocks
        worker = nodes[0].scrub_worker
        worker.set_tranquility(0)
        worker.send_command("start")
        await wait_until(lambda: worker.iterator is not None, 30)
        track = PassTracker(worker)
        warm_until = time.perf_counter() + float(t["warmup_s"])
        while time.perf_counter() < warm_until:
            track.poll()
            await asyncio.sleep(0.02)

        # 3. the window
        feeder, obs = m0.feeder, m0.codec.obs
        before = (feeder.stats(), dict(obs.bytes_total))
        prof = (profiling.Window(os.path.join(ctx.tmp, "trace.json"))
                if ctx.trace else None)
        if prof:
            prof.start()
        track.poll()
        a, t_open = track.cursor(), time.perf_counter()
        setup_s = t_open - ctx.t_process
        while time.perf_counter() - t_open < ctx.seconds:
            await asyncio.sleep(0.02)
            track.poll()
        b, window_s = track.cursor(), time.perf_counter() - t_open
        if prof:
            prof.stop()
        after = (feeder.stats(), dict(obs.bytes_total))

        # 4. stop the scrub where it is
        worker.send_command("pause")
        await wait_until(lambda: worker.state.paused, 30)
        await asyncio.sleep(0.5)
        if worker.iterator is not None:
            track.passes[-1][1] = max(track.passes[-1][1], worker._verified_pos)
        memory = ctx.memory_peak()

        # 5. judge node 0 against the reference
        prefixes = [ref_scrub.prefix(d) for d in digests]
        window_bytes = bytes_in(track.between(a, b), prefixes, store.sizes)
        ranges = track.all_ranges()
        reached_bad = ref_scrub.covered([digests[i] for i in planted], ranges)
        root0 = str(Path(ctx.tmp) / "n0" / "data")

        def healed() -> bool:
            present, _q, _o = ref_blocks.walk_store(root0)
            return all(d.hex() in present
                       and not ref_blocks.bad_files(present[d.hex()])
                       for d in reached_bad)

        await wait_until(healed, 60, 0.5)
        present, quarantined, other = ref_blocks.walk_store(root0)
        bad_planted = {digests[i] for i in planted}
        unreached_bad = {d.hex() for d in bad_planted - reached_bad}
        files = [p for hx, ps in present.items() if hx not in unreached_bad
                 for p in ps]
        bad = ref_blocks.bad_files(files)
        healed_ok = {hx for hx in present} - {
            os.path.basename(p).partition(".")[0] for p in bad}
        counts = ref_scrub.judge(digests, bad_planted, ranges, present,
                                 quarantined, healed_ok)
        present1, _q1, _o1 = ref_blocks.walk_store(
            str(Path(ctx.tmp) / "n1" / "data"))
        bad1 = ref_blocks.bad_files(p for ps in present1.values() for p in ps)

        checks = Checks()
        checks.at_least("verdicts", counts["verdicts"], 1)
        checks.at_most("missed_corruptions", counts["missed_corruptions"], 0)
        checks.at_most("false_quarantines", counts["false_quarantines"], 0)
        checks.at_most("unhealed", counts["unhealed"], 0)
        checks.at_most("missing_blocks", counts["missing_blocks"], 0)
        checks.at_most("bad_files", len(bad) + len(bad1) + len(other), 0)

        out = {
            "attempted": counts["verdicts"],
            "failed": counts["missed_corruptions"] + counts["false_quarantines"],
            "metrics": {"scrub_gibs": window_bytes / window_s / 2**30,
                        "setup_s": setup_s},
            "checks": checks, "memory_peak_bytes": memory,
            "notes": {"passes": len(track.passes),
                      "planted_reached": counts["planted_reached"],
                      "window_blocks": window_bytes / 2**20},
            "obs": {"feeder": (before[0], after[0]),
                    "bytes_by_side": (before[1], after[1])},
        }
        if prof:
            red = profiling.reduce([prof.out_path])
            out["trace"] = red
            out["obs"]["trace"] = red
            out["obs"]["trace_bytes_by_side"] = out["obs"]["bytes_by_side"]
        return out
    finally:
        await inproc.stop(nodes)
